"""Diffusion-model configuration (port of ``GaussianDiffusion`` from
``twoforone_tpu/core/diffusion.py``).

Only the configuration object is ported so far: the score model, the bead
count, the schedule and its float32 buffers, and the data norm factor. The
losses and the samplers come with the i.i.d. sampling path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from twoforone_torch.core.schedules import DiffusionBuffers, make_buffers


@dataclass(frozen=True)
class GaussianDiffusion:
    """Bundles a score model with diffusion buffers and normalization.

    ``model`` is a :class:`twoforone_torch.models.graph_transformer.GraphTransformer`
    used as the architecture description; the weights that drive a run are
    passed to the entry points explicitly, as in the JAX package.
    """

    model: "GraphTransformer"  # noqa: F821
    num_atoms: int
    timesteps: int = 1000
    beta_schedule: str = "cosine"
    norm_factor: float = 1.0
    loss_weights: str = "ones"
    buffers: DiffusionBuffers = field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(
            self,
            "buffers",
            make_buffers(self.timesteps, self.beta_schedule, self.loss_weights),
        )
