"""Force evaluation for larger bead counts: the attention-core ("clx") path.

Port of ``twoforone_tpu/ops/fused_score_clx.py``. The whole-evaluation
kernel of :mod:`twoforone_torch.ops.fused_score_cl` keeps one chain's
activations in a thread block's shared memory and is sized for small
proteins. This path splits the work instead:

- the N^2 geometric attention block of every layer runs as the CUDA kernel
  pair of :mod:`twoforone_torch.ops.attention_cl_core` (forward, and a
  hand-derived backward behind an ``autograd.Function``);
- projections, LayerNorm, gated residuals and the feed-forward stay eager
  PyTorch (``torch.matmul`` and elementwise ops), as the JAX package leaves
  them outside any Pallas kernel;
- conservative forces come from ``torch.autograd.grad`` of the summed energy
  with respect to the *centred* coordinates, with no projection afterwards.

The energy is the same function as the fused module's plain version
(``fused_score_cl._energy_cl``) with the attention block handed to the
kernel wrapper, and the weights are folded the same way
(:func:`~twoforone_torch.ops.fused_score_cl.augment_params_cl`). The plain
version of this path is therefore
:func:`~twoforone_torch.ops.fused_score_cl.fused_force_cl_reference`.

``CLX_MIN_CHAINS`` and ``CLX_MAX_N`` are the JAX package's gate, kept so that
the same inputs pick the same path in both packages; how the path compares
with the plain one on the card is measured by ``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from twoforone_torch.ops.attention_cl_core import cl_attention_core
from twoforone_torch.ops.fused_score_cl import VERIFIED_MAX_N, augment_params_cl, eps_hat_cl

CLX_MIN_CHAINS = 256
CLX_MAX_N = 32


def auto_fused_path(model, n_chains, device, other_edges: str = "plain") -> str:
    """The one gate behind ``fused="auto"`` (Langevin) and ``kernel="auto"``
    (sampling): ``"cl"``, ``"clx"`` or ``"plain"``.

    It is the JAX package's, so the same model and chain count pick the same
    path in both: with the production edge configuration on a CUDA device,
    ``"cl"`` up to ``VERIFIED_MAX_N`` beads, ``"clx"`` up to ``CLX_MAX_N``
    beads from ``CLX_MIN_CHAINS`` chains (``n_chains`` None counts as too
    few), else ``"plain"``. Off the card the answer is ``"plain"`` whatever
    the edge configuration: the kernels run nowhere else. On the card a model
    with another edge configuration gets ``other_edges``, the one point where
    the two callers differ (the Langevin path runs the plain network, the
    sampler names the fused kernel for every edge configuration).
    """
    if torch.device(device).type != "cuda":
        return "plain"
    if not model.is_production_edge_config:
        return other_edges
    if model.num_beads <= VERIFIED_MAX_N:
        return "cl"
    if model.num_beads <= CLX_MAX_N and n_chains is not None and n_chains >= CLX_MIN_CHAINS:
        return "clx"
    return "plain"


def make_clx_force_fn(model, params, t_norm=None, device="cuda"):
    """Build the clx score evaluation: ``x -> eps_hat`` for fixed ``t_norm``,
    or ``(x, t) -> eps_hat`` when ``t_norm`` is None (``t`` a float or a 0-d
    tensor on x's device).

    x: (B, N, 3) float32, any B. ``eps_hat = -dE/dx_c`` as ``score_forward``
    gives it. The function opens ``enable_grad`` itself, so it runs inside a
    ``no_grad`` step loop. The folded weights are exposed as ``.folded``.
    """
    folded = augment_params_cl(model, params, device)

    def eps_hat(x, t):
        return eps_hat_cl(x, t, folded, cl_attention_core)

    fn = eps_hat if t_norm is None else (lambda x: eps_hat(x, t_norm))
    fn.folded = folded
    return fn
