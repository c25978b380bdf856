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
  with respect to the *centred* coordinates, with no projection afterwards;
- on the card one whole evaluation (centring, energy, gradient: some 430
  small launches) is captured in a CUDA graph per input shape and replayed,
  so the host issues one launch where it issued hundreds
  (:class:`GraphedEvaluation`). The JAX package runs the same evaluation as
  one jitted XLA program.

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
from twoforone_torch.utils.cuda_graph import StepGraphs
from twoforone_torch.utils.device import float32_products

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


class GraphedEvaluation:
    """``(x, t) -> eager(x, t)`` on CUDA tensors, through one CUDA graph per
    input shape (:class:`~twoforone_torch.utils.cuda_graph.StepGraphs`).

    Each call copies x and t into the static buffers of its shape and runs
    the graph of that shape: the first call of a shape is the eager warm-up
    and the capture, later calls replay. ``graphs`` maps each captured
    (B, N) to its graph. The graphs share one memory pool (one evaluation's
    activations at the largest shape) until this object is dropped.
    """

    def __init__(self, eager, device):
        self.eager = eager
        self.steps = StepGraphs(device)
        self.graphs = self.steps.graphs

    def __call__(self, x, t):
        shape = tuple(x.shape)
        static_x = self.steps.buffer("x", shape)
        # Runtime t: a Python float would be captured as a constant, and every
        # replay would then use the first call's t. It lives in a 0-d device
        # tensor that each call fills before the replay.
        static_t = self.steps.buffer("t", ())
        static_x.copy_(x)
        if torch.is_tensor(t):
            static_t.copy_(t)
        else:
            static_t.fill_(float(t))
        out = self.steps(shape, lambda: self.eager(static_x, static_t))
        # The next replay overwrites the graph's output. The callers in this
        # package consume a force before they ask for the next one, but the
        # function is public, so it returns a copy (one (B, N, 3) copy, 240 KB
        # at 1000 chains of trp-cage) rather than a tensor that changes under
        # its holder.
        return out.clone()


def make_clx_force_fn(model, params, t_norm=None, device="cuda", graphed=True):
    """Build the clx score evaluation: ``x -> eps_hat`` for fixed ``t_norm``,
    or ``(x, t) -> eps_hat`` when ``t_norm`` is None (``t`` a float or a 0-d
    tensor on x's device).

    x: (B, N, 3) float32, any B. ``eps_hat = -dE/dx_c`` as ``score_forward``
    gives it. The function opens ``enable_grad`` itself, so it runs inside a
    ``no_grad`` step loop. On a CUDA device each input shape is captured in a
    CUDA graph at its first call and replayed after (:class:`GraphedEvaluation`,
    exposed as ``.graphed``); ``graphed=False`` keeps the eager evaluation,
    for comparing the two. On the CPU the evaluation is always eager. The
    folded weights are exposed as ``.folded``.
    """
    folded = augment_params_cl(model, params, device)

    def eps_hat(x, t):
        with float32_products():
            return eps_hat_cl(x, t, folded, cl_attention_core)

    graph = None
    if graphed and folded.flat.device.type == "cuda":
        graph = GraphedEvaluation(eps_hat, folded.flat.device)
    evaluate = graph or eps_hat

    if t_norm is None:
        def fn(x, t):
            return evaluate(x, t)
    else:
        def fn(x):
            return evaluate(x, t_norm)
    fn.folded = folded
    fn.graphed = graph
    return fn
