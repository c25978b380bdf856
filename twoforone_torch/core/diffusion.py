"""DDPM over coarse-grained coordinates (port of ``core/diffusion.py``).

The stateless math (forward process, posteriors, losses), the three reverse
chains (ancestral, DDIM, DPM-Solver++(2M)) and the :class:`GaussianDiffusion`
configuration object with its sampling entry points. The numerical contract
is the JAX package's: zero centre of mass for data, noise, model output and
every sampling step; the clamp to +-1000 inside the sampling loops; the
``clip_x0`` guard of the strided samplers; timestep importance sampling from
the loss-weight multinomial.

What differs from the JAX module:

- a reverse chain is a Python loop under ``torch.no_grad()`` (the score
  function opens ``enable_grad`` itself where it differentiates an energy);
  on the card the sampling closures of the plain network replay each step
  from a CUDA graph instead, the counterpart of the JAX package's jitted
  ``lax.scan``;
- random numbers come from an explicit ``torch.Generator`` on the run's
  device, or from a noise hook ``noise(tag, shape)`` with ``tag = "init"``
  for the starting state and the integer timestep for each step, so that a
  test can hand a loop the numbers another implementation drew;
- the one-step functions take the step's noise tensor where the JAX ones
  take a key;
- all coefficient arithmetic stays in float32 tensors read from the buffers,
  so a chain follows the JAX chain step for step;
- with a ``mesh`` (:mod:`twoforone_torch.parallel.mesh`) the reverse loops
  take the global shape, draw every step's noise for the whole batch and
  keep the rank's rows, so a sharded chain equals the unsharded one (the
  JAX package gets this from partitionable ``jax.random``); they return the
  rank's rows, and the sampling closures gather them.

``bf16`` (``score_fn``, ``sample``, ``make_sample_fn``) runs the plain
network in bfloat16 on its float32 weights (``GraphTransformer.with_dtype``);
the chain state, the buffers and the coefficient arithmetic stay float32. The
fused paths take no ``bf16``, as in the JAX package: their kernels compute in
float32. ``make_sample_fn`` binds the weights once where the JAX one jits.
``init_params`` is :func:`twoforone_torch.models.graph_transformer.init_params`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from twoforone_torch.core.schedules import DiffusionBuffers, extract, make_buffers
from twoforone_torch.ops.geometry import center_zero
from twoforone_torch.parallel.mesh import entry_device, gather, local_rows, mesh_size
from twoforone_torch.utils.cuda_graph import graphs_for
from twoforone_torch.utils.device import resolve_device

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x, t_norm) -> eps_hat


# ---------------------------------------------------------------------------
# Stateless math
# ---------------------------------------------------------------------------

def q_sample(buf: DiffusionBuffers, x_start, t, noise):
    """Forward-process sample x_t | x_0."""
    noise = center_zero(noise)
    return (
        extract(buf.sqrt_alphas_cumprod, t) * x_start
        + extract(buf.sqrt_one_minus_alphas_cumprod, t) * noise
    )


def predict_start_from_noise(buf: DiffusionBuffers, x_t, t, noise):
    """Invert q_sample for x_0."""
    return (
        extract(buf.sqrt_recip_alphas_cumprod, t) * x_t
        - extract(buf.sqrt_recipm1_alphas_cumprod, t) * noise
    )


def q_posterior(buf: DiffusionBuffers, x_start, x_t, t):
    """Posterior q(x_{t-1} | x_t, x_0): (mean, variance, clipped log variance)."""
    mean = (
        extract(buf.posterior_mean_coef1, t) * x_start
        + extract(buf.posterior_mean_coef2, t) * x_t
    )
    var = extract(buf.posterior_variance, t)
    log_var = extract(buf.posterior_log_variance_clipped, t)
    return mean, var, log_var


def q_mean_variance(buf: DiffusionBuffers, x_start, t):
    """Marginal q(x_t | x_0): (mean, variance, log variance)."""
    mean = extract(buf.sqrt_alphas_cumprod, t) * x_start
    variance = extract(1.0 - buf.alphas_cumprod, t)
    log_variance = extract(buf.log_one_minus_alphas_cumprod, t)
    return mean, variance, log_variance


def normal_kl_at_T(buf: DiffusionBuffers, x_start):
    """max over the batch of KL(q(x_T | x_0) || N(0, I)), as a 0-d tensor;
    callers assert ``<= 1e-4``. ``x_start`` must be centred and normalized."""
    b = x_start.shape[0]
    t = torch.full((b,), buf.num_timesteps - 1, dtype=torch.long, device=x_start.device)
    mean1, _, logvar1 = q_mean_variance(buf, x_start, t)
    logvar1 = logvar1[:, 0, 0]
    meandifsq = torch.sum(mean1**2, dim=(-2, -1))
    kl = 0.5 * (-1.0 - logvar1 + torch.exp(logvar1) + meandifsq)
    return kl.abs().max()


def _t_norm(buf, t):
    return t.to(torch.float32) / buf.num_timesteps


def _model_output(buf, score_fn, x, t, t_scalar=None):
    """Centred model output at the timestep tensor ``t``.

    ``t_scalar`` is that timestep as a Python int, given by a loop that puts
    every chain at the same one. A score function that declares ``scalar_t``
    (the fused kernels take one t per call) is then handed ``t_scalar / T``
    as a host float32 instead of the tensor, so it never reads t back from
    the device."""
    if t_scalar is not None and getattr(score_fn, "scalar_t", False):
        t_norm = float(np.float32(t_scalar) / np.float32(buf.num_timesteps))
    else:
        t_norm = _t_norm(buf, t)
    return center_zero(score_fn(x, t_norm))


def p_mean_variance(buf: DiffusionBuffers, score_fn: ScoreFn, x, t, objective="pred_noise",
                    t_scalar: Optional[int] = None):
    """Model posterior estimate (``t_scalar``: see :func:`_model_output`)."""
    model_output = _model_output(buf, score_fn, x, t, t_scalar)
    if objective == "pred_noise":
        x_start = center_zero(predict_start_from_noise(buf, x, t, model_output))
    elif objective == "pred_x0":
        x_start = model_output
    else:
        raise ValueError(f"unknown objective {objective}")
    return q_posterior(buf, x_start, x, t)


def p_sample(buf: DiffusionBuffers, score_fn: ScoreFn, x, t, noise, objective="pred_noise",
             t_scalar: Optional[int] = None):
    """One ancestral reverse step; ``noise`` is the step's standard-normal
    draw, shaped like ``x`` (centred here)."""
    model_mean, _, model_log_var = p_mean_variance(buf, score_fn, x, t, objective, t_scalar)
    noise = center_zero(noise)
    nonzero = (t != 0).to(x.dtype)[:, None, None]
    return model_mean + nonzero * torch.exp(0.5 * model_log_var) * noise


def _chain_start(buf, shape, generator, noise, device, mesh=None):
    """Shared set-up of the reverse chains: the buffers on the device, the
    draw function ``(tag, shape) -> noise`` (under a mesh: the rank's rows
    of the whole batch's draw) and the centred starting state."""
    device = resolve_device(device)
    if noise is not None:
        def draw_all(tag, shape):
            return torch.as_tensor(noise(tag, shape), dtype=torch.float32, device=device)
    elif generator is not None:
        def draw_all(tag, shape):
            return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    else:
        raise ValueError("a reverse chain needs a torch.Generator or a noise hook")
    if mesh_size(mesh) == 1:
        draw = draw_all
    else:
        rows = local_rows(shape[0], mesh)

        def draw(tag, shape):
            return draw_all(tag, shape)[rows]
    return buf.to(device), draw, center_zero(draw("init", tuple(shape)))


@torch.no_grad()
def p_sample_loop(buf: DiffusionBuffers, score_fn: ScoreFn, shape, generator=None,
                  objective: str = "pred_noise", noise=None, device="cuda", mesh=None):
    """Full ancestral reverse chain, T score evaluations. The blow-up guard
    (clamp to +-1000) is applied after every step. ``mesh``: see the module
    docstring (``shape[0]`` must be a multiple of its size)."""
    buf, draw, mol = _chain_start(buf, shape, generator, noise, device, mesh)
    for t_scalar in range(buf.num_timesteps - 1, -1, -1):
        t = torch.full((mol.shape[0],), t_scalar, dtype=torch.long, device=mol.device)
        mol = p_sample(buf, score_fn, mol, t, draw(t_scalar, tuple(shape)), objective,
                       t_scalar)
        mol = center_zero(mol.clamp(-1000.0, 1000.0))
    return mol


def ddim_timestep_ladder(num_timesteps: int, sample_steps: int):
    """Evenly spaced descending timestep subset for strided sampling:
    ``sample_steps`` indices over [0, T-1], both endpoints included.
    Returns numpy int64 ``(taus, prev_taus)`` where ``prev_taus[i]`` is the
    ladder step after ``taus[i]`` (``prev_taus[-1] = -1`` signals the final
    hop to x_0)."""
    if not 1 <= sample_steps <= num_timesteps:
        raise ValueError(f"sample_steps={sample_steps} must be in [1, {num_timesteps}]")
    # linspace from the top so sample_steps=1 yields [T-1] (one hop to x0)
    taus = np.unique(
        np.round(np.linspace(num_timesteps - 1, 0, sample_steps)).astype(np.int64)
    )[::-1]
    prev = np.concatenate([taus[1:], [-1]])
    return taus.copy(), prev


def _x0_eps(buf, score_fn, x, t, objective, clip_x0, t_scalar=None):
    """Clip-denoised x0 estimate at timestep tensor ``t`` and the eps
    consistent with it and the current state."""
    model_output = _model_output(buf, score_fn, x, t, t_scalar)
    abar_t = extract(buf.alphas_cumprod, t)
    if objective == "pred_noise":
        eps = model_output
        x0 = center_zero(predict_start_from_noise(buf, x, t, eps))
    elif objective == "pred_x0":
        x0 = model_output
        eps = (x - torch.sqrt(abar_t) * x0) / torch.sqrt(1.0 - abar_t)
    else:
        raise ValueError(f"unknown objective {objective}")
    if clip_x0 is not None:
        # At the top of the cosine schedule 1/sqrt(abar_t) is ~2e4 and
        # amplifies any score error into x0; clamp, then recompute eps so
        # that (x0, eps) stay consistent with x (a no-op when not engaged).
        x0 = center_zero(x0.clamp(-clip_x0, clip_x0))
        eps = (x - torch.sqrt(abar_t) * x0) / torch.sqrt(1.0 - abar_t)
    return x0, eps, abar_t


def ddim_step(buf: DiffusionBuffers, score_fn: ScoreFn, x, tau: int, tau_prev: int, noise,
              eta: float = 0.0, objective: str = "pred_noise",
              clip_x0: Optional[float] = 10.0):
    """One DDIM update x_tau -> x_tau_prev (Song et al. 2020, eq. 12).

    ``tau`` and ``tau_prev`` are Python ints; ``tau_prev < 0`` is the final
    hop, straight to x_0 with no noise. ``noise`` is the step's
    standard-normal draw. With a full ladder, ``eta=1`` and ``clip_x0=None``
    this is the ancestral :func:`p_sample` step; ``eta=0`` is deterministic.
    """
    b = x.shape[0]
    t = torch.full((b,), int(tau), dtype=torch.long, device=x.device)
    t_prev = None if tau_prev < 0 else torch.full_like(t, int(tau_prev))
    return _ddim_update(buf, score_fn, x, t, t_prev, noise, eta, objective, clip_x0, int(tau))


def _ddim_update(buf, score_fn, x, t, t_prev, noise, eta, objective, clip_x0, t_scalar=None):
    """:func:`ddim_step` at the timestep tensors ``t`` and ``t_prev`` ((B,)
    long; ``t_prev`` None is the final hop)."""
    x0, eps, abar_t = _x0_eps(buf, score_fn, x, t, objective, clip_x0, t_scalar)
    last = t_prev is None
    if last:
        abar_prev = torch.ones_like(abar_t)
    else:
        abar_prev = extract(buf.alphas_cumprod, t_prev)
    sigma = eta * torch.sqrt(
        ((1.0 - abar_prev) / (1.0 - abar_t)).clamp(min=0.0)
        * (1.0 - abar_t / abar_prev).clamp(min=0.0)
    )
    dir_coef = torch.sqrt((1.0 - abar_prev - sigma**2).clamp(min=0.0))
    out = torch.sqrt(abar_prev) * x0 + dir_coef * eps
    if not last:
        out = out + sigma * center_zero(noise)
    return out


@torch.no_grad()
def ddim_sample_loop(buf: DiffusionBuffers, score_fn: ScoreFn, shape, generator=None,
                     sample_steps: int = 100, eta: float = 0.0,
                     objective: str = "pred_noise", clip_x0: Optional[float] = 10.0,
                     noise=None, device="cuda", mesh=None):
    """Strided reverse chain: ``sample_steps`` score evaluations instead of
    T. Clamp, centring, the per-step noise tags and ``mesh`` follow
    :func:`p_sample_loop`."""
    buf, draw, mol = _chain_start(buf, shape, generator, noise, device, mesh)
    taus, prev_taus = ddim_timestep_ladder(buf.num_timesteps, sample_steps)
    for tau, tau_prev in zip(taus.tolist(), prev_taus.tolist()):
        mol = ddim_step(buf, score_fn, mol, tau, tau_prev, draw(tau, tuple(shape)), eta,
                        objective, clip_x0)
        mol = center_zero(mol.clamp(-1000.0, 1000.0))
    return mol


@torch.no_grad()
def dpm_solver_pp_2m_loop(buf: DiffusionBuffers, score_fn: ScoreFn, shape, generator=None,
                          sample_steps: int = 100, objective: str = "pred_noise",
                          clip_x0: Optional[float] = 10.0, noise=None, device="cuda",
                          mesh=None):
    """DPM-Solver++(2M): second-order multistep ODE sampler (Lu et al. 2022,
    data-prediction form). One score evaluation per step like DDIM; each
    update extrapolates the x0 prediction linearly in log-SNR from the
    previous evaluation. The first step and the final hop (``tau_prev < 0``:
    abar -> 1, sigma -> 0, lambda -> +inf) are first order, and the final
    update is exactly ``x = x0_hat``. Deterministic after the initial draw.
    ``mesh`` as in :func:`p_sample_loop`.
    """
    buf, _, mol = _chain_start(buf, shape, generator, noise, device, mesh)
    taus, prev_taus = ddim_timestep_ladder(buf.num_timesteps, sample_steps)
    b = mol.shape[0]
    x0_prev = lam_prev = None
    for tau, tau_prev in zip(taus.tolist(), prev_taus.tolist()):
        t = torch.full((b,), tau, dtype=torch.long, device=mol.device)
        abar_t = None if tau_prev < 0 else buf.alphas_cumprod[tau_prev]
        mol, x0_prev, lam_prev = _dpm2m_update(buf, score_fn, mol, t, buf.alphas_cumprod[tau],
                                               abar_t, x0_prev, lam_prev, objective, clip_x0,
                                               tau)
        mol = center_zero(mol.clamp(-1000.0, 1000.0))
    return mol


def _log_snr_half(abar):  # lambda = log(alpha/sigma) = 0.5 log(abar/(1-abar))
    return 0.5 * (torch.log(abar) - torch.log1p(-abar))


def _dpm2m_update(buf, score_fn, x, t, abar_s, abar_t, x0_prev, lam_prev, objective, clip_x0,
                  t_scalar=None):
    """One DPM-Solver++(2M) update at the timestep tensor ``t`` from
    ``abar_s`` to ``abar_t`` (0-d; None is the final hop), before the clamp:
    returns (x, the x0 estimate, lambda_s) for the next step, whose first
    order update has ``x0_prev`` None."""
    x0_s, _, _ = _x0_eps(buf, score_fn, x, t, objective, clip_x0, t_scalar)
    lam_s = _log_snr_half(abar_s)
    sigma_s = torch.sqrt(1.0 - abar_s)
    if abar_t is None:
        return x0_s, x0_s, lam_s
    alpha_t = torch.sqrt(abar_t)
    sigma_t = torch.sqrt(1.0 - abar_t)
    h = _log_snr_half(abar_t) - lam_s
    # exp(-h) = (alpha_s * sigma_t) / (sigma_s * alpha_t)
    exp_neg_h = torch.sqrt(abar_s) * sigma_t / (sigma_s * alpha_t)
    if x0_prev is None:
        d = x0_s
    else:
        coef = 1.0 / (2.0 * ((lam_s - lam_prev) / h))
        d = (1.0 + coef) * x0_s - coef * x0_prev
    return (sigma_t / sigma_s) * x - alpha_t * (exp_neg_h - 1.0) * d, x0_s, lam_s


# ---------------------------------------------------------------------------
# Reverse chains replayed from CUDA graphs
# ---------------------------------------------------------------------------
# The counterparts of the JAX package's jitted ``lax.scan`` chains for the
# plain network on the card. One reverse step is captured with its timesteps
# in 0-d device scalars, so one graph serves every step of a chain and of the
# later calls of its sampling closure (the final hop of the strided chains,
# and the first DPM-Solver++(2M) update, have graphs of their own). The draws
# stay outside the graph, made by the chain's draw function into a static
# buffer before each replay, so the generator, the noise hook and a mesh's
# rows are the eager loop's, and so are the bits.

def _chain_buffers(graphs, mol):
    """The static state of a graphed chain: x (set to ``mol``), the step's
    noise and its timestep."""
    x = graphs.buffer("x", mol.shape).copy_(mol)
    return x, graphs.buffer("noise", mol.shape), graphs.buffer("t", (), torch.long)


def _at(values, t):
    """``values[t]`` for a 0-d long device tensor ``t``, as a 0-d tensor,
    without reading ``t`` back to the host."""
    return values.index_select(0, t.view(1)).view(())


@torch.no_grad()
def _p_sample_loop_graphed(graphs, buf, score_fn, shape, generator=None,
                           objective: str = "pred_noise", noise=None, device="cuda", mesh=None):
    """:func:`p_sample_loop` with each step replayed from ``graphs`` (a
    :class:`~twoforone_torch.utils.cuda_graph.StepGraphs`)."""
    buf, draw, mol = _chain_start(buf, shape, generator, noise, device, mesh)
    x, z, t = _chain_buffers(graphs, mol)
    b = x.shape[0]

    def step():
        out = p_sample(buf, score_fn, x, t.expand(b).contiguous(), z, objective)
        x.copy_(center_zero(out.clamp(-1000.0, 1000.0)))

    for t_scalar in range(buf.num_timesteps - 1, -1, -1):
        z.copy_(draw(t_scalar, tuple(shape)))
        t.fill_(t_scalar)
        graphs(("ancestral", x.shape), step)
    return x.clone()


@torch.no_grad()
def _ddim_sample_loop_graphed(graphs, buf, score_fn, shape, generator=None,
                              sample_steps: int = 100, eta: float = 0.0,
                              objective: str = "pred_noise", clip_x0: Optional[float] = 10.0,
                              noise=None, device="cuda", mesh=None):
    """:func:`ddim_sample_loop` with each step replayed from ``graphs``."""
    buf, draw, mol = _chain_start(buf, shape, generator, noise, device, mesh)
    x, z, t = _chain_buffers(graphs, mol)
    t_prev = graphs.buffer("t_prev", (), torch.long)
    b = x.shape[0]

    def step(last):
        def run():
            tp = None if last else t_prev.expand(b).contiguous()
            out = _ddim_update(buf, score_fn, x, t.expand(b).contiguous(), tp, z, eta,
                               objective, clip_x0)
            x.copy_(center_zero(out.clamp(-1000.0, 1000.0)))
        return run

    taus, prev_taus = ddim_timestep_ladder(buf.num_timesteps, sample_steps)
    for tau, tau_prev in zip(taus.tolist(), prev_taus.tolist()):
        z.copy_(draw(tau, tuple(shape)))
        t.fill_(tau)
        t_prev.fill_(max(tau_prev, 0))
        graphs(("ddim", tau_prev < 0, x.shape), step(tau_prev < 0))
    return x.clone()


@torch.no_grad()
def _dpm_solver_pp_2m_loop_graphed(graphs, buf, score_fn, shape, generator=None,
                                   sample_steps: int = 100, objective: str = "pred_noise",
                                   clip_x0: Optional[float] = 10.0, noise=None, device="cuda",
                                   mesh=None):
    """:func:`dpm_solver_pp_2m_loop` with each step replayed from ``graphs``;
    the previous x0 estimate and lambda live in static buffers too."""
    buf, _, mol = _chain_start(buf, shape, generator, noise, device, mesh)
    x, _, t = _chain_buffers(graphs, mol)
    t_prev = graphs.buffer("t_prev", (), torch.long)
    x0_prev, lam_prev = graphs.buffer("x0_prev", x.shape), graphs.buffer("lam_prev", ())
    b = x.shape[0]

    def step(first, last):
        def run():
            abar_t = None if last else _at(buf.alphas_cumprod, t_prev)
            out, x0_s, lam_s = _dpm2m_update(
                buf, score_fn, x, t.expand(b).contiguous(), _at(buf.alphas_cumprod, t), abar_t,
                None if first else x0_prev, lam_prev, objective, clip_x0)
            x.copy_(center_zero(out.clamp(-1000.0, 1000.0)))
            x0_prev.copy_(x0_s)
            lam_prev.copy_(lam_s)
        return run

    taus, prev_taus = ddim_timestep_ladder(buf.num_timesteps, sample_steps)
    for i, (tau, tau_prev) in enumerate(zip(taus.tolist(), prev_taus.tolist())):
        t.fill_(tau)
        t_prev.fill_(max(tau_prev, 0))
        graphs(("dpm2m", i == 0, tau_prev < 0, x.shape), step(i == 0, tau_prev < 0))
    return x.clone()


def p_losses(buf: DiffusionBuffers, score_fn: ScoreFn, x_start, t, noise,
             objective: str = "pred_noise", loss_type: str = "l2"):
    """Denoising loss at timesteps ``t`` with the standard-normal draw
    ``noise`` (centred here)."""
    noise = center_zero(noise)
    x = center_zero(q_sample(buf, x_start, t, noise))
    model_out = center_zero(score_fn(x, _t_norm(buf, t)))
    target = noise if objective == "pred_noise" else x_start
    if loss_type == "l2":
        loss = (model_out - target) ** 2
    elif loss_type == "l1":
        loss = (model_out - target).abs()
    else:
        raise ValueError(f"invalid loss type {loss_type}")
    return loss.mean()


def sample_timesteps(buf: DiffusionBuffers, generator, batch: int, t_range=None,
                     device="cuda"):
    """t ~ multinomial(loss_weights): importance sampling of timesteps.
    ``t_range=(lo, hi)`` restricts the support to ``lo <= t < hi``."""
    device = resolve_device(device)
    weights = buf.loss_weights.to(device)
    if t_range is not None:
        lo, hi = t_range
        t_idx = torch.arange(buf.num_timesteps, device=device)
        weights = torch.where((t_idx >= lo) & (t_idx < hi), weights, torch.zeros_like(weights))
    return torch.multinomial(weights, batch, replacement=True, generator=generator)


# ---------------------------------------------------------------------------
# Configuration object and entry points
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GaussianDiffusion:
    """Bundles a score model with diffusion buffers and normalization.

    ``model`` is a :class:`twoforone_torch.models.graph_transformer.GraphTransformer`
    used as the architecture description; the weights that drive a run are
    passed to the entry points explicitly (the flax parameter tree as nested
    dicts of numpy arrays), as in the JAX package.
    """

    model: "GraphTransformer"  # noqa: F821
    num_atoms: int
    timesteps: int = 1000
    beta_schedule: str = "cosine"
    norm_factor: float = 1.0
    loss_weights: str = "ones"
    objective: str = "pred_noise"
    loss_type: str = "l2"
    # Restrict training-loss timesteps to lo <= t < hi. None = full chain.
    t_diff_interval: Optional[tuple] = None
    buffers: DiffusionBuffers = field(init=False, repr=False)

    def __post_init__(self):
        if self.t_diff_interval is not None:
            lo, hi = self.t_diff_interval
            if not (0 <= lo < hi <= self.timesteps):
                raise ValueError(
                    f"t_diff_interval={self.t_diff_interval} must satisfy "
                    f"0 <= lo < hi <= timesteps={self.timesteps}"
                )
            object.__setattr__(self, "t_diff_interval", (int(lo), int(hi)))
        object.__setattr__(
            self,
            "buffers",
            make_buffers(self.timesteps, self.beta_schedule, self.loss_weights),
        )

    def buffers_on(self, device) -> DiffusionBuffers:
        """The buffers on ``device``, moved there once: a training step reads
        them at every call."""
        cache = self.__dict__.setdefault("_buffers_on", {})
        device = torch.device(device)
        if device not in cache:
            cache[device] = self.buffers.to(device)
        return cache[device]

    # -- model plumbing ------------------------------------------------------
    def score_fn(self, params, device="cuda", bf16: bool = False) -> ScoreFn:
        """Score closure ``(x, t_norm) -> eps_hat`` of the plain network with
        ``params`` loaded, on ``device``. ``bf16`` computes the network in
        bfloat16 (its weights stay float32; a model built in bfloat16 stays
        so either way, as in the JAX package)."""
        from twoforone_torch.models.graph_transformer import make_score_fn

        model = self.model.with_dtype(torch.bfloat16) if bf16 else self.model
        return make_score_fn(model, params, device)

    def init_params(self, seed: int) -> dict:
        """Random weights for the model as a flax parameter tree (numpy
        arrays), from numpy's generator seeded with ``seed``: the keys and
        shapes of the JAX method's, not its bits."""
        from twoforone_torch.models.graph_transformer import init_params

        return init_params(self.model, seed)

    # -- training loss -------------------------------------------------------
    def loss(self, params, mol, generator, device="cuda"):
        """Training loss on raw (un-normalized) coordinates: centre and
        scale, draw t from the loss-weight multinomial and the noise from
        ``generator``; returns ``(loss, {"kl_at_T": kl})``. The value only,
        for weights given as the flax parameter tree; :meth:`net_loss` is
        the differentiable form on a live module."""
        device = resolve_device(device)
        return self._loss(self.score_fn(params, device), mol, generator, None, None, device)

    def net_loss(self, net, mol, generator=None, t=None, noise=None,
                 create_graph: bool = True):
        """The training loss of :meth:`loss` on the module ``net`` (a
        GraphTransformer shaped like ``self.model``), on ``net``'s device,
        differentiable with respect to its parameters: in conservative mode
        the force -dE/dx keeps its graph (``create_graph``; False gives the
        value only, as an evaluation needs).

        ``t`` (B,) and ``noise`` (B, N, 3) may be given, as another
        implementation drew them; what is not given is drawn from
        ``generator``, t first. Returns ``(loss, {"kl_at_T": kl})``."""
        from twoforone_torch.models.graph_transformer import score_forward

        def score_fn(x, t_norm):
            return score_forward(net, x, t_norm, create_graph=create_graph)

        device = next(net.parameters()).device
        return self._loss(score_fn, mol, generator, t, noise, device)

    def _loss(self, score_fn, mol, generator, t, noise, device):
        mol = center_zero(torch.as_tensor(mol, dtype=torch.float32, device=device))
        mol = mol / self.norm_factor
        b, n, d = mol.shape
        if n != self.num_atoms or d != 3:
            raise ValueError(f"Molecule shape must be {(self.num_atoms, 3)}")
        buf = self.buffers_on(device)
        if t is None:
            t = sample_timesteps(buf, generator, b, self.t_diff_interval, device)
        if noise is None:
            noise = torch.randn(mol.shape, generator=generator, dtype=torch.float32,
                                device=device)
        t = torch.as_tensor(t, dtype=torch.long, device=device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
        kl = normal_kl_at_T(buf, mol)
        loss = p_losses(buf, score_fn, mol, t, noise, self.objective, self.loss_type)
        return loss, {"kl_at_T": kl}

    # -- sampling ------------------------------------------------------------
    def _sample_loop_fn(self, sample_steps: Optional[int], eta: float, solver: str = "ddim",
                        graphed: bool = False):
        """Reverse-chain loop selector: the full ancestral chain by default,
        a strided chain when ``sample_steps`` is given. ``solver``: "ddim" or
        "dpm2m" (deterministic; ``eta`` does not apply). ``graphed`` gives the
        loop's graphed form, which takes a ``StepGraphs`` first."""
        if sample_steps is None:
            return _p_sample_loop_graphed if graphed else p_sample_loop
        if solver == "ddim":
            return partial(_ddim_sample_loop_graphed if graphed else ddim_sample_loop,
                           sample_steps=sample_steps, eta=eta)
        if solver == "dpm2m":
            return partial(_dpm_solver_pp_2m_loop_graphed if graphed else dpm_solver_pp_2m_loop,
                           sample_steps=sample_steps)
        raise ValueError(f"unknown solver {solver!r} (ddim | dpm2m)")

    def reverse_chain(self, graphs, score_fn: ScoreFn, shape, generator=None,
                      sample_steps: Optional[int] = None, eta: float = 0.0,
                      solver: str = "ddim", noise=None, device="cuda", mesh=None):
        """One reverse chain of ``score_fn`` in normalised units, the loop
        :meth:`_sample_loop_fn` selects: each step replayed from ``graphs``
        (a :class:`~twoforone_torch.utils.cuda_graph.StepGraphs`), or the
        eager loop where ``graphs`` is None."""
        loop = self._sample_loop_fn(sample_steps, eta, solver, graphed=graphs is not None)
        if graphs is not None:
            loop = partial(loop, graphs)
        return loop(self.buffers_on(device), score_fn, shape, generator,
                    objective=self.objective, noise=noise, device=device, mesh=mesh)

    def sample(self, params, batch_size: int, generator=None,
               sample_steps: Optional[int] = None, eta: float = 0.0, solver: str = "ddim",
               noise=None, device="cuda", mesh=None, bf16: bool = False):
        """Draw i.i.d. samples in data units through the plain network:
        (batch, N, 3) on ``device``. ``generator`` must live on that device.
        ``mesh``: each rank computes its rows of the batch and every rank
        gets all of it, equal to the unsharded samples. ``bf16`` runs the
        network in bfloat16 (the chain state stays float32). One call is
        eager on the card too: a CUDA graph pays off over the steps of a
        reusable closure (:meth:`make_sample_fn`)."""
        return self._sampler(params, batch_size, "xla", sample_steps, eta, solver, device,
                             mesh, bf16, graphed=False)(generator, noise=noise)

    def make_sample_fn(self, params, batch_size: int, sample_steps: Optional[int] = None,
                       eta: float = 0.0, solver: str = "ddim", bf16: bool = False,
                       device="cuda", mesh=None):
        """Sampling closure of the plain network with the weights bound once:
        ``sample(generator=None, noise=None) -> (batch, N, 3)``, as
        :meth:`sample` draws them (``bf16`` likewise). On the card each
        reverse step is replayed from a CUDA graph, captured at the closure's
        first call (see :meth:`make_fused_sample_fn`)."""
        return self._sampler(params, batch_size, "xla", sample_steps, eta, solver, device,
                             mesh, bf16)

    def resolve_sample_kernel(self, kernel: str, batch_size: int, device) -> str:
        """Resolve ``kernel="auto"`` to ``"cl"``, ``"clx"``, ``"xla"`` or
        ``"packed"`` by the gate ``LangevinDiffusion`` uses
        (:func:`twoforone_torch.ops.fused_score_clx.auto_fused_path`; off the
        card that is ``"xla"``); explicit values pass through untouched."""
        if kernel != "auto":
            return kernel
        from twoforone_torch.ops.fused_score_clx import auto_fused_path

        path = auto_fused_path(self.model, batch_size, device, other_edges="packed")
        return "xla" if path == "plain" else path

    def make_fused_sample_fn(self, params, batch_size: int, kernel: str = "auto",
                             sample_steps: Optional[int] = None, eta: float = 0.0,
                             solver: str = "ddim", device="cuda", mesh=None):
        """Sampling closure with the weights bound once:
        ``sample(generator=None, noise=None) -> (batch, N, 3)`` in data units.

        ``kernel``: "cl" = the fused force kernel (small proteins), "clx" =
        the attention-core kernel pair inside an eager energy, "xla" = the
        plain network (the JAX package's name for its plain path, kept so the
        same arguments work in both), "auto" = :meth:`resolve_sample_kernel`:
        on the card "cl" up to ``VERIFIED_MAX_N`` beads, "clx" up to
        ``CLX_MAX_N`` beads from ``CLX_MIN_CHAINS`` samples, else "xla";
        "packed" = the fused force kernel for every edge configuration
        (:mod:`twoforone_torch.ops.fused_score`; the JAX package's name for
        its head-packed kernel), which is also what "auto" gives a model
        with another edge configuration than the production one on the
        card. The resolved name is ``sample.kernel``, the score function the
        chain calls ``sample.score_fn``.

        The fused paths take one scalar t per score call (every chain of a
        batch is at the same timestep).

        ``mesh``: each rank samples ``batch_size / size`` (the gate of
        "auto" sees that count) and the result is gathered on every rank.
        The plain network draws the whole batch's noise and keeps the
        rank's rows, so its samples do not depend on the mesh; the fused
        paths draw only their own rows from a generator seeded from the
        caller's and the rank, as the JAX package folds the device index
        into the key. Their samples are i.i.d. either way.

        On the card "xla" replays each reverse step from a CUDA graph that
        the closure captures at its first call and keeps (one memory pool
        for its step variants), as the JAX package jits the chain; it gives
        the eager loop's samples bit for bit. The fused paths stay eager:
        their kernel is most of a step, and "clx" graphs its evaluation.
        """
        return self._sampler(params, batch_size, kernel, sample_steps, eta, solver, device,
                             mesh, bf16=False)

    def _sampler(self, params, batch_size, kernel, sample_steps, eta, solver, device, mesh,
                 bf16, graphed=True):
        device = entry_device(device, mesh)
        m = self.model
        n_ranks = mesh_size(mesh)
        local_rows(batch_size, mesh)  # batch_size must divide over the mesh
        kernel = self.resolve_sample_kernel(kernel, batch_size // n_ranks, device)

        def one_t(t_norm):  # a host float from the loops, else the batch's vector
            return t_norm if isinstance(t_norm, float) else t_norm[0]

        if kernel == "xla":
            score_fn = self.score_fn(params, device, bf16=bf16)
        elif kernel == "clx":
            from twoforone_torch.ops.fused_score_clx import make_clx_force_fn

            clx = make_clx_force_fn(m, params, None, device)

            def score_fn(x, t_norm):
                return clx(x, one_t(t_norm))
        elif kernel == "cl":
            from twoforone_torch.ops.fused_score_cl import augment_params_cl, fused_force_cl

            folded = augment_params_cl(m, params, device)

            def score_fn(x, t_norm):
                return fused_force_cl(x, float(one_t(t_norm)), folded)
        elif kernel == "packed":
            from twoforone_torch.ops.fused_score import make_fused_force_kernel

            packed = make_fused_force_kernel(m, params, None, device)

            def score_fn(x, t_norm):
                return packed(x, one_t(t_norm))
        else:
            raise ValueError(f"unknown kernel {kernel!r} (auto | cl | clx | xla | packed)")

        # The fused paths take one t per call: the loops hand it over as a
        # host float, so no score call waits for the device.
        score_fn.scalar_t = kernel != "xla"
        self._sample_loop_fn(sample_steps, eta, solver)  # an unknown solver raises here
        chain = partial(self.reverse_chain, sample_steps=sample_steps, eta=eta, solver=solver,
                        device=device)
        shape = (batch_size, self.num_atoms, 3)
        per_rank = kernel != "xla" and n_ranks > 1

        def sample(generator=None, noise=None):
            if per_rank and noise is None:
                mol = chain(None, score_fn, (batch_size // n_ranks, *shape[1:]),
                            _rank_generator(generator, mesh))
            else:
                mol = chain(sample._graphs, score_fn, shape, generator, noise=noise, mesh=mesh)
            return gather(mol * self.norm_factor, mesh)

        sample.kernel = kernel
        sample.score_fn = score_fn
        # The reverse step's CUDA graphs; None runs the eager loop (the CPU's,
        # and the card's only where a comparison sets it so).
        sample._graphs = graphs_for(device) if graphed and kernel == "xla" else None
        return sample


def _rank_generator(generator: torch.Generator, mesh) -> torch.Generator:
    """A generator for this rank's own rows: seeded from one draw of the
    caller's ``generator`` (which so advances alike on every rank) plus the
    rank."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    return torch.Generator(generator.device).manual_seed(seed + mesh.rank)
