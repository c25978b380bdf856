"""Port's DDPM core (forward process, losses, the three reverse chains and
the sampling entry points) against the JAX package.

torch and JAX draw different random numbers from the same seed, so the
parity tests rebuild the noise the JAX loops draw (``split`` for the start,
``fold_in(key, t)`` for each step) and hand it to the port through its noise
hook. Both sides run float32 on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoforone_tpu.core import diffusion as jd
from twoforone_tpu.core.schedules import make_buffers as jmake_buffers
from twoforone_torch.core import diffusion as td
from twoforone_torch.core.schedules import make_buffers
from twoforone_torch.models.graph_transformer import GraphTransformer

N = 5
T = torch.from_numpy
EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)


@functools.lru_cache(maxsize=None)
def _bufs(timesteps=50, weights="ones"):
    return (jmake_buffers(timesteps, "cosine", weights),
            make_buffers(timesteps, "cosine", weights))


def _state(seed=0, b=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, N, 3)).astype(np.float32)
    x0 = rng.normal(size=(b, N, 3)).astype(np.float32)
    noise = rng.normal(size=(b, N, 3)).astype(np.float32)
    t = rng.integers(0, 50, size=(b,))
    return x - x.mean(axis=1, keepdims=True), x0 - x0.mean(axis=1, keepdims=True), noise, t


def _mock_scores():
    """The same cheap score on both sides: depends on x and on t_norm."""
    return (lambda x, tn: 0.5 * x + tn[:, None, None],
            lambda x, tn: 0.5 * x + tn[:, None, None])


def _close(got, ref, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **kw)


@pytest.mark.parametrize("name", ["q_sample", "predict_start_from_noise", "q_posterior",
                                  "q_mean_variance"])
def test_stateless_math_matches_jax(name):
    """Gathers and elementwise f32 arithmetic in the same order: rtol 1e-6
    (sqrt_recip coefficients reach ~2e4 at T-1, so the check is relative)."""
    jbuf, tbuf = _bufs()
    x, x0, noise, t = _state()
    args = {
        "q_sample": (x0, t, noise),
        "predict_start_from_noise": (x, t, noise),
        "q_posterior": (x0, x, t),
        "q_mean_variance": (x0, t),
    }[name]
    ref = getattr(jd, name)(jbuf, *map(jnp.asarray, args))
    got = getattr(td, name)(tbuf, *map(T, args))
    for g, r in zip(*[(o if isinstance(o, tuple) else (o,)) for o in (got, ref)]):
        _close(g.numpy(), r, rtol=1e-6, atol=1e-7)


def test_normal_kl_at_T_matches_jax():
    jbuf, tbuf = _bufs(1000)
    _, x0, _, _ = _state()
    ref = float(jd.normal_kl_at_T(jbuf, jnp.asarray(x0)))
    got = float(td.normal_kl_at_T(tbuf, T(x0)))
    assert got == pytest.approx(ref, rel=1e-5, abs=1e-9)
    assert got <= 1e-4


@pytest.mark.parametrize("objective,loss_type", [("pred_noise", "l2"), ("pred_noise", "l1"),
                                                 ("pred_x0", "l2")])
def test_p_losses_matches_jax_with_injected_noise(objective, loss_type):
    """The JAX loss draws its noise from a key; the test draws it the same
    way and hands it to the port. rtol 1e-5 on a mean of 90 f32 terms."""
    jbuf, tbuf = _bufs()
    _, x0, _, t = _state(1)
    key = jax.random.PRNGKey(4)
    noise = np.array(jax.random.normal(key, x0.shape, dtype=jnp.float32))
    jscore, tscore = _mock_scores()
    ref = jd.p_losses(jbuf, jscore, jnp.asarray(x0), jnp.asarray(t), key, objective, loss_type)
    got = td.p_losses(tbuf, tscore, T(x0), T(t), T(noise), objective, loss_type)
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    with pytest.raises(ValueError, match="invalid loss type"):
        td.p_losses(tbuf, tscore, T(x0), T(t), T(noise), objective, "huber")


@pytest.mark.parametrize("t_range", [None, (0, 10), (30, 45)])
def test_sample_timesteps_support(t_range):
    """Support only: the two packages draw different numbers. Weighted
    ("higheruntil_10") so both weight levels are in play."""
    _, tbuf = _bufs(50, "higheruntil_10")
    gen = torch.Generator().manual_seed(0)
    t = td.sample_timesteps(tbuf, gen, 4000, t_range, device="cpu")
    lo, hi = t_range or (0, 50)
    assert t.shape == (4000,) and t.dtype == torch.long
    assert int(t.min()) >= lo and int(t.max()) < hi
    assert len(torch.unique(t)) == hi - lo  # every allowed timestep is reachable
    if t_range is None:  # t < 10 carries weight 5 against 1.25: half the mass
        assert abs(float((t < 10).float().mean()) - 0.5) < 0.05


@pytest.mark.parametrize("interval", [(-1, 10), (10, 10), (0, 51)])
def test_t_diff_interval_is_validated(interval):
    model = GraphTransformer(N, 8, 1, **EDGES)
    with pytest.raises(ValueError, match="t_diff_interval"):
        td.GaussianDiffusion(model=model, num_atoms=N, timesteps=50, t_diff_interval=interval)


@pytest.mark.parametrize("timesteps,steps", [(1000, 50), (1000, 100), (100, 100), (100, 1),
                                             (50, 7), (1000, 1000)])
def test_ddim_timestep_ladder_is_exact(timesteps, steps):
    jt, jp = jd.ddim_timestep_ladder(timesteps, steps)
    tt, tp = td.ddim_timestep_ladder(timesteps, steps)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_array_equal(tp, np.asarray(jp))
    assert tt[0] == timesteps - 1 and tp[-1] == -1
    with pytest.raises(ValueError):
        td.ddim_timestep_ladder(timesteps, timesteps + 1)


@pytest.mark.parametrize("t_scalar", [49, 25, 0])
@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
def test_p_sample_matches_jax(t_scalar, objective):
    """One ancestral step with the JAX-drawn noise handed in. rtol 1e-5: at
    t = T-1 intermediate x0 estimates reach ~1e4 before the posterior
    coefficients bring them back."""
    jbuf, tbuf = _bufs()
    x, _, _, _ = _state(2)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, x.shape, dtype=jnp.float32))
    jscore, tscore = _mock_scores()
    t = np.full((x.shape[0],), t_scalar)
    ref = jd.p_sample(jbuf, jscore, jnp.asarray(x), jnp.asarray(t, jnp.int32), key, objective)
    got = td.p_sample(tbuf, tscore, T(x), T(t), T(noise), objective)
    _close(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tau,tau_prev", [(49, 48), (49, 40), (25, 20), (1, 0), (0, -1)])
@pytest.mark.parametrize("eta,clip_x0", [(0.0, 10.0), (1.0, 10.0), (0.5, None)])
def test_ddim_step_matches_jax(tau, tau_prev, eta, clip_x0):
    """One DDIM update, including the final hop and the engaged x0 clip (at
    tau = 49 the mock score drives |x0| far past 10). rtol/atol 1e-5, as
    for the ancestral step."""
    jbuf, tbuf = _bufs()
    x, _, _, _ = _state(3)
    key = jax.random.PRNGKey(8)
    noise = np.array(jax.random.normal(key, x.shape, dtype=jnp.float32))
    jscore, tscore = _mock_scores()
    ref = jd.ddim_step(jbuf, jscore, jnp.asarray(x), tau, tau_prev, key, eta=eta,
                       clip_x0=clip_x0)
    got = td.ddim_step(tbuf, tscore, T(x), tau, tau_prev, T(noise), eta=eta, clip_x0=clip_x0)
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    _close(got.numpy(), ref, rtol=1e-5, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# Whole chains on the analytic Gaussian score (tests/test_ddim.py's system)
# ---------------------------------------------------------------------------

def _gaussian_system():
    p = np.eye(N) - np.ones((N, N)) / N
    cov = p @ np.diag([3.0, 2.0, 1.5, 1.0, 0.5]) @ p
    nf2 = cov.trace() / N
    evals, evecs = np.linalg.eigh(cov / nf2)
    ones_dir = int(np.abs(evecs.T @ (np.ones(N) / np.sqrt(N))).argmax())
    return cov, nf2, evals.astype(np.float32), evecs.astype(np.float32), ones_dir


def _analytic_scores(jbuf, tbuf):
    """Optimal eps for N(0, cov/nf2) data: the same formula on both sides."""
    _, _, evals, evecs, ones_dir = _gaussian_system()
    nT = tbuf.num_timesteps
    keep = np.arange(N) != ones_dir

    def jscore(x, t_norm):
        t = jnp.clip(jnp.round(t_norm * nT).astype(int), 0, nT - 1)[0]
        a = jbuf.alphas_cumprod[t]
        lam = a * jnp.asarray(evals) + (1.0 - a)
        inv = jnp.where(jnp.asarray(keep), 1.0 / jnp.maximum(lam, 1e-12), 0.0)
        v = jnp.asarray(evecs)
        return jnp.sqrt(1.0 - a) * jnp.einsum("ij,j,kj,bkc->bic", v, inv, v, x)

    def tscore(x, t_norm):
        t = torch.clamp(torch.round(t_norm * nT).long(), 0, nT - 1)[0]
        a = tbuf.alphas_cumprod[t]
        lam = a * T(evals) + (1.0 - a)
        inv = torch.where(T(keep), 1.0 / lam.clamp(min=1e-12), torch.zeros(()))
        v = T(evecs)
        return torch.sqrt(1.0 - a) * torch.einsum("ij,j,kj,bkc->bic", v, inv, v, x)

    return jscore, tscore


def _jax_noise_hook(key):
    """The numbers a JAX reverse chain draws from ``key``."""
    key, init_key = jax.random.split(key)

    def noise(tag, shape):
        k = init_key if tag == "init" else jax.random.fold_in(key, tag)
        return np.array(jax.random.normal(k, shape, dtype=jnp.float32))

    return noise


CHAINS = {
    "ancestral": (lambda *a: jd.p_sample_loop(*a),
                  lambda *a, **k: td.p_sample_loop(*a, **k)),
    "ddim_eta0": (lambda *a: jd.ddim_sample_loop(*a, sample_steps=12, eta=0.0),
                  lambda *a, **k: td.ddim_sample_loop(*a, sample_steps=12, eta=0.0, **k)),
    "ddim_eta1": (lambda *a: jd.ddim_sample_loop(*a, sample_steps=12, eta=1.0),
                  lambda *a, **k: td.ddim_sample_loop(*a, sample_steps=12, eta=1.0, **k)),
    "dpm2m": (lambda *a: jd.dpm_solver_pp_2m_loop(*a, sample_steps=12),
              lambda *a, **k: td.dpm_solver_pp_2m_loop(*a, sample_steps=12, **k)),
    "dpm2m_1step": (lambda *a: jd.dpm_solver_pp_2m_loop(*a, sample_steps=1),
                    lambda *a, **k: td.dpm_solver_pp_2m_loop(*a, sample_steps=1, **k)),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_whole_chain_matches_jax(chain):
    """T = 50, 8 chains, the analytic score, the JAX loop's own noise fed
    through the hook. rtol/atol 1e-3: f32 differences of ~1e-6 a step pass
    through up to 50 contractive steps."""
    jbuf, tbuf = _bufs()
    jscore, tscore = _analytic_scores(jbuf, tbuf)
    key = jax.random.PRNGKey(3)
    shape = (8, N, 3)
    jloop, tloop = CHAINS[chain]
    ref = np.asarray(jloop(jbuf, jscore, shape, key))
    got = tloop(tbuf, tscore, shape, noise=_jax_noise_hook(key), device="cpu").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.mean(axis=1), 0.0, atol=1e-5)


def test_full_ladder_eta1_chain_is_ancestral():
    """With every timestep on the ladder and eta = 1 the DDIM chain is the
    ancestral chain (same noise through the hook)."""
    _, tbuf = _bufs()
    _, tscore = _analytic_scores(*_bufs())
    hook = _jax_noise_hook(jax.random.PRNGKey(5))
    anc = td.p_sample_loop(tbuf, tscore, (8, N, 3), noise=hook, device="cpu")
    dd = td.ddim_sample_loop(tbuf, tscore, (8, N, 3), sample_steps=50, eta=1.0, noise=hook,
                             device="cpu")
    np.testing.assert_allclose(dd.numpy(), anc.numpy(), rtol=1e-3, atol=1e-3)


def test_strided_ddim_reproduces_gaussian_target_with_torch_generator():
    """50-step deterministic DDIM from the port's own generator reaches the
    target covariance (same bound as the JAX package's test)."""
    jbuf, tbuf = _bufs(1000)
    _, tscore = _analytic_scores(jbuf, tbuf)
    cov, nf2, *_ = _gaussian_system()
    gen = torch.Generator().manual_seed(0)
    mol = td.ddim_sample_loop(tbuf, tscore, (2000, N, 3), gen, sample_steps=50, eta=0.0,
                              device="cpu")
    s = (mol.numpy() * np.sqrt(nf2)).astype(np.float64)
    cov_hat = np.einsum("bic,bjc->ij", s, s) / (s.shape[0] * 3)
    rel = np.linalg.norm(cov_hat - cov) / np.linalg.norm(cov)
    assert rel < 0.08, f"DDIM covariance mismatch: rel={rel:.3f}"
    np.testing.assert_allclose(s.mean(axis=1), 0.0, atol=1e-3)


def test_chain_needs_generator_or_hook():
    _, tbuf = _bufs()
    with pytest.raises(ValueError, match="Generator or a noise hook"):
        td.p_sample_loop(tbuf, lambda x, t: x, (2, N, 3), device="cpu")


# ---------------------------------------------------------------------------
# GaussianDiffusion entry points
# ---------------------------------------------------------------------------

def _gd(n, hidden=8, timesteps=20, **kw):
    model = GraphTransformer(n, hidden, 1, heads=2, dim_head=4, **{**EDGES, **kw})
    return td.GaussianDiffusion(model=model, num_atoms=n, timesteps=timesteps, norm_factor=1.7)


def _params(model):
    from test_torch_checkpoint import _model_params

    return _model_params(model)


@pytest.mark.parametrize("n,batch,expected", [(10, 100, "cl"), (10, 4096, "cl"),
                                              (20, 1024, "clx"), (28, 256, "clx"),
                                              (20, 100, "xla"), (56, 1024, "xla")])
def test_fused_sample_fn_kernel_resolution(n, batch, expected):
    """The JAX package's gate (core/diffusion.py make_fused_sample_fn) for a
    CUDA device, given as a string so that no card is needed. On the CPU
    "auto" is the plain network, and says so."""
    gd = _gd(n)
    assert gd.resolve_sample_kernel("auto", batch, "cuda") == expected
    assert gd.resolve_sample_kernel("clx", batch, "cuda") == "clx"
    fn = gd.make_fused_sample_fn(_params(gd.model), batch, device="cpu")
    assert fn.kernel == "xla"


@pytest.mark.parametrize("n,chains", [(10, 100), (20, 1000), (20, 100), (56, 1000)])
def test_sampler_and_langevin_share_one_gate(n, chains):
    """kernel="auto" and fused="auto" resolve through the same function:
    the same path for the same model, chain count and device, under each
    caller's name for the plain path."""
    from twoforone_torch.dynamics.langevin import resolve_fused_mode

    gd = _gd(n)
    for device in ("cuda", "cpu"):
        sampler = gd.resolve_sample_kernel("auto", chains, device)
        langevin = resolve_fused_mode(gd.model, "auto", chains, device)
        assert {"xla": "never"}.get(sampler, sampler) == langevin
    other = _gd(n, use_abs_coords=True)
    assert other.resolve_sample_kernel("auto", chains, "cuda") == "packed"
    assert resolve_fused_mode(other.model, "auto", chains, "cuda") == "never"
    assert other.resolve_sample_kernel("auto", chains, "cpu") == "xla"
    assert resolve_fused_mode(other.model, "auto", chains, "cpu") == "never"


@pytest.mark.parametrize("abs_coords", [False, True])
@pytest.mark.parametrize("intrinsic,distances", [(True, False), (False, True), (True, True),
                                                 (False, False)])
def test_auto_sample_kernel_for_every_edge_configuration(intrinsic, distances, abs_coords):
    """The JAX package's gate: on the card every edge configuration but the
    production one gets "packed" from "auto", at any bead count; on the CPU
    "auto" is the plain network for all of them, and says so."""
    production = intrinsic and not distances and not abs_coords
    for n in (6, 40):
        gd = _gd(n, use_intrinsic_coords=intrinsic, use_distances=distances,
                 use_abs_coords=abs_coords)
        on_card = gd.resolve_sample_kernel("auto", 1024, "cuda")
        assert on_card == (("cl" if n == 6 else "xla") if production else "packed")
        assert gd.resolve_sample_kernel("auto", 1024, "cpu") == "xla"
        assert gd.resolve_sample_kernel("packed", 1024, "cpu") == "packed"
    fn = gd.make_fused_sample_fn(_params(gd.model), 8, sample_steps=2, device="cpu")
    assert fn.kernel == "xla"


@pytest.mark.parametrize("kernel,use_abs", [("packed", False), ("packed", True), ("auto", True)])
def test_packed_kernel_builds_and_unknown_kernel_raises(kernel, use_abs):
    """kernel="packed" builds for the production configuration and for
    another one and reports its name; "auto" on the CPU reports "xla" and
    runs the plain network; an unknown name raises."""
    gd = _gd(6, use_abs_coords=use_abs)
    fn = gd.make_fused_sample_fn(_params(gd.model), 8, kernel=kernel, sample_steps=3,
                                 device="cpu")
    assert fn.kernel == ("packed" if kernel == "packed" else "xla")
    out = fn(torch.Generator().manual_seed(0))
    assert out.shape == (8, 6, 3) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown kernel"):
        gd.make_fused_sample_fn(_params(gd.model), 8, kernel="mosaic", device="cpu")


@pytest.mark.parametrize("kernel", ["cl", "clx", "packed"])
@pytest.mark.parametrize("steps,solver", [(None, "ddim"), (6, "ddim"), (6, "dpm2m")])
def test_fused_sample_paths_agree_with_plain_network(kernel, steps, solver):
    """On the CPU the fused paths run their plain versions: with the same
    noise, every sampler gives the plain network's samples (data units).
    1e-4 of the largest coordinate: ~1e-6 a step over at most 20 steps."""
    gd = _gd(6)
    params = _params(gd.model)
    rng = np.random.default_rng(0)
    table = {tag: rng.normal(size=(4, 6, 3)).astype(np.float32)
             for tag in ["init", *range(20)]}
    hook = lambda tag, shape: table[tag]
    kw = dict(sample_steps=steps, eta=0.5, solver=solver, device="cpu")
    ref = gd.sample(params, 4, noise=hook, **kw)
    got = gd.make_fused_sample_fn(params, 4, kernel=kernel, **kw)(noise=hook)
    assert got.shape == (4, 6, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    np.testing.assert_allclose(got.mean(dim=1).numpy(), 0.0,
                               atol=1e-5 * max(1.0, float(ref.abs().max())))


def test_scalar_t_score_function_gets_a_host_float():
    """A score function that declares ``scalar_t`` is handed the timestep as
    a host float32 (the same number the tensor holds) by every loop; any
    other score function gets the tensor."""
    _, tbuf = _bufs()
    seen = []

    def score(x, t_norm):
        seen.append(t_norm)
        return 0.5 * x

    hook = _jax_noise_hook(jax.random.PRNGKey(1))
    loops = (lambda **k: td.p_sample_loop(tbuf, score, (2, N, 3), **k),
             lambda **k: td.ddim_sample_loop(tbuf, score, (2, N, 3), sample_steps=7, **k),
             lambda **k: td.dpm_solver_pp_2m_loop(tbuf, score, (2, N, 3), sample_steps=7, **k))
    for loop in loops:
        score.scalar_t = False
        seen.clear()
        plain = loop(noise=hook, device="cpu")
        tensors = list(seen)
        score.scalar_t = True
        seen.clear()
        got = loop(noise=hook, device="cpu")
        assert all(isinstance(t, float) for t in seen) and len(seen) == len(tensors)
        assert [float(t[0]) for t in tensors] == seen
        torch.testing.assert_close(got, plain, rtol=0, atol=0)


STAGED = {"chain10": (10, 64, 3.113133430480957), "chain20": (20, 128, 5.08211088180542)}


@pytest.mark.parametrize("name", sorted(STAGED))
def test_ddim20_on_staged_weights_matches_jax(name):
    """DDIM-20 at batch 256 on the trained weights, from the start state the
    smoke run on the card uses (numpy seed 10000), through the port's plain
    path and through the JAX ``ddim_step``.

    A 20-step chain on a learned score is not contractive: two float32
    implementations of the same network drift apart by ~1e-4 of a typical
    coordinate (``norm_factor``) in the rms and by several 1e-3 in the worst
    chain. The limits are the smoke run's for its kernel path against its
    plain path: rms <= 1e-3, max <= 5e-2, both in units of ``norm_factor``.
    A chain that ends on the ``clip_x0`` clamp (|x| = 10 in normalized
    units; one of chain20's 256 does) does so in both packages."""
    from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
    from twoforone_tpu.ops.geometry import center_zero as jcenter
    from twoforone_tpu.utils.artifacts import load_ema_params as jload
    from twoforone_torch.utils.artifacts import load_ema_params

    n, nf, norm = STAGED[name]
    init = np.random.default_rng(10_000).normal(size=(256, n, 3)).astype(np.float32)
    gd = td.GaussianDiffusion(model=GraphTransformer(n, nf, 3, **EDGES), num_atoms=n,
                              timesteps=1000, norm_factor=norm)
    got = gd.sample(load_ema_params(name), 256, noise=lambda tag, shape: init,
                    sample_steps=20, device="cpu").numpy()

    jgd = jd.GaussianDiffusion(
        model=JGT(num_beads=n, hidden_nf=nf, n_layers=3, conservative=True, **EDGES),
        num_atoms=n, timesteps=1000, norm_factor=norm)
    jscore = jgd.score_fn(jload(jgd, name))
    step = jax.jit(lambda mol, tau, tau_prev: jcenter(jnp.clip(
        jd.ddim_step(jgd.buffers, jscore, mol, tau, tau_prev, jax.random.PRNGKey(0)),
        -1000.0, 1000.0)))
    mol = jcenter(jnp.asarray(init))
    taus, prev_taus = td.ddim_timestep_ladder(1000, 20)
    for tau, tau_prev in zip(taus.tolist(), prev_taus.tolist()):
        mol = step(mol, tau, tau_prev)
    ref = np.asarray(mol) * norm

    diff = (got - ref) / norm
    assert np.isfinite(got).all()
    assert np.sqrt(np.mean(diff**2)) <= 1e-3
    assert np.abs(diff).max() <= 5e-2

    def on_clip(x):
        return set(np.flatnonzero(np.abs(x).max(axis=(1, 2)) >= 9.9 * norm).tolist())

    assert on_clip(got) == on_clip(ref) == ({144} if name == "chain20" else set())


def test_sample_with_generator_is_reproducible_and_loss_runs():
    gd = _gd(6)
    params = _params(gd.model)
    a = gd.sample(params, 3, torch.Generator().manual_seed(1), sample_steps=5, device="cpu")
    b = gd.sample(params, 3, torch.Generator().manual_seed(1), sample_steps=5, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown solver"):
        gd.sample(params, 3, torch.Generator(), sample_steps=5, solver="heun", device="cpu")
    mol = np.random.default_rng(2).normal(size=(5, 6, 3)).astype(np.float32)
    loss, aux = gd.loss(params, mol, torch.Generator().manual_seed(3), device="cpu")
    assert torch.isfinite(loss) and loss > 0 and torch.isfinite(aux["kl_at_T"])
