"""bfloat16 score-network compute in the port against the JAX package, on the
CPU: the network (every edge configuration), its rounding points, the
Langevin force and step, the reverse chain, the fused paths (which ignore
the flag) and a training step.

No bit parity with JAX. On the CPU XLA computes a fused chain of bfloat16
elementwise operations in float32 and rounds once at its end
(``xla_allow_excess_precision``), and its products may round at other
points; PyTorch rounds after every operation. The two bfloat16 results are
therefore held relative to JAX's own distance from float32 on the same
inputs:

    max |port_bf16 - jax_bf16| <= C_RULE * max |jax_bf16 - jax_f32| + FLOOR * scale

with ``scale`` the largest float32 value of the quantity. C_RULE = 2 and
FLOOR = 2**-8 (one bfloat16 unit in the last place) were set from CPU runs
(scripts/torch_bf16_rule.py): over 24 networks (four edge configurations,
both attention paths, three seeds) the port's distance from JAX's bfloat16
forces was 0.09-1.64 times JAX's distance from its float32 forces; with
XLA's excess precision off 0.06-1.43, so the rule is not a matter of where
XLA rounds. A port that computed in float32 would pass the rule too, so each
test also asserts that the bfloat16 result differs from the float32 one.

Random numbers: the noise of the Langevin steps and of the reverse chain,
and the training step's rotation, timesteps and noise, are JAX's draws
handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
from twoforone_tpu.dynamics import integrators as jint
from twoforone_tpu.dynamics.langevin import LangevinDiffusion as JLD
from twoforone_tpu.dynamics.langevin import make_diffusion_force_fn as jforce
from twoforone_tpu.models import get_model as jget_model
from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
from twoforone_tpu.models.graph_transformer import score_forward as jscore
from twoforone_tpu.ops.geometry import center_zero as jcenter
from twoforone_tpu.ops.geometry import random_rotation as jrandom_rotation
from twoforone_tpu.utils.config import TrainConfig as JConfig
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.data.synthetic import chain10_dataset
from twoforone_torch.dynamics.langevin import LangevinDiffusion, make_diffusion_force_fn
from twoforone_torch.models import get_model
from twoforone_torch.models.graph_transformer import GraphTransformer, init_params, score_forward
from twoforone_torch.utils.convert import params_from_jax, params_to_jax
from test_torch_checkpoint import _leaves, one_torch_thread  # noqa: F401 (autouse)
from test_torch_diffusion import _jax_noise_hook
from test_torch_train import CONFIGS, NORM, _chignolin_sets, _jax_step_draws, _leaf, _trainer

C_RULE = 2.0
FLOOR = 2.0**-8
BF16 = torch.bfloat16
EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
EDGE_CONFIGS = [  # (use_intrinsic_coords, use_distances, use_abs_coords)
    (True, False, False),
    (False, True, True),
    (True, True, True),
    (False, False, True),
]


def assert_rule(port16, jax16, jax32, scale=None, what=""):
    """The module docstring's rule; returns the port's distance from JAX's
    bfloat16 result."""
    port16, jax16, jax32 = (np.asarray(a, np.float64) for a in (port16, jax16, jax32))
    scale = np.abs(jax32).max() if scale is None else scale
    dist = np.abs(port16 - jax16).max()
    bound = C_RULE * np.abs(jax16 - jax32).max() + FLOOR * scale
    assert dist <= bound, (what, dist, bound)
    return dist


def _pair(n, nf, layers, seed, **kw):
    """The JAX network and its parameters, and the port's network with them
    loaded."""
    jm = JGT(num_beads=n, hidden_nf=nf, n_layers=layers, heads=2, dim_head=8, **kw)
    jp = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, n, 3)), jnp.zeros((1,)),
                 return_energy=True)["params"]
    jp = jax.tree_util.tree_map(np.asarray, jp)
    m = GraphTransformer(n, nf, layers, heads=2, dim_head=8, **kw)
    m.load_state_dict(params_from_jax(jp))
    return jm, jp, m


def _jit_score(jm, **kw):
    return jax.jit(lambda p, x, t: jscore(jm, p, x, t, **kw))


@pytest.mark.parametrize("geometric", [True, False])
@pytest.mark.parametrize("intrinsic,distances,abs_coords", EDGE_CONFIGS)
def test_bf16_forces_and_energies_match_jax(intrinsic, distances, abs_coords, geometric):
    """Energies and forces of ``with_dtype(bfloat16)`` against the JAX
    network at ``clone(dtype=jnp.bfloat16)``, N=5, nf 32, 2 layers, by the
    rule; both come back float32, and the port's bfloat16 forces differ from
    its float32 ones by more than 1e-3 of the largest force."""
    jm, jp, m = _pair(5, 32, 2, 1, use_intrinsic_coords=intrinsic, use_distances=distances,
                      use_abs_coords=abs_coords, use_geometric_edges=geometric)
    jb = jm.clone(dtype=jnp.bfloat16)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 5, 3)).astype(np.float32)
    t = rng.uniform(size=(8,)).astype(np.float32)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    m16 = m.with_dtype(BF16)
    for kw in ({}, {"return_energy": True}):
        jax32 = np.asarray(_jit_score(jm, **kw)(jp, x, t))
        jax16 = np.asarray(_jit_score(jb, **kw)(jp, x, t))
        port16 = score_forward(m16, xt, tt, **kw).detach()
        port32 = score_forward(m, xt, tt, **kw).detach()
        assert port16.dtype == torch.float32 and jax16.dtype == np.float32
        assert_rule(port16.numpy(), jax16, jax32, what=kw)
        assert (port16 - port32).abs().max() > 1e-3 * port32.abs().max()


def test_rounding_points_follow_flax():
    """The dtype each block returns equals flax's (``capture_intermediates``)
    on the same bfloat16 network: LayerNorm float32 (statistics and output;
    flax promotes a bfloat16 input with float32 scale and bias), attention,
    feed-forward and residual bfloat16, the energy float32."""
    jm, jp, m = _pair(5, 16, 2, 0, **EDGES)
    jb = jm.clone(dtype=jnp.bfloat16)
    x, t = jnp.ones((2, 5, 3)) * 0.1, jnp.full((2,), 0.3)
    out, state = jb.apply({"params": jp}, x, t, return_energy=True,
                          capture_intermediates=True)
    flax_dtypes = {name: vals["__call__"][0].dtype
                   for name, vals in state["intermediates"].items() if name.startswith("layers")}
    seen = {}
    m16 = m.with_dtype(BF16)
    hooks = [mod.register_forward_hook(lambda mod, i, o, name=name: seen.__setitem__(name, o))
             for name, mod in m16.named_children() if name.startswith("layers")]
    energy = m16(torch.full((2, 5, 3), 0.1), torch.full((2,), 0.3), return_energy=True)
    for h in hooks:
        h.remove()
    assert set(seen) == set(flax_dtypes) and len(seen) == 12
    for name, dt in flax_dtypes.items():
        assert str(seen[name].dtype).split(".")[-1] == str(dt), name
    assert out.dtype == jnp.float32 and energy.dtype == torch.float32


def test_with_dtype_shares_float32_parameters():
    """The bfloat16 view holds the very float32 tensors of the network (a
    weight loaded into one is seen by the other); the network keeps its
    dtype; get_model(bf16=True) builds a bfloat16 network on float32
    parameters; float32_products restores the caller's settings."""
    from twoforone_torch.utils.device import float32_products

    _, jp, m = _pair(5, 16, 1, 0, **EDGES)
    v = m.with_dtype(BF16)
    assert v is not m and m.dtype is None and v.dtype == BF16
    assert all(a is b for a, b in zip(m.parameters(), v.parameters()))
    assert all(p.dtype == torch.float32 for p in v.parameters())
    assert v.layers_0_attn.dtype == v.layers_0_ff.dtype == v.layers_0_ff_res.dtype == BF16
    assert m.layers_0_attn.dtype is None
    with torch.no_grad():
        m.node_decoder.bias.fill_(0.5)
    assert v.state_dict()["node_decoder.bias"].eq(0.5).all()
    assert v.with_dtype(None).dtype is None
    cfg = JConfig.from_dict(dict(CONFIGS["default_edges"], bf16=True))
    net = get_model(cfg, 10)
    assert net.dtype == BF16 and all(p.dtype == torch.float32 for p in net.parameters())
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    with float32_products():
        assert matmul.allow_bf16_reduced_precision_reduction is False
    assert matmul.allow_bf16_reduced_precision_reduction == before


def _gd_pair(n=10, nf=32, layers=2, timesteps=100, norm=1.7, seed=0):
    jm = JGT(num_beads=n, hidden_nf=nf, n_layers=layers, **EDGES)
    jgd = JGD(model=jm, num_atoms=n, timesteps=timesteps, norm_factor=norm)
    jp = jax.tree_util.tree_map(np.asarray, jgd.init_params(jax.random.PRNGKey(seed)))
    gd = GaussianDiffusion(model=GraphTransformer(n, nf, layers, **EDGES), num_atoms=n,
                           timesteps=timesteps, norm_factor=norm)
    return jgd, gd, jp


@pytest.mark.parametrize("fused", ["cl", "clx", "always"])
def test_fused_paths_ignore_bf16(fused):
    """``bf16=True`` on the fused paths (their kernels' plain versions on CPU
    tensors) gives the float32 force bit for bit, as in the JAX package; on
    ``never`` it acts."""
    _, gd, params = _gd_pair()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(6, 10, 3)).astype(np.float32))
    forces = {}
    for mode in (fused, "never"):
        for bf16 in (False, True):
            fn = make_diffusion_force_fn(gd, params, 20, 0.7, fused=mode, n_chains=6,
                                         device="cpu", bf16=bf16)
            assert fn.mode == mode
            forces[mode, bf16] = fn(x)[1]
    assert torch.equal(forces[fused, True], forces[fused, False])
    assert not torch.equal(forces["never", True], forces["never", False])


BENCH = dict(t=20, temp_data=340, temp_sim=340, dt=2e-3, masses=[12.0] * 10,
             friction=1.0, kb="consistent", restraint_k=50.0, max_force=1e3)


def test_ten_bf16_langevin_steps_match_jax():
    """16 chains, 10 BAOAB steps at bench.py's settings with the same
    injected noise, ``LangevinDiffusion(bf16=True)`` (``"auto"`` on the CPU:
    the plain network) against the JAX loop with the bfloat16 force, by the
    rule in units of x; the float32 loop of JAX gives the rule's distance."""
    jgd, gd, params = _gd_pair()
    rng = np.random.default_rng(5)
    init = rng.normal(size=(16, 10, 3)).astype(np.float32)
    init = (init - init.mean(axis=1, keepdims=True)) * gd.norm_factor
    noise = rng.normal(size=(10, 16, 10, 3)).astype(np.float32)

    def jax_loop(bf16):
        jld = JLD(jgd, params, init, n_timesteps=10, save_interval=10, log=False, **BENCH)
        sim = jld.sim
        force_fn = jax.jit(jforce(jgd, params, 20, jld.kb_inv / 340, bf16=bf16))
        x, v = jnp.asarray(init / jld.norm_factor), jnp.zeros((16, 10, 3))
        for k in range(10):
            x = jcenter(x)
            _, forces = force_fn(x)
            forces = jnp.clip(forces, -1e3, 1e3) - 50.0 * x
            x, v = jint.baoab_step(x, v, forces, jnp.asarray(noise[k]), sim.dt, sim._masses,
                                   sim.vscale, sim.noisescale, sim.beta)
        return np.asarray(x) * jld.norm_factor

    def port_loop(bf16):
        ld = LangevinDiffusion(gd, params, init, n_timesteps=10, save_interval=10, log=False,
                               fused="auto", bf16=bf16, device="cpu", **BENCH)
        assert ld.force_fn.mode == "never"
        draws = iter(torch.from_numpy(noise))
        ld.sim._draw_noise = lambda like: next(draws)
        return ld.sample()

    jax32, jax16 = jax_loop(False), jax_loop(True)
    port16, port32 = port_loop(True), port_loop(False)
    assert port16.shape == (16, 10, 3) and np.isfinite(port16).all()
    assert_rule(port16, jax16, jax32, what="10 steps")
    assert np.abs(port16 - port32).max() > 1e-5 * np.abs(port32).max()


def test_ddim20_bf16_matches_jax_call_by_call(monkeypatch):
    """DDIM-20 through ``sample(bf16=True)`` on the staged chain10 weights
    (published widths), 32 chains, the JAX chain's own noise. A reverse
    chain amplifies a score difference ~1e3-fold, so the chain is held call
    by call: at each of its 20 score calls the port's bfloat16 eps against
    JAX's bfloat16 network at the same state and t, by the rule, with JAX's
    float32 network for the rule's distance (CPU runs: at most 1.63 times
    it). The samples are finite and centred, and the bfloat16 chain is not
    the float32 one. (Random small networks are no use here: their eps
    reaches 40 along a chain that leaves the data's scale, where bfloat16
    rounding is as large as the value.)"""
    from test_torch_dynamics import _jax_chain10, _port_chain10

    jgd, jparams = _jax_chain10()
    gd, params = _port_chain10()
    jax32, jax16 = _jit_score(jgd.model), _jit_score(jgd.model.clone(dtype=jnp.bfloat16))
    calls = []
    score_fn = GaussianDiffusion.score_fn

    def recording(self, *args, **kwargs):
        fn = score_fn(self, *args, **kwargs)

        def record(x, t_norm):
            out = fn(x, t_norm)
            calls.append((x.numpy().copy(), t_norm.numpy().copy(), out.numpy().copy()))
            return out

        return record

    monkeypatch.setattr(GaussianDiffusion, "score_fn", recording)
    key = jax.random.PRNGKey(11)
    out = {bf16: gd.sample(params, 32, sample_steps=20, noise=_jax_noise_hook(key),
                           device="cpu", bf16=bf16).numpy() / gd.norm_factor
           for bf16 in (False, True)}
    assert len(calls) == 40
    for x, t, eps in calls[20:]:
        ref32 = np.asarray(jax32(jparams, x, t))
        assert_rule(eps, np.asarray(jax16(jparams, x, t)), ref32, what=float(t[0]))
    assert np.isfinite(out[True]).all()
    np.testing.assert_allclose(out[True].mean(axis=1), 0.0, atol=1e-4)
    assert np.abs(out[True] - out[False]).max() > 1e-4


def test_bf16_sampling_matches_f32_distribution():
    """``tests/test_diffusion.py``'s check on the port: the bead covariance
    of 4096 samples of the 100-step ancestral chain of a random conservative
    network (N=5, nf 16, 1 layer; 2 x 8 heads, which keeps the CPU run
    short) in bfloat16 within 0.05 (relative, Frobenius) of the float32
    chain's from the same generator seed (CPU run: 0.0016; two float32 seeds
    differ by 0.034); centres of mass within 1e-3."""
    model = GraphTransformer(5, 16, 1, heads=2, dim_head=8, **EDGES)
    gd = GaussianDiffusion(model=model, num_atoms=5, timesteps=100, norm_factor=2.0)
    params = init_params(model, 0)

    def draw(bf16):
        gen = torch.Generator().manual_seed(11)
        return gd.sample(params, 4096, gen, device="cpu", bf16=bf16).numpy()

    s32, s16 = draw(False), draw(True)
    assert np.isfinite(s16).all()
    np.testing.assert_allclose(s16.mean(axis=1), 0.0, atol=1e-3)

    def bead_cov(s):
        s = s.astype(np.float64)
        return np.einsum("bic,bjc->ij", s, s) / (s.shape[0] * 3)

    c32, c16 = bead_cov(s32), bead_cov(s16)
    assert np.linalg.norm(c16 - c32) / np.linalg.norm(c32) < 0.05
    assert not np.array_equal(s16, s32)


def test_bf16_training_step_matches_jax(tmp_path):
    """One step of the port's Trainer on a bfloat16 model (``bf16=True``,
    nf 32, 2 layers, default heads) with JAX's draws injected: the loss and
    the gradient against ``jax.value_and_grad`` of the JAX loss on its
    bfloat16 model, by the rule (the gradient as one vector, each leaf in
    units of its scale). The input gradient
    (``create_graph=True``) passes through the casts; weights, gradients,
    Adam's moments and the EMA stay float32, and the checkpoint's trees are
    float32."""
    fields = dict(CONFIGS["non_conservative"], conservative=True, bf16=True)
    trainer = _trainer(tmp_path, fields, _chignolin_sets())
    assert trainer.net.dtype == trainer.ema.dtype == BF16
    params = params_to_jax(trainer.net.state_dict())

    batch = chain10_dataset(16, seed=5)
    jgds, grads = {}, {}
    for bf16 in (False, True):
        jcfg = JConfig.from_dict(dict(fields, bf16=bf16))
        jgds[bf16] = JGD(model=jget_model(jcfg, 10), num_atoms=10, timesteps=1000,
                         norm_factor=NORM, loss_weights=jcfg.loss_weights)
    assert jgds[True].model.dtype == jnp.bfloat16
    aug_key, loss_key, draws = _jax_step_draws(jax.random.PRNGKey(7), jgds[True], batch)
    mb = jrandom_rotation(jnp.asarray(batch), aug_key)
    for bf16, jgd in jgds.items():
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p: jgd.loss(p, mb, loss_key), has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, params))
        grads[bf16] = (float(loss), dict(_leaves(jax.tree_util.tree_map(np.asarray, g))))

    metrics = trainer._train_step(batch, torch.Generator(), draws=[draws])
    (l32, g32), (l16, g16) = grads[False], grads[True]
    loss = float(metrics["loss"])
    assert np.isfinite(loss)
    assert_rule(loss, l16, l32, what="loss")
    got = params_to_jax({n: p.grad for n, p in trainer.net.named_parameters()})
    assert all(_leaf(got, path).dtype == np.float32 for path in g16)
    # The rule on the whole gradient, each leaf in units of its scale (its
    # largest float32 entry, at least 1e-2 of the largest of any leaf): per
    # leaf, two draws of bfloat16 rounding noise around the float32 gradient
    # put the port up to 2.3 times JAX's distance (CPU runs, 3 seeds).
    largest = max(np.abs(g).max() for g in g32.values())
    scale = {path: max(np.abs(g).max(), 1e-2 * largest) for path, g in g32.items()}
    paths = sorted(g16)

    def units(leaf):
        return np.concatenate([leaf(p).ravel() / scale[p] for p in paths])

    got_units = units(lambda p: _leaf(got, p))
    assert_rule(got_units, units(g16.get), units(g32.get), scale=1.0, what="gradients")
    moved = np.abs(got_units - units(g32.get)).max()
    assert moved > 1e-4  # the bfloat16 gradient is not the float32 one
    assert all(p.dtype == torch.float32 for p in trainer.net.parameters())
    assert all(p.dtype == torch.float32 for p in trainer.ema.parameters())
    assert all(s[k].dtype == torch.float32 for s in trainer.optimizer.state.values()
               for k in ("mu", "nu"))
    trainer.save(1)
    from twoforone_torch.utils.checkpoint import load_checkpoint

    state = load_checkpoint(trainer.results_folder, "last")
    assert all(np.asarray(a).dtype == np.float32
               for tree in ("params", "ema_params") for _, a in _leaves(state[tree]))
