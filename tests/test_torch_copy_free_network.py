"""The plain network's copy-free forms (``models/graph_transformer.py``,
``ops/attention.py``) against the formulas they replaced.

The network merges each gated residual as ``x·ga + res·gh`` and one lerp,
builds its node input from the embedding's rows, and runs its geometric
attention core head-major, with the coordinate channels folded into the
keys, values and ``to_out``: no concatenation, and one copy of an
activation per change of layout. The replaced formulas are kept here as
oracles: the gated residual over
``[x, res, x − res]``, the one-hot node input, the packed attention with its
concatenated channels, and a network made of them.

The new forms sum in another order, so float64 agrees to rounding (1e-12
of the largest value), float32 to 2e-5 of it (the JAX parity tests'
tolerance), and bfloat16 by ``test_torch_bf16.py``'s rule against the
oracle's own distance from float32. Besides the values, a dispatch
recorder holds the mechanism: a plain force evaluation and a training
gradient concatenate no tensor as large as an activation, and the forward
copies one only into and out of the attention core.

Nothing here imports JAX. The ``cuda`` tests need the card (``python -m
pytest tests/test_torch_copy_free_network.py -m cuda --noconftest``).
"""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.models.graph_transformer import (
    GraphTransformer,
    _cast,
    dense,
    init_params,
    score_forward,
)
from twoforone_torch.ops.attention import geometric_edge_attention_packed
from twoforone_torch.ops.geometry import center_zero
from twoforone_torch.utils.convert import params_from_jax

BF16 = torch.bfloat16
EDGE_CONFIGS = {  # (use_intrinsic_coords, use_distances)
    "diff": (True, False),
    "dist": (False, True),
    "both": (True, True),
    "neither": (False, False),
}
VILLIN = dict(n=35, nf=128)
LAYERS = 3
CHIGNOLIN = dict(n=10, nf=64)
PRODUCTION = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)


# ---------------------------------------------------------------- oracles
def old_gated_residual(mod, x, res):
    gate = torch.sigmoid(dense(mod.proj, torch.cat([x, res, x - res], dim=-1), mod.dtype))
    return x * gate + res * (1.0 - gate)


def old_node_input(model, x, t):
    """The embedded node features [one-hot, x?, t]; x in the compute dtype."""
    b, n, _ = x.shape
    onehot = torch.eye(n, dtype=x.dtype, device=x.device).expand(b, n, n)
    t_feat = t.to(x.dtype).reshape(b, 1, 1).expand(b, n, 1)
    feats = [onehot, x, t_feat] if model.use_abs_coords else [onehot, t_feat]
    return dense(model.node_embedding, torch.cat(feats, dim=-1), model.dtype)


def old_packed_attention(q, k, v, x, k_diff, k_dist, b_comb, scale):
    """The edge terms packed into one Q·K^T and one attn·V contraction as
    extra channels of q, k and v (B, N, H, dh)."""
    b_, n, h, dh = q.shape
    has_diff = k_diff is not None
    has_dist = k_dist is not None
    qs = q * scale
    parts_q, parts_k, parts_v = [qs], [k], [v]
    if has_diff or has_dist:
        xh = x[:, :, None, :].expand(b_, n, h, 3).to(q.dtype)
        parts_k.append(xh)
        parts_v.append(xh)
        xcoef = None
        if has_diff:
            xcoef = torch.einsum("bihd,chd->bihc", qs, k_diff)
        if has_dist:
            q_ks = torch.einsum("bihd,hd->bih", qs, k_dist)
            gram_coef = -2.0 * q_ks[..., None] * x[:, :, None, :].to(q.dtype)
            xcoef = gram_coef if xcoef is None else xcoef + gram_coef
        parts_q.append(xcoef)
    if has_dist:
        sq = torch.sum(x * x, dim=-1).to(q.dtype)
        sqh = sq[:, :, None, None].expand(b_, n, h, 1)
        parts_k.append(sqh)
        parts_v.append(sqh)
        parts_q.append(q_ks[..., None])
    qt = torch.cat(parts_q, dim=-1)
    kt = torch.cat(parts_k, dim=-1)
    vt = torch.cat(parts_v, dim=-1)
    attn = torch.softmax(torch.einsum("bihe,bjhe->bhij", qt, kt), dim=-1)
    ot = torch.einsum("bhij,bjhe->bihe", attn, vt)
    out = ot[..., :dh] + b_comb[None, None]
    idx = dh
    if has_diff or has_dist:
        xbar = ot[..., idx: idx + 3]
        idx += 3
    if has_diff:
        out = out + torch.einsum("bihc,chd->bihd", xbar - x[:, :, None, :].to(q.dtype), k_diff)
    if has_dist:
        sqbar = ot[..., idx]
        fdist = sqbar + sq[:, :, None] - 2.0 * torch.sum(x[:, :, None, :].to(q.dtype) * xbar, -1)
        out = out + fdist[..., None] * k_dist[None, None]
    return out


def old_attention(mod, nodes, x, model):
    """The geometric attention block with q, k, v in the JAX layout."""
    b, n, _ = nodes.shape
    h, dh, dt = mod.heads, mod.dim_head, mod.dtype
    q = dense(mod.to_q, nodes, dt).view(b, n, h, dh)
    k, v = dense(mod.to_kv, nodes, dt).chunk(2, dim=-1)
    w_e = _cast(mod.edges_to_kv.weight.t(), dt)
    k_comb = (_cast(model.edge_embedding.weight.t(), dt) @ w_e).view(-1, h, dh)
    b_comb = (_cast(model.edge_embedding.bias, dt) @ w_e + _cast(mod.edges_to_kv.bias, dt))
    has_diff, has_dist = model.use_intrinsic_coords, model.use_distances
    out = old_packed_attention(
        q, k.reshape(b, n, h, dh), v.reshape(b, n, h, dh), x,
        k_comb[:3] if has_diff else None,
        k_comb[3 if has_diff else 0] if has_dist else None,
        b_comb.view(h, dh), dh**-0.5)
    return dense(mod.to_out, out.reshape(b, n, h * dh), dt)


def old_energy(model, x, t):
    """Per-node energies of the network built from the replaced formulas."""
    dt = model.dtype
    x = _cast(x, dt)
    nodes = old_node_input(model, x, t)
    edges = None
    if not model.use_geometric_edges:
        w_emb = model.edge_embedding
        edges = model.edge_features(x) @ _cast(w_emb.weight.t(), dt) + _cast(w_emb.bias, dt)
    f32 = torch.promote_types(x.dtype, torch.float32)
    for i in range(model.n_layers):
        layer = lambda name: getattr(model, f"layers_{i}_{name}")  # noqa: E731
        attn_in = layer("attn_norm")(nodes.to(f32))
        if edges is None:
            attn_out = old_attention(layer("attn"), attn_in, x, model)
        else:
            attn_out = layer("attn")(attn_in, edges=edges)
        nodes = old_gated_residual(layer("attn_res"), attn_out, nodes)
        ff_out = layer("ff")(layer("ff_norm")(nodes.to(f32)))
        nodes = old_gated_residual(layer("ff_res"), ff_out, nodes)
    out = dense(model.node_decoder, nodes, dt)
    return out if dt is None else out.float()


def old_score(model, x, t, create_graph=False):
    """``score_forward`` of the replaced network: -dE/dx at the centred x."""
    with torch.enable_grad():
        xc = center_zero(x) if create_graph else center_zero(x).detach()
        if not xc.requires_grad:
            xc.requires_grad_(True)
        energy = old_energy(model, xc, t).sum()
        (grad,) = torch.autograd.grad(energy, xc, create_graph=create_graph, allow_unused=True)
    return torch.zeros_like(x) if grad is None else -grad


# ---------------------------------------------------------------- helpers
def _model(n=5, nf=16, layers=2, seed=1, dtype=torch.float32, **kw):
    model = GraphTransformer(n, nf, layers, heads=2, dim_head=8, **kw)
    model.load_state_dict(params_from_jax(init_params(model, seed)))
    return model.to(dtype)


def _inputs(b, n, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, n, 3, generator=g, dtype=dtype), torch.rand(b, generator=g, dtype=dtype)


def _close(new, old, rel):
    scale = old.abs().max().item()
    assert (new - old).abs().max().item() <= rel * scale, ((new - old).abs().max().item(), scale)


def _bf16_rule(new16, old16, old32):
    """test_torch_bf16.py's rule, held against the oracle's bfloat16 result."""
    new16, old16, old32 = (a.double() for a in (new16, old16, old32))
    bound = 2.0 * (old16 - old32).abs().max() + 2.0**-8 * old32.abs().max()
    assert (new16 - old16).abs().max() <= bound
    assert (new16 - old32).abs().max() > 1e-4 * old32.abs().max()  # bfloat16 did act


REL = {torch.float64: 1e-12, torch.float32: 2e-5}


# ---------------------------------------------------------------- the forms
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, BF16])
def test_gated_residual_equals_the_concatenated_form(dtype):
    model = _model(dtype=torch.float64 if dtype == torch.float64 else torch.float32)
    g = torch.Generator().manual_seed(0)
    x, res = (torch.randn(6, 5, 16, generator=g, dtype=torch.float64) for _ in range(2))
    mod = model.layers_0_attn_res
    if dtype != BF16:
        x, res = x.to(dtype), res.to(dtype)
        _close(mod(x, res), old_gated_residual(mod, x, res), REL[dtype])
        return
    mod16 = model.with_dtype(BF16).layers_0_attn_res
    x16, res16 = x.to(BF16), res.to(BF16)
    new16 = mod16(x16, res16)
    assert new16.dtype == BF16
    _bf16_rule(new16, old_gated_residual(mod16, x16, res16),
               old_gated_residual(mod, x.float(), res.float()))


@pytest.mark.parametrize("abs_coords", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_node_input_equals_the_one_hot_product(dtype, abs_coords):
    """The network's first layer sees the old node input: the energy of a
    network whose layers are skipped is the decoded node input."""
    model = _model(layers=0, dtype=dtype, **dict(PRODUCTION, use_abs_coords=abs_coords))
    x, t = _inputs(4, 5, 3, dtype)
    _close(model(x, t, return_energy=True), dense(model.node_decoder, old_node_input(model, x, t),
                                                  None), REL[dtype])


@pytest.mark.parametrize("edges", sorted(EDGE_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_packed_attention_equals_the_concatenated_channels(edges, dtype):
    has_diff, has_dist = EDGE_CONFIGS[edges]
    g = torch.Generator().manual_seed(5)
    b, n, h, dh = 3, 6, 2, 8
    q, k, v = (torch.randn(b, n, h, dh, generator=g, dtype=dtype) for _ in range(3))
    x = torch.randn(b, n, 3, generator=g, dtype=dtype)
    k_diff = 0.3 * torch.randn(3, h, dh, generator=g, dtype=dtype) if has_diff else None
    k_dist = 0.1 * torch.randn(h, dh, generator=g, dtype=dtype) if has_dist else None
    b_comb = torch.randn(h, dh, generator=g, dtype=dtype)
    args = (q, k, v, x, k_diff, k_dist, b_comb, dh**-0.5)
    new = geometric_edge_attention_packed(*args)
    assert new.shape == (b, n, h, dh)
    _close(new, old_packed_attention(*args), REL[dtype])


def _config(edges, abs_coords, geometric):
    intrinsic, distances = EDGE_CONFIGS[edges]
    return dict(use_intrinsic_coords=intrinsic, use_distances=distances,
                use_abs_coords=abs_coords, use_geometric_edges=geometric)


ALL_CONFIGS = [(e, a, g) for e in sorted(EDGE_CONFIGS) for a in (False, True)
               for g in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("edges,abs_coords,geometric", ALL_CONFIGS)
def test_force_and_energy_equal_the_replaced_network(edges, abs_coords, geometric, dtype):
    model = _model(dtype=dtype, **_config(edges, abs_coords, geometric))
    x, t = _inputs(6, 5, 2, dtype)
    _close(model(center_zero(x), t, return_energy=True), old_energy(model, center_zero(x), t),
           REL[dtype])
    force = score_forward(model, x, t)
    if edges == "neither" and not abs_coords:
        assert not force.any()  # the energy does not depend on x
    else:
        _close(force, old_score(model, x, t), REL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("edges,abs_coords", [(e, a) for e in sorted(EDGE_CONFIGS)
                                              for a in (False, True)])
def test_training_gradients_equal_the_replaced_network(edges, abs_coords, dtype):
    """Gradients of a loss on the forces (the force's graph kept, as
    training keeps it) and on the energy, for every parameter, against the
    replaced network's in float64: in float64 within 1e-12 of the largest
    gradient; in float32 no farther than twice the replaced network's own
    float32 gradients, plus 1e-6 of the largest (second derivatives of the
    squared-distance configurations lose ~1e-5 of it to float32)."""

    def grads(dt, score, energy):
        model = _model(dtype=dt, **_config(edges, abs_coords, True))
        x, t = (a.to(dt) for a in _inputs(6, 5, 4))
        loss = (score(model, x, t, create_graph=True) ** 2).mean() + energy(
            model, center_zero(x), t).sum()
        names = [name for name, _ in model.named_parameters()]
        got = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        return {name: None if g is None else g.double() for name, g in zip(names, got)}

    new = grads(dtype, score_forward, lambda m, xc, tt: m(xc, tt, return_energy=True))
    ref = grads(torch.float64, old_score, old_energy)
    own = grads(torch.float32, old_score, old_energy) if dtype == torch.float32 else None
    scale = max(g.abs().max().item() for g in ref.values() if g is not None)
    for name, g in new.items():
        if g is None or ref[name] is None:
            assert g is None or not g.any(), name
            assert ref[name] is None or not ref[name].any(), name
            continue
        bound = 1e-12 * scale if own is None else (
            2.0 * (own[name] - ref[name]).abs().max().item() + 1e-6 * scale)
        assert (g - ref[name]).abs().max().item() <= bound, name


@pytest.mark.parametrize("edges,abs_coords,geometric", ALL_CONFIGS)
def test_bf16_network_holds_the_rule_against_the_replaced_one(edges, abs_coords, geometric):
    model = _model(nf=32, **_config(edges, abs_coords, geometric))
    m16 = model.with_dtype(BF16)
    x, t = _inputs(8, 5, 2)
    energy = lambda m, f: f(m, center_zero(x), t)  # noqa: E731
    _bf16_rule(energy(m16, lambda m, xc, tt: m(xc, tt, return_energy=True)),
               energy(m16, old_energy), energy(model, old_energy))
    if edges != "neither" or abs_coords:
        _bf16_rule(score_forward(m16, x, t), old_score(m16, x, t), old_score(model, x, t))


# ---------------------------------------------------------------- the mechanism
CONCATENATIONS = {"cat", "stack"}
COPIES = {"clone", "copy_"}
ZERO_FILLED = {"slice_backward", "select_backward"}  # a slice's gradient in a zeroed whole


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        size = out.numel() if isinstance(out, torch.Tensor) else 0
        self.ops.append((func.overloadpacket.__name__, size))
        return out


def _activation_ops(run, rows, n, nf):
    """Counts of the concatenations, copies and zero-filled slice gradients
    of ``run(rows)`` on a tensor as large as an activation (rows·N·C
    elements or more) whose size grows with the rows, found by recording the
    run at ``rows`` and at twice as many."""
    recorded = []
    for b in (rows, 2 * rows):
        with _Recorder() as rec:
            run(b)
        recorded.append(rec.ops)
    assert [op for op, _ in recorded[0]] == [op for op, _ in recorded[1]]
    return Counter(op for (op, size), (_, size2) in zip(*recorded)
                   if op in CONCATENATIONS | COPIES | ZERO_FILLED
                   and size >= rows * n * nf and size2 > size)


def _villin_model():
    model = GraphTransformer(VILLIN["n"], VILLIN["nf"], LAYERS, **PRODUCTION)
    model.load_state_dict(params_from_jax(init_params(model, 0)))
    return model


def test_a_plain_network_forward_copies_activations_only_into_and_out_of_the_core():
    """Villin's widths (35 beads, nf 128, 3 layers, 8 x 64 heads), 4 chains:
    the forward copies an activation four times a layer, q, k and v into
    the attention core's head-major batches and its output back, and
    concatenates none."""
    model = _villin_model()

    def run(b):
        x, t = _inputs(b, VILLIN["n"], 0)
        model(center_zero(x), t, return_energy=True)

    assert _activation_ops(run, 4, VILLIN["n"], VILLIN["nf"]) == Counter(clone=4 * LAYERS)


def test_a_plain_force_evaluation_concatenates_no_activation():
    """The same network's force (forward and autograd backward): no
    concatenation and no zero-filled slice gradient of an activation, and
    the backward copies no more than the forward (the layout changes'
    mirror)."""
    model = _villin_model()

    def run(b):
        x, t = _inputs(b, VILLIN["n"], 0)
        score_forward(model, x, t)

    assert _activation_ops(run, 4, VILLIN["n"], VILLIN["nf"]) <= Counter(clone=8 * LAYERS)


def test_a_training_gradient_concatenates_no_activation():
    """Chignolin's widths (10 beads, nf 64, 3 layers), 8 rows: the loss of
    ``net_loss`` with the force's graph kept, and its backward to the
    parameters, concatenate no activation and fill no zero gradient for a
    slice of one."""
    model = GraphTransformer(CHIGNOLIN["n"], CHIGNOLIN["nf"], LAYERS, **PRODUCTION)
    gd = GaussianDiffusion(model=model, num_atoms=CHIGNOLIN["n"], timesteps=1000,
                           norm_factor=1.6)
    model.load_state_dict(params_from_jax(init_params(model, 0)))

    def run(b):
        model.zero_grad(set_to_none=True)
        g = torch.Generator().manual_seed(b)
        mol = torch.randn(b, CHIGNOLIN["n"], 3, generator=g)
        noise = torch.randn(b, CHIGNOLIN["n"], 3, generator=g)
        t = torch.randint(0, 1000, (b,), generator=g)
        loss, _ = gd.net_loss(model, mol, t=t, noise=noise)
        loss.backward()

    found = _activation_ops(run, 8, CHIGNOLIN["n"], CHIGNOLIN["nf"])
    assert not set(found) & (CONCATENATIONS | ZERO_FILLED), found


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_villin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the float32 products of the card and its graphs)")
    from twoforone_torch.utils.artifacts import load_ema_params

    model = GraphTransformer(VILLIN["n"], VILLIN["nf"], LAYERS, **PRODUCTION)
    return model, load_ema_params("chain35")


@contextlib.contextmanager
def _no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
def test_the_plain_force_at_villins_widths_holds_on_the_card(cuda_villin):
    """The staged chain35 weights, 100 chains at t = 0.005 (villin's
    Langevin noise level): the float32 force on the card, TF32 off, within
    1e-5 of the largest force of the replaced network in float64."""
    model, params = cuda_villin
    model.load_state_dict(params_from_jax(params))
    x, t = _inputs(100, VILLIN["n"], 7)
    t = torch.full_like(t, 0.005)
    with _no_tf32():
        got = score_forward(model.cuda(), x.cuda(), t.cuda())
        ref = old_score(model.double(), x.double().cuda(), t.double().cuda())
    _close(got.double(), ref, 1e-5)


@pytest.mark.cuda
def test_graphed_and_eager_plain_langevin_steps_give_the_same_bits(cuda_villin):
    """``fused="never"`` at villin's widths, 100 chains, 20 steps saving each
    step's frame and force: the captured step and the eager one agree bit
    for bit."""
    from twoforone_torch.dynamics.langevin import LangevinDiffusion

    model, params = cuda_villin
    gd = GaussianDiffusion(model=model, num_atoms=VILLIN["n"], timesteps=1000,
                           norm_factor=6.0829)
    init = np.random.default_rng(3).normal(size=(100, VILLIN["n"], 3)).astype(np.float32)
    runs = []
    for graphed in (True, False):
        ld = LangevinDiffusion(gd, params, (init - init.mean(1, keepdims=True)) * 6.0829,
                               n_timesteps=20, save_interval=1, t=5, temp_data=360,
                               temp_sim=360, dt=2e-3, masses=[12.0] * VILLIN["n"],
                               friction=1.0, kb="consistent", random_seed=0, log=False,
                               fused="never", restraint_k=50.0, max_force=1e3, device="cuda")
        if not graphed:
            ld.sim._graphs = None
        ld.sim.save_forces = True
        with _no_tf32():
            frames = ld.sim.simulate(sub_interval=20)
        runs.append((frames, ld.sim.simulated_forces, ld.sim.state["x"], ld.sim.state["v"]))
    assert np.isfinite(runs[0][0]).all()
    for a, b in zip(*runs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
