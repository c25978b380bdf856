"""Port's profiling helpers and symmetry checkers, on the CPU.

- ``PhaseTimer`` counts and reports phases; ``trace`` writes a Chrome trace
  that names what ran, ``annotate`` a span in it.
- The checkers on analytic functions give the gaps the JAX package's
  checkers give: f(x) = x and f(x) = x with the x axis flipped have a
  translation gap of the shift (5.0) and the reflection gaps
  (2/3 mean |x_0|, 0): both commute with the reflection and neither is
  invariant under it. The random inputs differ between the packages (a key
  against a torch.Generator), so a gap that depends on them is held to its
  formula on each side's own draw, within 1e-6 relative.
- The symmetric-model test of the JAX package on the port's
  ``score_forward``, with the JAX initialisation's weights carried over by
  ``params_from_jax`` (the two forces agree on the same inputs): the same
  bars.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import twoforone_tpu.utils.equivariance as jeq
import twoforone_torch.utils.equivariance as teq
from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)
from twoforone_torch.utils.convert import params_from_jax
from twoforone_torch.utils.profiling import PhaseTimer, annotate, trace


def test_phase_timer_counts_and_report():
    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase("a"):
            time.sleep(0.002)
    with timer.phase("b"):
        time.sleep(0.02)
    with pytest.raises(RuntimeError):
        with timer.phase("c"):
            raise RuntimeError("a failing phase is still timed")
    assert timer.counts == {"a": 3, "b": 1, "c": 1}
    assert timer.totals["a"] >= 0.006 and timer.totals["b"] >= 0.02
    lines = timer.report().splitlines()
    assert len(lines) == 3 and lines[0].startswith("b: ") and "x1" in lines[0]
    assert any(ln.startswith("a: ") and ln.endswith("x3") for ln in lines)
    # no device to wait for here: sync is a no-op on the CPU
    PhaseTimer._block()


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")) as prof:
        with annotate("port_span"):
            (x @ x).sum()
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "port_span" in names and any("mm" in str(n) for n in names)
    assert any("mm" in a.key for a in prof.key_averages())


def _j(fn):
    return lambda x, t: fn(x)


def test_identity_gaps_equal_jax():
    shift = 5.0
    t_tr = teq.check_translation_invariance(lambda x, t: x, 5, batch=16, shift=shift)
    j_tr = jeq.check_translation_invariance(_j(lambda x: x), 5, batch=16, shift=shift)
    assert t_tr == pytest.approx(shift, abs=1e-6) and j_tr == pytest.approx(shift, abs=1e-6)
    assert teq.check_rotation_equivariance(lambda x, t: x, 5, batch=16) < 1e-6
    assert jeq.check_rotation_equivariance(_j(lambda x: x), 5, batch=16) < 1e-6
    t_inv, t_eq = teq.check_reflection_equivariance(lambda x, t: x, 5, batch=16)
    j_inv, j_eq = jeq.check_reflection_equivariance(_j(lambda x: x), 5, batch=16)
    assert t_eq == j_eq == 0.0
    # |x - x_reflected| is 2|x_0| on one of three axes: 2/3 mean |x_0|,
    # on each package's own draw
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((16, 5, 3), generator=gen)
    assert t_inv == pytest.approx(2 / 3 * x[..., 0].abs().mean().item(), rel=1e-6)
    jx = jax.random.normal(jax.random.PRNGKey(0), (16, 5, 3))
    assert j_inv == pytest.approx(2 / 3 * float(jnp.abs(jx[..., 0]).mean()), rel=1e-6)


def test_flipped_axis_gaps_equal_jax():
    """f(x) = x with the x axis flipped commutes with the x-axis reflection
    and is not invariant under it, as the identity: reflection gaps
    (2/3 mean |x_0|, 0). Translating by 5 moves f by 5 on every axis."""
    flip_t = torch.tensor([-1.0, 1.0, 1.0])
    flip_j = jnp.asarray([-1.0, 1.0, 1.0])
    t_inv, t_eq = teq.check_reflection_equivariance(lambda x, t: x * flip_t, 5, batch=16)
    j_inv, j_eq = jeq.check_reflection_equivariance(_j(lambda x: x * flip_j), 5, batch=16)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((16, 5, 3), generator=gen)
    jx = jax.random.normal(jax.random.PRNGKey(0), (16, 5, 3))
    assert t_inv == pytest.approx(2 / 3 * x[..., 0].abs().mean().item(), rel=1e-6)
    assert j_inv == pytest.approx(2 / 3 * float(jnp.abs(jx[..., 0]).mean()), rel=1e-6)
    assert t_eq == j_eq == 0.0
    t_tr = teq.check_translation_invariance(lambda x, t: x * flip_t, 5, batch=16)
    j_tr = jeq.check_translation_invariance(_j(lambda x: x * flip_j), 5, batch=16)
    assert t_tr == pytest.approx(5.0, abs=1e-6) and j_tr == pytest.approx(5.0, abs=1e-6)


def test_same_generator_seed_same_gap():
    """Two score functions are compared on the same inputs by giving each
    checker a generator with the same seed."""
    fn = lambda x, t: torch.tanh(x) * t[:, None, None]  # noqa: E731
    gaps = [teq.check_rotation_equivariance(fn, 6, torch.Generator().manual_seed(3), 32)
            for _ in range(2)]
    assert gaps[0] == gaps[1] > 0.0
    assert teq.check_rotation_equivariance(fn, 6, torch.Generator().manual_seed(4), 32) \
        != gaps[0]


def test_equivariance_checkers_on_symmetric_model():
    """The production edges (intrinsic coordinates, conservative) are
    translation-invariant; intrinsic-coordinate edges are not rotation
    invariant features, so the rotation gap is only finite; distance-only
    edges give an exactly rotation- and reflection-equivariant force. The
    port's gaps on the JAX initialisation's weights meet the JAX test's bars."""
    from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
    from twoforone_tpu.models.graph_transformer import make_score_fn
    from twoforone_torch.models.graph_transformer import GraphTransformer, score_forward

    def build(intrinsic):
        edges = dict(use_intrinsic_coords=intrinsic, use_abs_coords=False,
                     use_distances=not intrinsic)
        jm = JGT(num_beads=5, hidden_nf=16, n_layers=1, conservative=True, **edges)
        p = jax.jit(lambda key: jm.init(key, np.zeros((1, 5, 3), np.float32),
                                        np.zeros(1, np.float32), return_energy=True)["params"]
                    )(jax.random.PRNGKey(0))
        tm = GraphTransformer(5, 16, 1, conservative=True, **edges)
        tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, p)))
        return (lambda x, t: score_forward(tm, x, t)), jax.jit(make_score_fn(jm, p))

    fn, jfn = build(intrinsic=True)
    # the same weights give the same force on the same inputs
    x = np.random.default_rng(0).normal(size=(4, 5, 3)).astype(np.float32)
    t = np.full(4, 0.5, np.float32)
    np.testing.assert_allclose(fn(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy(),
                               np.asarray(jfn(jnp.asarray(x), jnp.asarray(t))), atol=1e-5)
    assert teq.check_translation_invariance(fn, 5, batch=16) < 1e-5
    assert np.isfinite(teq.check_rotation_equivariance(fn, 5, batch=16))
    inv_gap, eq_gap = teq.check_reflection_equivariance(fn, 5, batch=16)
    assert np.isfinite(inv_gap) and np.isfinite(eq_gap)

    fn_dist, _ = build(intrinsic=False)
    assert teq.check_rotation_equivariance(fn_dist, 5, batch=16) < 1e-4
    assert teq.check_reflection_equivariance(fn_dist, 5, batch=16)[1] < 1e-4
