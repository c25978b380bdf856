"""The port's import surface against the JAX package's.

- Every name a JAX ``__init__.py`` re-exports (read from its source with
  ``ast``) imports from the port's counterpart, and from the port's own
  modules; ``TrainState`` is the one exception (the port's ``Trainer``
  holds its modules, optimizer and step itself). The versions agree.
- The four public names added for it, each against the JAX function on the
  same numpy-seeded inputs: ``make_score_fn`` on the staged chain10 weights
  at ``score_forward``'s tolerance (2e-5 of the largest force,
  ``test_torch_model.py``); ``edge_biased_attention_naive`` at 1e-5 of the
  largest |output| (float32 sums of at most N*dh products);
  ``assert_center_zero`` (the same verdict and message);
  ``GaussianDiffusion.init_params`` (the same tree of keys, shapes and dtypes:
  the generators differ, so the values are not compared).
- ``shard_batch`` runs on the card by default, as every entry point does.
"""

import ast
import glob
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
from twoforone_tpu.models.graph_transformer import make_score_fn as jmake_score_fn
from twoforone_tpu.ops import attention as jattn
from twoforone_tpu.ops.geometry import assert_center_zero as jassert_center_zero
from twoforone_tpu.utils.artifacts import load_ema_params as jload
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.models.graph_transformer import GraphTransformer, make_score_fn
from twoforone_torch.ops import attention as tattn
from twoforone_torch.ops.geometry import assert_center_zero
from twoforone_torch.parallel.mesh import Mesh, shard_batch
from twoforone_torch.utils.artifacts import load_ema_params
from twoforone_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_INITS = sorted(os.path.relpath(p, REPO) for p in
                   glob.glob(os.path.join(REPO, "twoforone_tpu", "**", "__init__.py"),
                             recursive=True))
NOT_PORTED = {"TrainState"}


def public_names(path):
    """The names a module's source binds at its top level: imports, defs,
    classes and assignments; private names (one leading underscore) left out."""
    names = set()
    for node in ast.parse(open(os.path.join(REPO, path)).read()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not (n.startswith("_") and not n.startswith("__"))}


def test_every_jax_package_init_is_read():
    assert len(JAX_INITS) == 11
    assert "twoforone_tpu/__init__.py" in JAX_INITS


@pytest.mark.parametrize("path", JAX_INITS)
def test_port_reexports_the_jax_package_names(path):
    """Each name of the JAX ``__init__.py`` imports from the port's package
    of the same path, and a function or class among them is the port's own."""
    module = importlib.import_module(
        os.path.dirname(path).replace(os.sep, ".").replace("twoforone_tpu", "twoforone_torch"))
    for name in sorted(public_names(path) - NOT_PORTED):
        assert hasattr(module, name), f"{module.__name__} lacks {name}"
        owner = getattr(getattr(module, name), "__module__", None)
        if callable(getattr(module, name)) and owner is not None:
            assert owner.startswith("twoforone_torch"), f"{name} comes from {owner}"


def test_version_matches_the_jax_package():
    import twoforone_torch

    tree = ast.parse(open(os.path.join(REPO, "twoforone_tpu", "__init__.py")).read())
    (version,) = [node.value.value for node in tree.body if isinstance(node, ast.Assign)
                  and [t.id for t in node.targets] == ["__version__"]]
    assert twoforone_torch.__version__ == version
    from twoforone_torch import GaussianDiffusion as G, get_model  # noqa: F401

    assert G is GaussianDiffusion


def test_make_score_fn_matches_jax_on_chain10():
    """The closure over the staged chain10 weights at chignolin width against
    the JAX closure (jitted), 16 states at t = 0.02 and 0.5."""
    from __graft_entry__ import _flagship

    jmodel, gd = _flagship()
    ref_fn = jax.jit(jmake_score_fn(jmodel, jload(gd, "chain10")))
    model = GraphTransformer(10, 64, 3, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fn = make_score_fn(model, load_ema_params("chain10"), device="cpu")
    # the closure loads the weights into a copy: the caller's module keeps its own
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    x = np.random.default_rng(11).normal(size=(16, 10, 3)).astype(np.float32)
    for t_norm in (0.02, 0.5):
        t = np.full((16,), t_norm, np.float32)
        ref = np.asarray(ref_fn(jnp.asarray(x), jnp.asarray(t)))
        out = fn(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


def test_make_score_fn_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GraphTransformer(5, 8, 1, heads=2, dim_head=4)
    params = GaussianDiffusion(model=model, num_atoms=5).init_params(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_score_fn(model, params)
    out = make_score_fn(model, params, device="cpu")(torch.zeros(2, 5, 3), torch.zeros(2))
    assert out.shape == (2, 5, 3)


@pytest.mark.parametrize("b,n,h,dh,de", [(3, 6, 2, 8, 4), (2, 10, 8, 16, 64)])
def test_edge_biased_attention_naive_matches_jax(b, n, h, dh, de):
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(b, n, h, dh)).astype(np.float32) for _ in range(3))
    edges = rng.normal(size=(b, n, n, de)).astype(np.float32)
    w_e = (rng.normal(size=(de, h, dh)) * de**-0.5).astype(np.float32)
    b_e = rng.normal(size=(h, dh)).astype(np.float32)
    scale = dh**-0.5
    args = (q, k, v, edges, w_e, b_e)
    ref = np.asarray(jattn.edge_biased_attention_naive(*map(jnp.asarray, args), scale))
    out = tattn.edge_biased_attention_naive(*map(torch.from_numpy, args), scale).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    # the oracle and the factored form compute the same function
    fact = tattn.edge_biased_attention(*map(torch.from_numpy, args), scale).numpy()
    np.testing.assert_allclose(fact, out, atol=1e-5 * np.abs(out).max(), rtol=0)


def test_assert_center_zero_matches_jax():
    """Centred input passes both; input off centre by 2e-3 fails both with
    the same message; a wrong last axis fails both."""
    x = np.random.default_rng(2).normal(size=(4, 7, 3)).astype(np.float32)
    x -= x.mean(axis=-2, keepdims=True)
    for arg in (torch.from_numpy(x), x):
        assert assert_center_zero(arg) is None
    assert jassert_center_zero(x) is None
    off = x.copy()
    off[1] += np.float32(2e-3)
    with pytest.raises(AssertionError) as ref:
        jassert_center_zero(off)
    with pytest.raises(AssertionError) as got:
        assert_center_zero(torch.from_numpy(off))
    assert str(got.value) == str(ref.value) and str(ref.value).startswith("Center not at zero")
    for check in (jassert_center_zero, assert_center_zero):
        with pytest.raises(AssertionError, match="Dimensionality error"):
            check(np.zeros((4, 7, 2), np.float32))


@pytest.mark.parametrize("conservative", [True, False])
@pytest.mark.parametrize("intrinsic,distances,abs_coords",
                         [(True, False, False), (False, True, True)])
def test_gaussian_diffusion_init_params_tree_matches_jax(intrinsic, distances, abs_coords,
                                                         conservative):
    kw = dict(use_intrinsic_coords=intrinsic, use_distances=distances,
              use_abs_coords=abs_coords, conservative=conservative)
    jgd = JGD(model=JGT(num_beads=6, hidden_nf=16, n_layers=2, heads=2, dim_head=8, **kw),
              num_atoms=6)
    ref = jax.eval_shape(jgd.init_params, jax.random.PRNGKey(0))
    gd = GaussianDiffusion(model=GraphTransformer(6, 16, 2, heads=2, dim_head=8, **kw),
                           num_atoms=6)
    got = gd.init_params(0)
    leaves = lambda tree: {jax.tree_util.keystr(k): (v.shape, np.dtype(v.dtype))
                           for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert leaves(got) == leaves(ref)
    assert leaves(gd.init_params(1)) == leaves(got)
    gd.model.load_state_dict(params_from_jax(got))


def test_shard_batch_defaults_to_the_card(monkeypatch):
    """Without a mesh the batch goes to ``device``, CUDA by default, which
    raises where CUDA is absent; ``device="cpu"`` gives float32 on the host;
    with a mesh it goes to the mesh's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = np.arange(24, dtype=np.float64).reshape(2, 4, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shard_batch(batch)
    out = shard_batch(batch, device="cpu")
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), batch.astype(np.float32))
    meshed = shard_batch(batch, Mesh(1, 0, torch.device("cpu")))
    assert meshed.device.type == "cpu" and torch.equal(meshed, out)
