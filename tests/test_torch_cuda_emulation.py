"""The CUDA sources, compiled with g++ and run on the CPU: the two
whole-force kernels and the attention core's forward and backward.

``tests/cuda_emulation/cuda_runtime.h`` stands in for the CUDA runtime
(threads of a block as OS threads, ``__syncthreads`` as a barrier, warp
operations through slot arrays, asynchronous copies as plain copies), so the
kernels' control flow, indexing,
tiling, staging ring and epilogues run here as they are written, at a tiny
size, against the plain PyTorch versions. What only the card can show
(that nvcc accepts the source, the PTX pieces, the speed) is left to
``chip_smoke.py``.

Scratch and shared memory are filled with NaN before a launch, so a read of
something the kernel never wrote shows up in the result. Tolerance 1e-5
relative to the largest force: the same float32 arithmetic in another
order.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from twoforone_torch.models.graph_transformer import GraphTransformer, init_params
from twoforone_torch.ops import attention_cl_core as acc
from twoforone_torch.ops import fused_score as fs
from twoforone_torch.ops import fused_score_cl as fcl
from twoforone_torch.ops.tile_plan import plan_at, plan_tiles

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "twoforone_torch", "ops", "csrc")
BUILD_TIMEOUT_S = 120
LAUNCH_TIMEOUT_S = 120
N, C, HEADS, DH = 5, 16, 2, 8


def build(name, tmp_path_factory):
    """libemu_<name>.so from csrc/<name>.cu, or a skip where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to emulate the CUDA sources")
    so = str(tmp_path_factory.mktemp("emu") / f"libemu_{name}.so")
    cmd = [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", "-x", "c++",
           "-I", os.path.join(HERE, "cuda_emulation"), "-I", CSRC, "-o", so,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(so)  # for the size formulas; launches run in a child process
    lib.path = so
    return lib


def launch(lib, fn_name, x, w, t, plan, dims, tmp_path, clustered=False, card=(8, 0), rc=0):
    """One emulated launch (tests/cuda_emulation/launch.py) under a time limit;
    ``clustered``: the launch takes the plan's cluster size (K1's). The
    emulated card has card[0] SMs of card[1] blocks each (0: as many as fit),
    which bound the clusters it keeps resident; ``rc`` is the launch's code."""
    head = [x.shape[0], plan.chains_per_tile, plan.row_blocks, plan.blocks]
    ints = head + [plan.cluster] * clustered + [plan.scratch_floats, plan.smem_bytes, *dims]
    kinds = "i" * (len(head) + clustered) + "qi" + "i" * len(dims)
    src, dst = str(tmp_path / "in.npz"), str(tmp_path / "out.npy")
    np.savez(src, x=x, w=w, t=np.float32(t), ints=np.asarray(ints, np.int64), kinds=kinds,
             scratch=plan.groups * plan.scratch_floats)
    env = dict(os.environ, EMU_SM_COUNT=str(card[0]))
    env.pop("EMU_BLOCKS_PER_SM", None)
    if card[1]:
        env["EMU_BLOCKS_PER_SM"] = str(card[1])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "cuda_emulation", "launch.py"), lib.path, fn_name,
         src, dst], capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S, env=env)
    assert proc.returncode == rc, f"launch returned {proc.returncode}: {proc.stderr[-2000:]}"
    return np.load(dst) if rc == 0 else None


def model_of(layers, heads=HEADS, dh=DH, **edges):
    return GraphTransformer(N, C, layers, heads=heads, dim_head=dh, **edges)


def coords(seed, chains):
    return np.random.default_rng(seed).normal(size=(chains, N, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def lib_cl(tmp_path_factory):
    lib = build("fused_score_cl", tmp_path_factory)
    for fn in (lib.fused_force_cl_weight_floats, lib.fused_force_cl_scratch_floats,
               lib.fused_force_cl_smem_bytes):
        fn.restype = ctypes.c_longlong
    return lib


def run_cl(lib, folded, x, t, plan, tmp_path, **card):
    dims = (folded.n, folded.c, folded.heads, folded.dh, folded.ff, folded.n_layers)
    w = folded.flat.numpy()
    assert lib.fused_force_cl_weight_floats(*dims) == w.size
    assert lib.fused_force_cl_scratch_floats(
        *dims, plan.chains_per_tile, plan.row_blocks) == plan.scratch_floats
    assert lib.fused_force_cl_smem_bytes(
        *dims, plan.chains_per_tile, plan.row_blocks) == plan.smem_bytes
    return launch(lib, "fused_force_cl_launch", x, w, t, plan, dims, tmp_path, clustered=True,
                  **card)


def cl_plan(per_tile, chains, ff, heads, groups, cluster=1, dh=DH):
    """K1's plan at a tile size, on at most ``groups`` blocks or clusters."""
    plan = plan_at(per_tile, chains, N, C, heads, dh, ff, 2, sm_count=8, cluster=cluster)
    return dataclasses.replace(plan, blocks=cluster * min(plan.groups, groups))


# (chains, chains per tile, thread blocks or clusters, blocks of a cluster,
# heads, t[, head width]): a full tile and a ragged one on one block that walks over both;
# tiles of one chain; one tile of three chains in 16 rows with one row of
# padding; a tile of four chains in 32 rows and a ragged one after it; the
# widest tile, sixteen chains in 80 rows (where the products lay their
# threads out differently), and a ragged one after it. Then tiles shared by
# clusters of 1, 2 and 4 blocks, at a fixed t (Langevin's) and a runtime one
# (the sampler's): tiles of one chain, one cluster a tile and one cluster
# walking over three; tiles of 32 and 80 rows, a full one and a ragged one;
# chignolin's 8 heads of 64, whose shares of 256 and 768 columns take the
# 256-column shape of a share.
CL_CASES = [(3, 2, 1, 1, HEADS, 0.3), (2, 1, 2, 1, HEADS, 0.3), (3, 3, 1, 1, HEADS, 0.3),
            (5, 4, 1, 1, HEADS, 0.3), (17, 16, 1, 1, HEADS, 0.3)] + [
    (3, 1, groups, cluster, 4, t) for t in (0.02, 0.71) for cluster in (1, 2, 4)
    for groups in (3, 1)] + [(5, 4, 1, 2, 4, 0.71), (17, 16, 1, 4, 4, 0.02),
                             (2, 1, 2, 2, 8, 0.02, 64)]


@pytest.mark.parametrize("chains,per_tile,blocks,cluster,heads,t,dh",
                         [case + (DH,) * (7 - len(case)) for case in CL_CASES])
def test_fused_score_cl_source_matches_plain_version(lib_cl, tmp_path, chains, per_tile, blocks,
                                                     cluster, heads, t, dh):
    model = model_of(2, heads, dh, use_intrinsic_coords=True, use_abs_coords=False,
                     use_distances=False)
    folded = fcl.augment_params_cl(model, init_params(model, 3), "cpu")
    x = coords(chains, chains)
    plan = cl_plan(per_tile, chains, folded.ff, heads, blocks, cluster, dh)
    assert plan.cluster == cluster and plan.groups == min(blocks, plan.tiles)
    out = run_cl(lib_cl, folded, x, t, plan, tmp_path)
    ref = fcl.fused_force_cl_reference(torch.from_numpy(x), t, folded).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    if cluster > 1:
        # The blocks of a cluster give the bits of one block alone.
        one = cl_plan(per_tile, chains, folded.ff, heads, blocks, dh=dh)
        np.testing.assert_array_equal(run_cl(lib_cl, folded, x, t, one, tmp_path), out)
    if per_tile > 1:
        # A chain's result has the same bits alone as beside its tile-mates.
        alone = plan_tiles(1, N, C, heads, dh, folded.ff, 2, sm_count=1)
        np.testing.assert_array_equal(run_cl(lib_cl, folded, x[:1], t, alone, tmp_path),
                                      out[:1])


def test_fused_score_cl_source_refuses_clusters_the_card_cannot_hold(lib_cl, tmp_path):
    """Three clusters of two blocks on an emulated card of one SM that holds
    two blocks (one such cluster resident): the launch is refused, and the
    library says how many it keeps; a cluster size the plan never takes, or
    one that does not divide the heads, is refused too."""
    edges = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
    model = model_of(2, 4, **edges)
    folded = fcl.augment_params_cl(model, init_params(model, 3), "cpu")
    x = coords(5, 3)
    plan = cl_plan(1, 3, folded.ff, 4, 3, 2)
    assert plan.groups == 3
    run_cl(lib_cl, folded, x, 0.3, plan, tmp_path, card=(1, 2), rc=1)
    run_cl(lib_cl, folded, x, 0.3, plan, tmp_path, card=(3, 2))
    for cluster in (3, 8):
        run_cl(lib_cl, folded, x, 0.3, dataclasses.replace(plan, cluster=cluster,
                                                           blocks=3 * cluster), tmp_path, rc=1)
    two_heads = fcl.augment_params_cl(model_of(2, **edges), init_params(model_of(2, **edges), 3),
                                      "cpu")
    plan = dataclasses.replace(cl_plan(1, 3, two_heads.ff, 2, 1), cluster=4, blocks=4)
    run_cl(lib_cl, two_heads, x, 0.3, plan, tmp_path, rc=1)


@pytest.fixture(scope="module")
def lib_packed(tmp_path_factory):
    lib = build("fused_score", tmp_path_factory)
    for fn in (lib.fused_force_weight_floats, lib.fused_force_scratch_floats,
               lib.fused_force_smem_bytes):
        fn.restype = ctypes.c_longlong
    return lib


def run_packed(lib, folded, x, t, plan, tmp_path):
    dims = (folded.n, folded.c, folded.heads, folded.dh, folded.ff, folded.n_layers,
            int(folded.intrinsic), int(folded.distances), int(folded.abs_coords))
    w = folded.flat.numpy()
    assert lib.fused_force_weight_floats(*dims) == w.size
    assert lib.fused_force_scratch_floats(
        *dims, plan.chains_per_tile, plan.row_blocks) == plan.scratch_floats
    assert lib.fused_force_smem_bytes(
        *dims, plan.chains_per_tile, plan.row_blocks) == plan.smem_bytes
    return launch(lib, "fused_force_launch", x, w, t, plan, dims, tmp_path)


EDGE_CASES = [(intrinsic, distances, abs_coords) for intrinsic in (True, False)
              for distances in (True, False) for abs_coords in (True, False)]


@pytest.mark.parametrize("per_tile", [2, 4])
@pytest.mark.parametrize("intrinsic,distances,abs_coords", EDGE_CASES)
def test_fused_score_source_matches_plain_version(lib_packed, tmp_path, intrinsic, distances,
                                                  abs_coords, per_tile):
    """Tiles of two chains (16 rows) or of four (32 rows) on one thread block,
    a full tile, then a ragged one; one layer, every edge configuration. Against the plain
    version in float64: with squared distances on seeded weights the scores
    are large and float32 loses digits in either version (see chip_smoke.py's
    TOL_F32_FACTOR), so the bound is the larger of 1e-5 and 4 x the float32
    plain version's own distance."""
    model = model_of(1, use_intrinsic_coords=intrinsic, use_distances=distances,
                     use_abs_coords=abs_coords)
    params = init_params(model, 5)
    folded = fs.augment_params(model, params, "cpu")
    folded64 = fs.augment_params(model, params, "cpu", dtype=torch.float64)
    x = coords(11, per_tile + 1)
    plan = plan_at(per_tile, per_tile + 1, N, C, HEADS, DH, folded.ff, 1, sm_count=1,
                   distances=distances)
    plan = dataclasses.replace(plan, blocks=1)
    out = run_packed(lib_packed, folded, x, 0.3, plan, tmp_path)
    ref64 = fs.fused_force_reference(torch.from_numpy(x).double(), 0.3, folded64).numpy()
    ref32 = fs.fused_force_reference(torch.from_numpy(x), 0.3, folded).numpy()
    assert np.isfinite(out).all()
    scale = np.abs(ref64).max()
    if scale == 0.0:  # no edge features and no absolute coordinates: no force
        assert np.abs(out).max() == 0.0
        return
    tol = max(1e-5 * scale, 4.0 * np.abs(ref32 - ref64).max())
    np.testing.assert_allclose(out, ref64, atol=tol, rtol=0)


@pytest.fixture(scope="module")
def lib_core(tmp_path_factory):
    return build("attention_cl_core", tmp_path_factory)


def run_core(lib, which, arrays, sms, tmp_path):
    """One emulated launch of the forward or backward kernel
    (tests/cuda_emulation/launch_core.py) under a time limit, on an emulated
    card of ``sms`` SMs that hold one block each (0: the shim's own card, two
    SMs filled as far as threads and shared memory allow): its outputs in the
    order of the wrapper's results."""
    src, dst = str(tmp_path / f"{which}_in.npz"), str(tmp_path / f"{which}_out.npz")
    np.savez(src, **arrays)
    env = dict(os.environ)
    for name in ("EMU_SM_COUNT", "EMU_BLOCKS_PER_SM"):
        env.pop(name, None)
    if sms:
        env.update(EMU_SM_COUNT=str(sms), EMU_BLOCKS_PER_SM="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "cuda_emulation", "launch_core.py"), lib.path, which,
         src, dst], capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S, env=env)
    assert proc.returncode == 0, f"launch returned {proc.returncode}: {proc.stderr[-2000:]}"
    got = np.load(dst)
    names = ("out", "fdiff") if which == "fwd" else ("dq", "dk", "dv", "dx", "dqb", "dqkd")
    return [got[name] for name in names]


def core_inputs(b, n, heads, dh, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return dict(q=f(b, n, heads, dh), k=f(b, n, heads, dh), v=f(b, n, heads, dh), x=f(b, n, 3),
                qb=f(b, heads, n), qkd=0.3 * f(b, heads, n, 3), dout=f(b, n, heads, dh),
                dfd=f(b, heads, n, 3))


# (N, H, dh, chains, SMs of one block each): one bead; ragged unit counts over
# persistent grids of 1-3 blocks (the forward walks chains x heads units, the
# backward chains); the shim's own card (two SMs, as many blocks as fit); dh
# not a multiple of 4 (4-byte copies, zero-padded columns); the largest N and
# dh.
CORE_CASES = [(1, 2, 8, 3, 2), (3, 1, 8, 1, 1), (11, 2, 8, 3, 2), (20, 8, 64, 3, 2),
              (20, 2, 64, 5, 3), (11, 8, 64, 5, 0), (3, 2, 6, 3, 2), (32, 1, 64, 2, 1)]


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("n,heads,dh,chains,sms", CORE_CASES)
def test_attention_core_source_matches_plain_version(lib_core, tmp_path, which, n, heads, dh,
                                                     chains, sms):
    """Against cl_attention_reference / cl_attention_bwd_reference (dx summed
    over heads on both sides), 1e-5 of each output's largest entry: the same
    float32 arithmetic in another order (dqb, zero in exact arithmetic since a
    softmax row sums to 1, against dqkd's scale). Two launches give the same
    bits, and the first chain alone gives the bits it gets inside the batch."""
    arrays = core_inputs(chains, n, heads, dh, seed=100 * n + 10 * heads + dh)
    names = ("q", "k", "v", "x", "qb", "qkd") + (("dout", "dfd") if which == "bwd" else ())
    arrays = {name: arrays[name] for name in names}
    got = run_core(lib_core, which, arrays, sms, tmp_path)
    ins = [torch.from_numpy(arrays[name]) for name in names]
    ref = [r.numpy() for r in (acc.cl_attention_reference(*ins) if which == "fwd"
                               else acc.cl_attention_bwd_reference(*ins))]
    scales = [np.abs(r).max() for r in ref]
    if which == "bwd":
        scales[4] = scales[5]
    for out, r, scale in zip(got, ref, scales):
        assert out.shape == r.shape and np.isfinite(out).all()
        np.testing.assert_allclose(out, r, atol=1e-5 * scale, rtol=0)
    again = run_core(lib_core, which, arrays, sms, tmp_path)
    alone = run_core(lib_core, which, {k: a[:1] for k, a in arrays.items()}, sms, tmp_path)
    for out, rep, one in zip(got, again, alone):
        np.testing.assert_array_equal(rep, out)
        np.testing.assert_array_equal(one, out[:1])
