"""The whole-force CUDA sources, compiled with g++ and run on the CPU.

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


def launch(lib, fn_name, x, w, t, plan, dims, tmp_path):
    """One emulated launch (tests/cuda_emulation/launch.py) under a time limit."""
    ints = [x.shape[0], plan.chains_per_tile, plan.row_blocks, plan.blocks, plan.scratch_floats,
            plan.smem_bytes, *dims]
    src, dst = str(tmp_path / "in.npz"), str(tmp_path / "out.npy")
    np.savez(src, x=x, w=w, t=np.float32(t), ints=np.asarray(ints, np.int64))
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "cuda_emulation", "launch.py"), lib.path, fn_name,
         src, dst], capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, f"launch returned {proc.returncode}: {proc.stderr[-2000:]}"
    return np.load(dst)


def model_of(layers, **edges):
    return GraphTransformer(N, C, layers, heads=HEADS, dim_head=DH, **edges)


def coords(seed, chains):
    return np.random.default_rng(seed).normal(size=(chains, N, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def lib_cl(tmp_path_factory):
    lib = build("fused_score_cl", tmp_path_factory)
    for fn in (lib.fused_force_cl_weight_floats, lib.fused_force_cl_scratch_floats,
               lib.fused_force_cl_smem_bytes):
        fn.restype = ctypes.c_longlong
    return lib


def run_cl(lib, folded, x, t, plan, tmp_path):
    dims = (folded.n, folded.c, folded.heads, folded.dh, folded.ff, folded.n_layers)
    w = folded.flat.numpy()
    assert lib.fused_force_cl_weight_floats(*dims) == w.size
    assert lib.fused_force_cl_scratch_floats(
        *dims, plan.chains_per_tile, plan.row_blocks) == plan.scratch_floats
    assert lib.fused_force_cl_smem_bytes(
        *dims, plan.chains_per_tile, plan.row_blocks) == plan.smem_bytes
    return launch(lib, "fused_force_cl_launch", x, w, t, plan, dims, tmp_path)


# (chains, chains per tile, thread blocks): a full tile and a ragged one on
# one block that walks over both; tiles of one chain; one tile of three
# chains in 16 rows with one row of padding; a tile of four chains in 32 rows
# and a ragged one after it; the widest tile, sixteen chains in 80 rows (where
# the products lay their threads out differently), and a ragged one after it.
CL_CASES = [(3, 2, 1), (2, 1, 2), (3, 3, 1), (5, 4, 1), (17, 16, 1)]


@pytest.mark.parametrize("chains,per_tile,blocks", CL_CASES)
def test_fused_score_cl_source_matches_plain_version(lib_cl, tmp_path, chains, per_tile, blocks):
    model = model_of(2, use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
    folded = fcl.augment_params_cl(model, init_params(model, 3), "cpu")
    x = coords(chains, chains)
    plan = plan_at(per_tile, chains, N, C, HEADS, DH, folded.ff, 2, sm_count=blocks)
    plan = dataclasses.replace(plan, blocks=min(plan.blocks, blocks))
    out = run_cl(lib_cl, folded, x, 0.3, plan, tmp_path)
    ref = fcl.fused_force_cl_reference(torch.from_numpy(x), 0.3, folded).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    if per_tile > 1:
        # A chain's result has the same bits alone as beside its tile-mates.
        alone = plan_tiles(1, N, C, HEADS, DH, folded.ff, 2, sm_count=1)
        np.testing.assert_array_equal(run_cl(lib_cl, folded, x[:1], 0.3, alone, tmp_path),
                                      out[:1])


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
