"""Times the tile product of the whole-force kernels (``csrc/tile_gemm.cuh``,
``tile::gemm``) alone on the card, away from the rest of the kernel.

    python3 scripts/torch_tile_gemm_bench.py

A small kernel, built here with nvcc from a source this script writes beside
the libraries, calls ``gemm<TM, NARROW>`` twenty times over on random data,
two thread blocks an SM as the kernels run, for the product shapes of a
chignolin layer (K x out: 64 x 1536, 1536 x 64, 512 x 64, 64 x 256) and every
tile size (16 to 80 rows). It prints the clocks of a call and the share of
the SM's float32 multiply-add rate (128 a clock) that the product's own
multiply-adds reach: the number to watch when the product's thread layout,
chunk shape or staging changes. The whole kernel's time is
``chip_smoke.py``'s and ``scripts/torch_tile_variants.py``'s to give.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twoforone_torch.ops import _build, tile_plan  # noqa: E402

SOURCE = r"""
#include "tile_gemm.cuh"
using namespace tile;

template <int TM>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
bench(float* scratch, const float* w, int K, int out, int narrow, int iters, long long* clocks) {
  TILE_DYNAMIC_SMEM(smem4);
  float* smem = reinterpret_cast<float*>(smem4);
  float* X = scratch + (size_t)blockIdx.x * (16 * TM) * (K + out);
  float* Y = X + (size_t)16 * TM * K;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (narrow)
      gemm<TM, true>(X, K, w, nullptr, Y, out, EPI_STORE, nullptr, smem);
    else
      gemm<TM, false>(X, K, w, nullptr, Y, out, EPI_STORE, nullptr, smem);
  }
  if (threadIdx.x == 0) clocks[blockIdx.x] = clock64() - t0;
}

template <int TM>
int go(float* scratch, const float* w, int K, int out, int narrow, int iters, int blocks, int smem,
       long long* clocks) {
  cudaFuncSetAttribute(bench<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  bench<TM><<<blocks, NTHREADS, smem>>>(scratch, w, K, out, narrow, iters, clocks);
  return (int)cudaGetLastError();
}

extern "C" int run(float* scratch, const float* w, int tm, int K, int out, int narrow, int iters,
                   int blocks, int smem, long long* clocks) {
  switch (tm) {
    case 1: return go<1>(scratch, w, K, out, narrow, iters, blocks, smem, clocks);
    case 2: return go<2>(scratch, w, K, out, narrow, iters, blocks, smem, clocks);
    case 3: return go<3>(scratch, w, K, out, narrow, iters, blocks, smem, clocks);
    case 4: return go<4>(scratch, w, K, out, narrow, iters, blocks, smem, clocks);
    default: return go<5>(scratch, w, K, out, narrow, iters, blocks, smem, clocks);
  }
}
"""
SHAPES = ((64, 1536, 0), (1536, 64, 1), (512, 64, 1), (64, 256, 0))  # K, out, narrow
ITERS = 20


def build():
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    folder = _build.build_dir()
    os.makedirs(folder, exist_ok=True)
    src = os.path.join(folder, "tile_gemm_bench.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    so = os.path.join(folder, "tile_gemm_bench.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stdout)
    lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def main():
    props = torch.cuda.get_device_properties(0)
    blocks = tile_plan.MAX_BLOCKS_PER_SM * props.multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print("gpu:", smi)
    lib = build()
    for tm in range(1, tile_plan.MAX_ROW_BLOCKS + 1):
        rows = 16 * tm
        for k, out, narrow in SHAPES:
            scratch = torch.randn(blocks * rows * (k + out), device="cuda")
            w = torch.randn(k * out, device="cuda")
            clocks = torch.zeros(blocks, dtype=torch.int64, device="cuda")
            smem = 4 * tile_plan.gemm_smem_floats(rows)
            rc = lib.run(scratch.data_ptr(), w.data_ptr(), tm, k, out, narrow, ITERS, blocks,
                         smem, clocks.data_ptr())
            if rc != 0:
                raise SystemExit(f"launch failed with CUDA error {rc}")
            torch.cuda.synchronize()
            per_call = clocks.double().mean().item() / ITERS
            share = rows * k * out * tile_plan.MAX_BLOCKS_PER_SM / (128 * per_call)
            print(f"rows={rows} K={k} out={out} clocks_per_call={per_call:.0f} "
                  f"share_of_fp32_rate={share:.3f}", flush=True)
    print("gpu:", smi)


if __name__ == "__main__":
    main()
