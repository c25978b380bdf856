"""Where the chain-lane whole-force kernel (K1) spends its time, phase by phase.

    python3 scripts/torch_k1_phases.py [--root CHECKOUT] [--chains 100 1000 ...]
                                       [--clusters 1 2 ...] [--out FILE.json]

Builds a copy of ``csrc/fused_score_cl.cu`` (of ``CHECKOUT``, this tree by
default) with a ``clock64`` stamp after every phase of the kernel's tile loop
(each product, each attention block, each row-wise piece), runs it through
the package's own wrapper on chain10 weights, and prints, per phase and
chain count, the cycles a call spends there on average over the thread
blocks, converted to microseconds by the instrumented call's own time, and
on which SMs the blocks ran. ``--clusters`` forces each tile onto clusters of
that many blocks (``plan_at``) in turn, beside the plan's own choice, where
the source takes clusters. Beside that it times the uninstrumented kernel, the cost of a block-wide
barrier and of a thread-block cluster barrier (pairs of 256-thread blocks),
and asks the card how many clusters of 2 and 4 of K1's blocks it keeps
resident at once. It prints the card's name and power limit. Needs the card
and ``nvcc``.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Calls of the kernel body whose end is stamped; a stamp books the cycles
# since the previous one, so loops and barriers between two calls go to the
# later call.
CALLS = ("load_centred", "layer_norm", "layer_norm_bwd", "gate_fwd", "gate_bwd", "gemm",
         "attention_fwd", "attention_bwd", "three_row_bwd")
MAX_STAMPS = 64
MAX_BLOCKS = 4096

PRELUDE = f"""
#define TFO_STAMPS {MAX_STAMPS}
__device__ unsigned long long tfo_cycles[{MAX_BLOCKS} * TFO_STAMPS];
__device__ unsigned long long tfo_visits[{MAX_BLOCKS} * TFO_STAMPS];
__device__ unsigned tfo_smid[{MAX_BLOCKS}];
#define TFO_STAMP(id) do {{ const long long tfo_now = clock64(); \\
  if (threadIdx.x == 0) {{ tfo_cycles[(size_t)blockIdx.x * TFO_STAMPS + (id)] += tfo_now - tfo_prev; \\
  tfo_visits[(size_t)blockIdx.x * TFO_STAMPS + (id)] += 1; }} tfo_prev = tfo_now; }} while (0)
"""

EPILOGUE = """
namespace {
__global__ void tfo_sync_bench(long long* out, int reps) {
  const long long t0 = clock64();
  for (int i = 0; i < reps; ++i) __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) out[blockIdx.x] = t1 - t0;
}
__global__ void tfo_cluster_bench(long long* out, int reps) {
  const long long t0 = clock64();
  for (int i = 0; i < reps; ++i) {
    asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) out[blockIdx.x] = t1 - t0;
}
}  // namespace

extern "C" {
int tfo_read(unsigned long long* cycles, unsigned long long* visits, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(cycles, tfo_cycles, n * sizeof(unsigned long long));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(visits, tfo_visits, n * sizeof(unsigned long long));
}
int tfo_read_smid(unsigned* smid, int n) {
  return (int)cudaMemcpyFromSymbol(smid, tfo_smid, n * sizeof(unsigned));
}
int tfo_reset() {
  void* p;
  cudaGetSymbolAddress(&p, tfo_cycles);
  cudaMemset(p, 0, sizeof(tfo_cycles));
  cudaGetSymbolAddress(&p, tfo_visits);
  return (int)cudaMemset(p, 0, sizeof(tfo_visits));
}
// Cycles per barrier over `reps` barriers of each of `blocks` blocks of 256
// threads; cluster > 1 times the cluster barrier of clusters of that size.
int tfo_barrier_cycles(int blocks, int cluster, int reps, double* cycles) {
  long long* d;
  cudaMalloc(&d, blocks * sizeof(long long));
  cudaError_t e;
  if (cluster <= 1) {
    tfo_sync_bench<<<blocks, 256>>>(d, reps);
    e = cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(256);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, tfo_cluster_bench, d, reps);
  }
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  std::vector<long long> h(blocks);
  cudaMemcpy(h.data(), d, blocks * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(d);
  double s = 0;
  for (long long v : h) s += (double)v;
  *cycles = s / blocks / reps;
  return (int)e;
}
// Clusters of `cluster` blocks of K1 (16 rows, `smem` bytes) resident at once.
int tfo_max_clusters(int cluster, int smem, int* result) {
  cudaError_t e = cudaFuncSetAttribute(fused_force_cl_kernel<1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(result, fused_force_cl_kernel<1>, &cfg);
}
}  // extern "C"
"""


def statement_end(lines, i):
    """Index of the line that ends the statement starting on line i."""
    depth = 0
    for j in range(i, len(lines)):
        code = lines[j].split("//")[0]
        depth += code.count("(") - code.count(")")
        if depth <= 0 and code.rstrip().endswith(";"):
            return j
    raise ValueError(f"no end for the statement on line {i + 1}")


def label(statement):
    name = statement.split("(")[0].split("<")[0].strip()
    args = statement[statement.index("(") + 1:].rstrip().rstrip(";").rstrip()[:-1]
    parts = [a.strip() for a in re.split(r",(?![^(]*\))", args)]
    return f"{name}({parts[2] if name == 'gemm' else parts[0]})"


def instrument(src):
    """The source with a stamp after each phase of the kernel, and the stamps' labels."""
    lines = src.split("\n")
    start = next(i for i, ln in enumerate(lines) if "fused_force_cl_kernel(const float*" in ln)
    stop = next(i for i in range(start, len(lines)) if lines[i].startswith("}"))
    out, labels = lines[:start], []
    i = start
    while i < stop:
        ln = lines[i]
        stripped = ln.strip()
        if stripped.startswith("TILE_DYNAMIC_SMEM"):
            out += [ln, "  long long tfo_prev = clock64();",
                    "  if (threadIdx.x == 0) {",
                    "    unsigned tfo_sm;",
                    '    asm volatile("mov.u32 %0, %%smid;" : "=r"(tfo_sm));',
                    "    tfo_smid[blockIdx.x] = tfo_sm;",
                    "  }"]
            i += 1
            continue
        name = re.match(r"([A-Za-z_]\w*)\s*[<(]", stripped)
        if name and name.group(1) in CALLS:
            j = statement_end(lines, i)
            statement = " ".join(s.split("//")[0].strip() for s in lines[i:j + 1])
            tag = label(statement)
            if tag not in labels:
                labels.append(tag)
            indent = ln[:len(ln) - len(ln.lstrip())]
            out += lines[i:j + 1] + [f"{indent}TFO_STAMP({labels.index(tag)});"]
            i = j + 1
            continue
        out.append(ln)
        i += 1
    labels.append("rest")
    out += [f"  TFO_STAMP({len(labels) - 1});"] + lines[stop:]
    text = "\n".join(out)
    text = text.replace('#include "tile_gemm.cuh"', '#include <vector>\n#include "tile_gemm.cuh"\n'
                        + PRELUDE, 1)
    assert len(labels) <= MAX_STAMPS
    return text + EPILOGUE, labels


def build(root, workdir):
    from twoforone_torch.ops import _build

    csrc = os.path.join(root, "twoforone_torch", "ops", "csrc")
    text, labels = instrument(open(os.path.join(csrc, "fused_score_cl.cu")).read())
    src = os.path.join(workdir, "fused_score_cl_phases.cu")
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(workdir, "fused_score_cl_phases.so")
    proc = subprocess.run([_build._nvcc(), *_build._flags(), "-I", csrc, "-o", so, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout[-6000:])
    lib = ctypes.CDLL(so)
    lib.tfo_barrier_cycles.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_double)]
    lib.tfo_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib, labels, proc.stdout


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--chains", type=int, nargs="+", default=[100, 1000])
    ap.add_argument("--clusters", type=int, nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from twoforone_torch.models.graph_transformer import GraphTransformer
    from twoforone_torch.ops import fused_score_cl as fcl
    from twoforone_torch.ops.tile_plan import plan_at, plan_tiles
    from twoforone_torch.utils.artifacts import load_ema_params
    from twoforone_torch.utils.device import sm_count

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    model = GraphTransformer(10, 64, 3, use_intrinsic_coords=True, use_abs_coords=False,
                             use_distances=False)
    fw = fcl.augment_params_cl(model, load_ema_params("chain10"), dev)
    report = {"gpu": smi, "root": root, "cells": []}
    with tempfile.TemporaryDirectory() as work:
        inst, labels, ptxas = build(root, work)
        report["ptxas_spills"] = sorted(set(re.findall(r"(\d+) bytes spill stores", ptxas)))
        stock = fcl._build
        own_plan = fcl.plan_tiles
        cases = [(chains, None) for chains in args.chains]
        cases += [(chains, size) for chains in args.chains for size in args.clusters]
        for chains, forced in cases:
            x = torch.from_numpy(np.random.default_rng(chains).normal(size=(chains, 10, 3))
                                 .astype(np.float32)).to(dev)
            plans = []

            def plan_of(*a, **k):
                plan = own_plan(*a, **k) if forced is None else plan_at(
                    own_plan(*a).chains_per_tile, *a, cluster=forced)
                plans.append(plan)
                return plan

            fcl.plan_tiles = plan_of
            fcl._build = stock
            plain_ms = event_ms(lambda: fcl.fused_force_cl(x, 0.02, fw), args.reps)
            want = fcl.fused_force_cl(x, 0.02, fw)
            # The wrapper, plan and launch as they are, on the instrumented copy.
            fcl._build = type("B", (), {"load": staticmethod(lambda name: inst)})
            got = fcl.fused_force_cl(x, 0.02, fw)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            inst.tfo_reset()
            inst_ms = event_ms(lambda: fcl.fused_force_cl(x, 0.02, fw), args.reps)
            calls = args.reps + 1
            fcl._build = stock
            fcl.plan_tiles = own_plan
            plan = plans[-1]
            smid = (ctypes.c_uint * plan.blocks)()
            assert inst.tfo_read_smid(smid, plan.blocks) == 0
            sm = np.frombuffer(smid, np.uint32)
            per_sm = np.bincount(sm)
            cluster = getattr(plan, "cluster", 1)
            shared = float(np.mean([len(set(sm[i:i + cluster])) < cluster
                                    for i in range(0, plan.blocks, cluster)]))
            placement = {"sms": int((per_sm > 0).sum()), "most_blocks_on_an_sm": int(per_sm.max()),
                         "clusters_with_two_ranks_on_an_sm": shared}
            n = MAX_BLOCKS * MAX_STAMPS
            cycles = (ctypes.c_ulonglong * n)()
            visits = (ctypes.c_ulonglong * n)()
            assert inst.tfo_read(cycles, visits, n) == 0
            cyc = np.frombuffer(cycles, np.uint64).reshape(MAX_BLOCKS, MAX_STAMPS)[:plan.blocks]
            vis = np.frombuffer(visits, np.uint64).reshape(MAX_BLOCKS, MAX_STAMPS)[:plan.blocks]
            per_call = cyc[:, :len(labels)].astype(np.float64).mean(axis=0) / calls
            total = per_call.sum()
            mhz = total / (inst_ms * 1e3)  # cycles a microsecond of the instrumented call
            phases = [{"phase": lab, "visits_per_call": float(vis[0, k]) / calls,
                       "cycles": float(per_call[k]), "us": float(per_call[k] / mhz),
                       "share": float(per_call[k] / total)} for k, lab in enumerate(labels)]
            report["cells"].append({
                "chains": chains, "forced_cluster": forced, "placement": placement,
                "plan": {f: getattr(plan, f) for f in plan.__dataclass_fields__},
                "kernel_ms": plain_ms, "instrumented_ms": inst_ms, "instrumented_same_bits": same,
                "cycles_per_us": mhz, "phases": phases})
            print(json.dumps(report["cells"][-1]), flush=True)
        fcl._build = stock
        bar = {}
        for blocks, cluster in ((100, 1), (200, 1), (200, 2), (256, 4)):
            c = ctypes.c_double()
            rc = inst.tfo_barrier_cycles(blocks, cluster, 20000, ctypes.byref(c))
            bar[f"blocks{blocks}_cluster{cluster}"] = c.value if rc == 0 else f"error {rc}"
        report["barrier_cycles"] = bar
        plan = plan_tiles(100, 10, 64, 8, 64, 256, 3, sm_count(0))
        clusters = {}
        for size in (2, 4):
            got = ctypes.c_int()
            rc = inst.tfo_max_clusters(size, plan.smem_bytes, ctypes.byref(got))
            clusters[size] = got.value if rc == 0 else f"error {rc}"
        report["max_active_clusters"] = clusters
        report["sm_count"] = sm_count(0)
    print(json.dumps({k: report[k] for k in report if k != "cells"}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
