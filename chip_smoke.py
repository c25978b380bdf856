"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card at the published widths of the staged
models, with bench.py's settings:

- chignolin (N=10, nf=64, 3 layers, 8 x 64 heads, chain10 weights, t=20):
  BAOA(F)B Langevin through ``LangevinDiffusion(fused="auto")`` at 100 and
  1000 chains (the fused force kernel), and i.i.d. sampling through
  ``make_fused_sample_fn`` (DDIM-100 at batch 4096, the 1000-step ancestral
  chain at batch 1024);
- trp-cage (N=20, nf=128, chain20 weights, t=15) and BBA (N=28, nf=96,
  chain28 weights, t=15): Langevin at 1000 chains on the attention-core path
  (the kernel pair inside an energy that is captured in a CUDA graph) beside
  the plain path and the whole-force kernel; trp-cage DDIM-100 sampling at
  batch 1024;
- the fused force kernel for every edge configuration: chignolin Langevin
  through ``LangevinDiffusion(fused="always")`` at 100 and 1000 chains, and
  DDIM-100 at batch 1024 through ``make_fused_sample_fn(kernel="auto")`` on
  the upstream-default edge configuration (squared distances and absolute
  coordinates; no trained model has it, so the weights come from a seed) at
  chignolin width.

Phases (any failure exits non-zero):

1. build every CUDA kernel from ``twoforone_torch/ops/csrc`` (all ``nvcc``
   runs started together; set-up time); print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the paths give it, and time both; for the two whole-force kernels
   also ragged tiles (chain counts around the tile size); for every kernel a
   chain's result alone against the same chain in a large batch and two calls
   bit for bit; the attention-core kernels beside their earlier design's
   times and one library call (scaled_dot_product_attention on augmented
   operands); the clx force evaluation graphed against eager (bits, t across
   replays, launches per evaluation, ms) and beside the whole-force kernel;
   the compiler's registers and spills;
3. chignolin Langevin with the launch counters set to 0 just before and read
   just after; counts, finiteness, steps/s;
4. 10 chignolin steps with the same injected noise through the kernel path
   and the plain path;
5. trp-cage and BBA Langevin likewise, each on the graphed clx path, the
   plain path and the whole-force kernel (counts, steps/s, 10-step comparison
   of clx with the plain path);
6. i.i.d. sampling likewise (resolved kernel, counts, finiteness, centre of
   mass, spread of the samples, samples/s, DDIM-20 against the plain path);
7. chignolin Langevin through ``fused="always"`` (counts, finiteness,
   steps/s beside phase 3's, 10-step comparison with the plain path);
8. sampling through ``kernel="auto"`` on the default edge configuration
   (resolves to ``"packed"``; counts, finiteness, centre of mass, samples/s;
   every score call of a DDIM-20 chain against the plain version at the same
   state, and the chain's samples beside the plain path's).

Earlier lines carry the numbers (one ``{"kernels": [...]}`` JSON line among
them); the last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, the script exits non-zero and
prints no result.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor cores
# and HBM3 bandwidth. Every kernel here computes a float32 function in float32
# on the CUDA cores, so the operation bound is taken at the FP32 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
TOL_REL = 1e-4  # kernel vs plain version, relative to the largest |reference|
# The fused force kernel for every edge configuration is held against its
# plain version evaluated in float64 on the same inputs. With squared
# distances on untrained weights (an edge embedding of fan-in 1 has unit
# variance) the scores reach hundreds and the softmax is sharp: the float32
# plain version itself then sits up to ~3e-4 of the largest force from the
# float64 one. The kernel may be TOL_REL from float64, or this many times as
# far from it as the float32 plain version is, whichever is larger; on
# trained weights and without distances that is TOL_REL.
TOL_F32_FACTOR = 4.0
TOL_TRAJ_REL = 1e-4  # 10-step trajectories, relative to the largest |x|
# DDIM-20 samples, kernel path vs plain path, in units of norm_factor (the
# size of a typical coordinate; the largest is an outlier, a chain that ends
# on the clip_x0 clamp at 10 x norm_factor). A reverse chain amplifies the
# score's rounding differences where a Langevin step does not: at the top of
# the cosine schedule x0 = (x - ..eps)/sqrt(abar_t) multiplies an eps
# difference by ~2e4, and 19 more steps of a learned, non-contractive flow
# follow. Two float32 implementations of the plain path on one CPU (this
# package and the JAX one, tests/test_torch_diffusion.py) already differ by
# ~2e-4 in the rms and ~6e-3 in the worst of 256 chains. So the rms over all
# coordinates is held tightly and the single worst coordinate loosely.
TOL_SAMPLE_RMS = 1e-3
TOL_SAMPLE_MAX = 5e-2
CLIP_X0 = 10.0  # the strided samplers' clamp on the x0 estimate, normalized units
TOL_COM = 1e-4  # centre of mass of a sample, in units of norm_factor

EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
# The upstream default: squared distances on the edges, absolute coordinates
# in the node features, no intrinsic coordinates.
DEFAULT_EDGES = dict(use_intrinsic_coords=False, use_abs_coords=True, use_distances=True)
CHIGNOLIN = dict(name="chain10", label="chignolin", n=10, nf=64, norm=3.113133430480957, temp=340, t_noise=20)
TRP_CAGE = dict(name="chain20", label="trp_cage", n=20, nf=128, norm=5.08211088180542, temp=290, t_noise=15)
BBA = dict(name="chain28", label="bba", n=28, nf=96, norm=6.294918537139893, temp=325, t_noise=15)

CHAINS = (100, 1000)
WARMUP_STEPS = 100
TIMED_STEPS = 1000
TRP_CHAINS = 1000
TRP_TIMED_STEPS = 500
TRP_PLAIN_STEPS = 100
HEADS, DH = 8, 64
PLAIN_REPS = 5  # timed calls of a plain version (a kernel: 50, or 20 at trp-cage width)
# Batch sizes of the sampling runs of phase 6. Every chain count a path gives
# a kernel is also a shape of that kernel's check in phase 2.
DDIM_BATCH = 4096
ANCESTRAL_BATCH = 1024
TRP_DDIM_BATCH = 1024
AGREE_BATCH = 256  # the 10-step and DDIM-20 comparisons of kernel and plain path
K1_CHAINS = sorted({AGREE_BATCH, *CHAINS, ANCESTRAL_BATCH, DDIM_BATCH})
K1_TIMED_CHAINS = (*CHAINS, DDIM_BATCH)
# Chain counts that leave a ragged last tile or change the tile size, beside
# those of the paths; TILE_AROUND is the chain count whose tile size T gives
# T - 1, T, T + 1.
TILE_AROUND = 1000
RAGGED_CHAINS = (1, 257)
ALONE_CHAINS = (1, 3, 100, 1000)  # x[:k] alone against the same chains in the largest batch
TOL_ALONE_REL = 1e-6  # where the tile size differs; the same tile size must give the same bits
# (N, B) of the attention-core checks: trp-cage at every chain count of its
# paths, BBA, and a ragged case.
CORE_SHAPES = (*((20, b) for b in sorted({AGREE_BATCH, TRP_CHAINS, TRP_DDIM_BATCH})),
               (28, 256), (11, 3))
# Chain counts at which K2 and K3 are timed at trp-cage width: where the path
# gate starts sending chains to the attention core, and the Langevin runs'.
CORE_TIMED_CHAINS = (AGREE_BATCH, TRP_CHAINS)
# The one-(chain, head)-per-block attention-core kernels these replaced, as
# PERF.md records them (NVIDIA H100 80GB HBM3, 700.00 W), in ms at trp-cage
# width: at 1000 chains this script's back-to-back time from Python, at 256
# chains the device time that scripts/torch_core_bench.py read on a checkout
# of that design (the faster of two runs). Neither kernel may be slower.
EARLIER_CORE_MS = {TRP_CHAINS: ("ms", {"fwd": 0.1905, "bwd": 0.4081}),
                   AGREE_BATCH: ("device_ms", {"fwd": 0.0580, "bwd": 0.1156})}
# The graphed clx evaluation against the eager one: the same kernels in the
# same order give the same bits unless cuBLAS picks another algorithm under
# capture; then within this, relative to the largest force.
TOL_GRAPH_REL = 1e-6
# The fused force kernel for every edge configuration (K4).
K4_TIMED_STEPS = 500
K4_DDIM_BATCH = 1024
K4_CHAINS = sorted({AGREE_BATCH, *CHAINS, K4_DDIM_BATCH})


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(msg)


def cuda_time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(flops, nbytes):
    """Least time the card could take, in ms, and which of the two sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def resource_usage(text):
    """ptxas's lines on registers and spills of one build (-Xptxas -v)."""
    regs = [int(ln.split("Used ")[1].split(" registers")[0]) for ln in text.splitlines()
            if "Used " in ln and " registers" in ln]
    spills = [int(ln.split(" bytes spill stores")[0].split()[-1]) for ln in text.splitlines()
              if "bytes spill stores" in ln]
    return dict(max_registers=max(regs, default=None), max_spill_store_bytes=max(spills, default=None),
                functions=len(spills))


def scratch_traffic_bytes(fw, chains, distances=False):
    """Bytes of residuals that a whole-force call writes in its forward and
    reads in its backward (once each), which pass through global memory."""
    from twoforone_torch.ops.tile_plan import scratch_floats

    per_chain_layer = scratch_floats(1, fw.n, fw.n, fw.c, fw.inner, fw.ff, fw.heads, 1, distances) \
        - scratch_floats(1, fw.n, fw.n, fw.c, fw.inner, fw.ff, fw.heads, 0, distances)
    return 2 * 4 * chains * fw.n_layers * per_chain_layer


def fused_force_flops(fw, chains, intrinsic=True, distances=False, abs_coords=False):
    """Operations of one fused force call: every product of the forward and
    of the input-gradient backward (elementwise work is a few % and left
    out). Per chain per layer 16 N C I + 8 N C F + 12 H N^2 dh, plus 18 N I
    for the coordinate-difference terms and 8 N I + 50 H N^2 for the
    squared-distance terms; per chain 12 N C for absolute coordinates in the
    node embedding. The defaults are the production edge configuration."""
    n, c, i, f, h, dh = fw.n, fw.c, fw.inner, fw.ff, fw.heads, fw.dh
    per_layer = 16 * n * c * i + 8 * n * c * f + 12 * h * n * n * dh
    per_layer += 18 * n * i * intrinsic + (8 * n * i + 50 * h * n * n) * distances
    return chains * (fw.n_layers * per_layer + 12 * n * c * abs_coords)


def core_work(b, n, h, dh):
    """(flops, bytes) of the attention core's forward and backward: each
    input read once, each output written once (x and dx, summed over heads,
    are shared by the heads)."""
    fwd = (b * h * (4 * n * n * dh + 12 * n * n),
           4 * (b * h * (4 * n * dh + 7 * n) + b * 3 * n))
    bwd = (b * h * (10 * n * n * dh + 30 * n * n),
           4 * (b * h * (7 * n * dh + 11 * n) + b * 6 * n))
    return fwd, bwd


def core_inputs(n, b, dev):
    """Seeded inputs of the attention core at n beads, b chains and 8 x 64
    heads: ``(q, k, v, x, qb, qkd), dout, dfd``."""
    q, k, v, dout = (normal(40 + i, (b, n, HEADS, DH), dev) for i in range(4))
    x, qb = normal(44, (b, n, 3), dev), normal(45, (b, HEADS, n), dev)
    qkd, dfd = (0.3 * normal(46 + i, (b, HEADS, n, 3), dev) for i in range(2))
    return (q, k, v, x, qb, qkd), dout, dfd


def core_times(acc, ins, dout, dfd, reps=50, graph_reps=20):
    """ms of K2 and K3 through the wrappers of module ``acc``: ``ms`` over
    back-to-back calls from Python, as a caller sees them, and ``device_ms``
    over the same calls replayed from a CUDA graph, the card's time alone
    (the least of three replays)."""
    calls = {"fwd": lambda: acc.cl_attention_fwd(*ins),
             "bwd": lambda: acc.cl_attention_bwd(*ins, dout, dfd)}
    times = {}
    for which, call in calls.items():
        ms = cuda_time_ms(call, reps)  # its first call is the warm-up a capture needs
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(graph_reps):
                call()
        device_ms = min(cuda_time_ms(graph.replay, 5) for _ in range(3)) / graph_reps
        times[which] = dict(ms=ms, device_ms=device_ms)
        del graph
    return times


def sdpa_operands(q, k, v, x, qb, qkd):
    """Augmented operands (B, H, N, dh + 8) on which one call of
    ``scaled_dot_product_attention`` computes the attention core:
    q'_i = [q_i, qkd_i, qb_i - qkd_i . x_i], k'_j = [k_j, x_j, 1],
    v'_j = [v_j, x_j], zero-padded; out = out'[:dh], fdiff = out'[dh:dh+3] - x_i."""
    b, n, h, dh = q.shape
    xh = x[:, None].expand(b, h, n, 3)
    qp, kp, vp = (torch.zeros(b, h, n, dh + 8, device=q.device) for _ in range(3))
    qp[..., :dh], kp[..., :dh], vp[..., :dh] = (a.transpose(1, 2) for a in (q, k, v))
    qp[..., dh:dh + 3] = qkd
    qp[..., dh + 3] = qb - (qkd * xh).sum(-1)
    kp[..., dh:dh + 3] = xh
    kp[..., dh + 3] = 1.0
    vp[..., dh:dh + 3] = xh
    return qp, kp, vp


def make_gd(spec, edges=EDGES):
    from twoforone_torch.core.diffusion import GaussianDiffusion
    from twoforone_torch.models.graph_transformer import GraphTransformer

    model = GraphTransformer(spec["n"], spec["nf"], 3, **edges)
    return GaussianDiffusion(model=model, num_atoms=spec["n"], timesteps=1000,
                             norm_factor=spec["norm"], loss_weights="higheruntil_100")


def normal(seed, shape, dev):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(dev)


def make_sim(gd, params, spec, chains, fused, n_timesteps, save_interval, dev):
    """bench.py's Langevin settings (dt 2e-3 ps, masses 12, friction 1,
    restraint_k 50, max_force 1e3) from a seeded random start."""
    from twoforone_torch.dynamics.langevin import LangevinDiffusion

    rng = np.random.default_rng(0)
    init = rng.normal(size=(chains, spec["n"], 3)).astype(np.float32)
    init = (init - init.mean(axis=1, keepdims=True)) * gd.norm_factor
    return LangevinDiffusion(
        gd, params, init, n_timesteps=n_timesteps, save_interval=save_interval,
        t=spec["t_noise"], temp_data=spec["temp"], temp_sim=spec["temp"], dt=2e-3,
        masses=[12.0] * spec["n"], friction=1.0, kb="consistent", random_seed=0,
        steps_per_chunk=1000, log=False, fused=fused, restraint_k=50.0, max_force=1e3,
        device=dev,
    )


def timed_run(ld, warmup, steps):
    """steps/s of ``steps`` Langevin steps after ``warmup`` steps; also
    whether every coordinate stayed finite."""
    ld.sim.simulate(sub_interval=warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = ld.sim.simulate(sub_interval=steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    finite = bool(np.isfinite(traj).all()) and bool(torch.isfinite(ld.sim._state[0]).all())
    return steps / elapsed, finite


def ten_steps_agree(phase, gd, params, spec, chains, kernel_mode, dev):
    """Ten steps with the same injected noise through the kernel path and
    the plain path."""
    noise = normal(9, (10, chains, spec["n"], 3), dev)
    finals = {}
    for fused in (kernel_mode, "never"):
        ld = make_sim(gd, params, spec, chains, fused, 10, 10, dev)
        draws = iter(noise)
        ld.sim._draw_noise = lambda like, draws=draws: next(draws)
        finals[fused] = ld.sample()
    diff = float(np.abs(finals[kernel_mode] - finals["never"]).max())
    scale = float(np.abs(finals["never"]).max())
    ok = bool(np.isfinite(finals[kernel_mode]).all()) and diff <= TOL_TRAJ_REL * scale
    log(f"{phase} 10-step {kernel_mode} vs plain max_coord_diff={diff:.3e} "
        f"max_coord={scale:.3f} tol_rel={TOL_TRAJ_REL} ok={ok}")
    if not ok:
        fail(f"{phase}: kernel path and plain path trajectories disagree")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from twoforone_torch.ops import _build
    from twoforone_torch.models.graph_transformer import init_params
    from twoforone_torch.ops import attention_cl_core as acc
    from twoforone_torch.ops import fused_score as fsc
    from twoforone_torch.ops import fused_score_cl as fcl
    from twoforone_torch.ops.fused_score_clx import make_clx_force_fn
    from twoforone_torch.utils.artifacts import load_ema_params
    from twoforone_torch.utils.device import sm_count

    def reset_counts():
        fcl.fused_force_cl.launches = fsc.fused_force.launches = 0
        acc.cl_attention_core.launches_fwd = acc.cl_attention_core.launches_bwd = 0

    def counts():
        return (fcl.fused_force_cl.launches, acc.cl_attention_core.launches_fwd,
                acc.cl_attention_core.launches_bwd, fsc.fused_force.launches)

    # ---------------------------------------------------------- phase 1
    t0 = started = time.perf_counter()

    def mark(done):
        """Seconds since the script began, printed as each phase ends."""
        log(f"{done} done at_s={time.perf_counter() - started:.1f}")

    libraries = ("fused_score", "fused_score_cl", "attention_cl_core")
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(_build.load, libraries))
    log(f"phase1 build_s={time.perf_counter() - t0:.2f} built={sorted(_build.logs)}")
    for name, text in _build.logs.items():
        print(f"--- nvcc {name}\n{text}", file=sys.stderr)
        log(f"phase1 ptxas {name}: " + json.dumps(resource_usage(text)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")

    dev = torch.device("cuda")
    gd = make_gd(CHIGNOLIN)
    params = load_ema_params(CHIGNOLIN["name"])
    fw = fcl.augment_params_cl(gd.model, params, dev)
    gd_trp = make_gd(TRP_CAGE)
    params_trp = load_ema_params(TRP_CAGE["name"])

    mark("phase1")

    # ---------------------------------------------------------- phase 2
    # K1, the fused force kernel, at every chain count of its paths and at
    # chain counts around its tile size.
    from twoforone_torch.ops.tile_plan import plan_tiles

    sms = sm_count(0)
    k1_dims = (fw.n, fw.c, fw.heads, fw.dh, fw.ff, fw.n_layers)
    tile = plan_tiles(TILE_AROUND, *k1_dims, sms).chains_per_tile
    k1_chains = sorted({*K1_CHAINS, *RAGGED_CHAINS, *(c for c in (tile - 1, tile, tile + 1) if c)})
    k1_err = 0.0
    for chains in k1_chains:
        x = normal(chains, (chains, 10, 3), dev)
        plan = plan_tiles(chains, *k1_dims, sms)
        for label, t in (("fixed", CHIGNOLIN["t_noise"] / 1000), ("runtime", 0.37)):
            out = fcl.fused_force_cl(x, t, fw)
            again = fcl.fused_force_cl(x, t, fw)
            torch.cuda.synchronize()
            ref = fcl.fused_force_cl_reference(x, t, fw)
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            same_bits = torch.equal(out, again)
            ok = bool(torch.isfinite(out).all()) and err <= TOL_REL * scale and same_bits
            log(f"phase2 fused_force_cl chains={chains} chains_per_tile={plan.chains_per_tile} "
                f"rows={plan.rows} tiles={plan.tiles} blocks={plan.blocks} t={label}:{t} "
                f"max_abs_err={err:.3e} max_rel_err={err / scale:.3e} tol_rel={TOL_REL} "
                f"same_bits={same_bits} ok={ok}")
            if not ok:
                fail("phase2: fused_force_cl disagrees with its plain version or does not "
                     "repeat bit for bit")
            k1_err = max(k1_err, err)

    def alone_check(name, force, plan_of, n_beads, largest):
        """A chain's result does not depend on its tile-mates: x[:k] alone
        against the same chains inside the largest batch."""
        x = normal(largest, (largest, n_beads, 3), dev)
        whole = force(x)
        for k in ALONE_CHAINS:
            alone = force(x[:k].contiguous())
            torch.cuda.synchronize()
            same_tile = plan_of(k).chains_per_tile == plan_of(largest).chains_per_tile
            same_bits = torch.equal(alone, whole[:k])
            rel = ((alone - whole[:k]).abs().max() / whole[:k].abs().max()).item()
            ok = same_bits if same_tile else rel <= TOL_ALONE_REL
            log(f"phase2 {name} alone chains={k} of {largest}: same_tile_size={same_tile} "
                f"same_bits={same_bits} max_rel_diff={rel:.3e} tol_rel={TOL_ALONE_REL} ok={ok}")
            if not ok:
                fail(f"phase2: a chain's {name} result depends on the batch it arrives in")

    t10 = CHIGNOLIN["t_noise"] / 1000
    alone_check("fused_force_cl", lambda x: fcl.fused_force_cl(x, t10, fw),
                lambda k: plan_tiles(k, *k1_dims, sms), 10, DDIM_BATCH)

    timing = {}
    fw64_k1 = fsc.augment_params(gd.model, params, dev, dtype=torch.float64)
    for chains in K1_TIMED_CHAINS:
        x = normal(7, (chains, 10, 3), dev)
        ms = cuda_time_ms(lambda: fcl.fused_force_cl(x, t10, fw), 50)
        plain_ms = cuda_time_ms(lambda: fcl.fused_force_cl_reference(x, t10, fw), PLAIN_REPS)
        ref64 = fsc.fused_force_reference(x.double(), t10, fw64_k1)
        scale64 = ref64.abs().max().item()
        rel = {name: (out - ref64).abs().max().item() / scale64 for name, out in (
            ("kernel", fcl.fused_force_cl(x, t10, fw)),
            ("plain_f32", fcl.fused_force_cl_reference(x, t10, fw)))}
        flops = fused_force_flops(fw, chains)
        bound_ms, bound_by = bound(flops, 4 * (2 * x.numel() + fw.flat.numel()))
        plan = plan_tiles(chains, *k1_dims, sms)
        scratch_bytes = scratch_traffic_bytes(fw, chains)
        timing[chains] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              flops=flops)
        log(f"phase2 timing fused_force_cl chains={chains} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} bound_by={bound_by} "
            f"residual_traffic_mb={scratch_bytes / 1e6:.1f} "
            f"residual_traffic_ms_at_hbm_rate={scratch_bytes / PEAK_BYTES_PER_S * 1e3:.4f} "
            f"scratch_allocated_mb={4 * plan.blocks * plan.scratch_floats / 1e6:.1f} "
            f"(L2 {L2_BYTES / 1e6:.0f} MB) gflop={flops / 1e9:.3f} "
            f"achieved_tflops={flops / ms / 1e9:.3f} rel_err_vs_plain_f64: "
            f"kernel={rel['kernel']:.2e} plain_f32={rel['plain_f32']:.2e}")

    # K2 and K3, the attention core's forward and backward.
    core_err = {"fwd": 0.0, "bwd": 0.0}
    for n, b in CORE_SHAPES:
        seed = 100 * n + b
        q, k, v = (normal(seed + i, (b, n, HEADS, DH), dev) for i in range(3))
        x = normal(seed + 3, (b, n, 3), dev)
        qb = normal(seed + 4, (b, HEADS, n), dev)
        qkd = 0.3 * normal(seed + 5, (b, HEADS, n, 3), dev)
        dout = normal(seed + 6, (b, n, HEADS, DH), dev)
        dfd = normal(seed + 7, (b, HEADS, n, 3), dev)
        ins = (q, k, v, x, qb, qkd)
        got = {"fwd": acc.cl_attention_fwd(*ins), "bwd": acc.cl_attention_bwd(*ins, dout, dfd)}
        again = {"fwd": acc.cl_attention_fwd(*ins), "bwd": acc.cl_attention_bwd(*ins, dout, dfd)}
        torch.cuda.synchronize()
        ref = {"fwd": acc.cl_attention_reference(*ins),
               "bwd": acc.cl_attention_bwd_reference(*ins, dout, dfd)}
        for which in ("fwd", "bwd"):
            same_bits = all(torch.equal(a, c) for a, c in zip(got[which], again[which]))
            errs = [(a - r).abs().max().item() for a, r in zip(got[which], ref[which])]
            scales = [r.abs().max().item() for r in ref[which]]
            if which == "bwd":
                # dqb_i = sum_j dsim_ij is zero in exact arithmetic (a softmax
                # row sums to 1), so both sides hold rounding noise: its error
                # is held against dqkd's scale, a sum of the same terms
                # weighted by O(1) coordinate differences.
                scales[4] = scales[5]
            rels = [e / sc for e, sc in zip(errs, scales)]
            ok = (same_bits and all(bool(torch.isfinite(a).all()) for a in got[which])
                  and max(rels) <= TOL_REL)
            log(f"phase2 cl_attention_{which} N={n} B={b} max_abs_err={max(errs):.3e} "
                f"max_rel_err={max(rels):.3e} tol_rel={TOL_REL} same_bits={same_bits} ok={ok}")
            if not ok:
                fail(f"phase2: cl_attention_{which} disagrees with its plain version "
                     "or does not repeat bit for bit")
            core_err[which] = max(core_err[which], max(errs))
        if b == max(bb for nn, bb in CORE_SHAPES if nn == n):
            # A chain's results do not depend on the batch (nor on the grid,
            # which follows the batch): x[:k] alone against the same chains
            # inside the largest batch of this N.
            for kk in sorted({c for c in (*ALONE_CHAINS, b // 2) if c < b}):
                part = [a[:kk].contiguous() for a in (*ins, dout, dfd)]
                alone = {"fwd": acc.cl_attention_fwd(*part[:6]),
                         "bwd": acc.cl_attention_bwd(*part)}
                torch.cuda.synchronize()
                for which in ("fwd", "bwd"):
                    whole = [g[:kk] for g in got[which]]
                    same = all(torch.equal(a, w) for a, w in zip(alone[which], whole))
                    log(f"phase2 cl_attention_{which} alone chains={kk} of {b} N={n}: "
                        f"same_bits={same} ok={same}")
                    if not same:
                        fail(f"phase2: a chain's cl_attention_{which} result depends on the "
                             "batch it arrives in")

    # The whole clx force evaluation against the same energy with the plain core.
    for spec in (TRP_CAGE, BBA):
        model = make_gd(spec).model
        weights = load_ema_params(spec["name"])
        x = normal(spec["n"], (256, spec["n"], 3), dev)
        t_fixed = spec["t_noise"] / 1000
        fixed = make_clx_force_fn(model, weights, t_fixed, dev)
        runtime = make_clx_force_fn(model, weights, None, dev)
        # The first call of a shape is the eager warm-up, the second a replay
        # of its graph.
        cases = (("fixed capture", t_fixed, fixed(x)), ("fixed replay", t_fixed, fixed(x)),
                 ("runtime capture", 0.37, runtime(x, torch.tensor(0.37, device=dev))),
                 ("runtime replay", 0.05, runtime(x, torch.tensor(0.05, device=dev))))
        for label, t, out in cases:
            ref = fcl.fused_force_cl_reference(x, t, fixed.folded)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= TOL_REL * scale
            log(f"phase2 clx_force {spec['name']} t={label}:{t} max_abs_err={err:.3e} "
                f"max_rel_err={err / scale:.3e} tol_rel={TOL_REL} ok={ok}")
            if not ok:
                fail("phase2: the clx force path disagrees with its plain version")

    # K2 and K3 timed at trp-cage width, beside their plain versions and one
    # library call at the Langevin runs' chain count.
    n = TRP_CAGE["n"]
    core_timing = {b: core_times(acc, *core_inputs(n, b, dev)) for b in CORE_TIMED_CHAINS}
    main_core = core_timing[TRP_CHAINS]
    ins, dout, dfd = core_inputs(n, TRP_CHAINS, dev)
    x = ins[3]
    main_core["fwd"]["plain_ms"] = cuda_time_ms(lambda: acc.cl_attention_reference(*ins),
                                                PLAIN_REPS)
    main_core["bwd"]["plain_ms"] = cuda_time_ms(
        lambda: acc.cl_attention_bwd_reference(*ins, dout, dfd), PLAIN_REPS)
    # The library yardstick: one call of scaled_dot_product_attention in the
    # memory-efficient backend at float32 on augmented operands (built
    # beforehand, not timed) computes the forward; the backward of that call
    # alone, the backward. Held once against the plain versions first.
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    scale = DH ** -0.5
    ops = sdpa_operands(*ins)
    leaves = [a.clone().requires_grad_(True) for a in ops]
    dout_p = torch.zeros_like(ops[0])
    dout_p[..., :DH] = dout.transpose(1, 2)
    dout_p[..., DH:DH + 3] = dfd
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        with torch.no_grad():
            out_p = sdpa(*ops, scale=scale)
        out_g = sdpa(*leaves, scale=scale)
        grads_p = torch.autograd.grad(out_g, leaves, dout_p, retain_graph=True)
        ref_out, ref_fd = acc.cl_attention_reference(*ins)
        ref_g = acc.cl_attention_bwd_reference(*ins, dout, dfd)
        pairs = (("out", out_p[..., :DH].transpose(1, 2), ref_out),
                 ("fdiff", out_p[..., DH:DH + 3] - x[:, None], ref_fd),
                 *((name, g[..., :DH].transpose(1, 2), r)
                   for name, g, r in zip(("dq", "dk", "dv"), grads_p, ref_g[:3])))
        for name, got_p, r in pairs:
            rel = ((got_p - r).abs().max() / r.abs().max()).item()
            log(f"phase2 sdpa yardstick {name} vs plain max_rel_err={rel:.3e} tol_rel={TOL_REL}")
            if not rel <= TOL_REL:
                fail("phase2: the SDPA yardstick does not compute the attention core")
        with torch.no_grad():
            main_core["fwd"]["library_ms"] = cuda_time_ms(lambda: sdpa(*ops, scale=scale), 50)
        main_core["bwd"]["library_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(out_g, leaves, dout_p, retain_graph=True), 50)
    del out_g, grads_p, leaves
    for b, times in core_timing.items():
        work = dict(zip(("fwd", "bwd"), core_work(b, n, HEADS, DH)))
        for which, tm in times.items():
            flops, nbytes = work[which]
            tm["bound_ms"], tm["bound_by"] = bound(flops, nbytes)
            extra = "".join(f" {key}={tm[key]:.4f}" for key in ("plain_ms", "library_ms")
                            if key in tm)
            kind, earlier = EARLIER_CORE_MS.get(b, (None, {}))
            note = f" (earlier design {kind}={earlier[which]}, PERF.md)" if kind else ""
            log(f"phase2 timing cl_attention_{which} N={n} B={b} kernel_ms={tm['ms']:.4f} "
                f"device_ms={tm['device_ms']:.4f}{note}{extra} "
                f"bound_ms={tm['bound_ms']:.4f} bound_by={tm['bound_by']} "
                f"share_of_bound={tm['bound_ms'] / tm['device_ms']:.3f} "
                f"gflop={flops / 1e9:.3f} mbytes={nbytes / 1e6:.1f} "
                f"achieved_gb_per_s={nbytes / tm['device_ms'] / 1e6:.1f}")
            if kind and tm[kind] > earlier[which]:
                fail(f"phase2: cl_attention_{which} is slower than the design it replaced "
                     f"at {b} chains")

    # K4, the fused force kernel for every edge configuration, against its
    # plain version in float64 (see TOL_F32_FACTOR).
    k4_err = {"abs": 0.0, "rel": 0.0}

    def k4_against_f64(out, x, t, fw32, fw64):
        """Errors of a kernel result and of the float32 plain version against
        the float64 plain version at (x, t): the largest over the batch, and
        the median and the 9th decile over the chains of each chain's error
        relative to its own largest force."""
        ref64 = fsc.fused_force_reference(x.double(), t, fw64)
        ref32 = fsc.fused_force_reference(x, t, fw32)
        own = ref64.abs().amax(dim=(1, 2)).clamp_min(1e-30)
        k_rel = (out - ref64).abs().amax(dim=(1, 2)) / own
        p_rel = (ref32 - ref64).abs().amax(dim=(1, 2)) / own
        return dict(
            scale=ref64.abs().max().item(), err=(out - ref64).abs().max().item(),
            plain_err=(ref32 - ref64).abs().max().item(),
            vs_plain_f32=(out - ref32).abs().max().item(),
            q50=k_rel.median().item(), q90=k_rel.quantile(0.9).item(),
            plain_q50=p_rel.median().item(), plain_q90=p_rel.quantile(0.9).item(),
            finite=bool(torch.isfinite(out).all()))

    def check_k4(label, model, weights, chains, t_fixed, seed):
        fw32 = fsc.augment_params(model, weights, dev)
        fw64 = fsc.augment_params(model, weights, dev, dtype=torch.float64)
        x = normal(seed, (chains, model.num_beads, 3), dev)
        fixed = fsc.make_fused_force_kernel(model, weights, t_fixed, dev)
        runtime = fsc.make_fused_force_kernel(model, weights, None, dev)
        for tag, t, out in (("fixed", t_fixed, fixed(x)), ("runtime", 0.37, runtime(x, 0.37))):
            torch.cuda.synchronize()
            e = k4_against_f64(out, x, t, fw32, fw64)
            scale = e["scale"]
            tol = max(TOL_REL * scale, TOL_F32_FACTOR * e["plain_err"])
            ok = e["finite"] and e["err"] <= tol
            log(f"phase2 fused_force {label} N={model.num_beads} chains={chains} t={tag}:{t} "
                f"max_abs_err={e['err']:.3e} max_rel_err={e['err'] / scale:.3e} "
                f"plain_f32_rel_err={e['plain_err'] / scale:.3e} tol_rel={tol / scale:.3e} "
                f"kernel_vs_plain_f32_rel={e['vs_plain_f32'] / scale:.3e} "
                f"median_chain_rel_err={e['q50']:.3e} (plain f32 {e['plain_q50']:.3e}) ok={ok}")
            if not ok:
                fail("phase2: fused_force disagrees with its plain version")
            k4_err["abs"] = max(k4_err["abs"], e["err"])
            k4_err["rel"] = max(k4_err["rel"], e["err"] / scale)
        return fixed, x

    k4_chains = sorted({*K4_CHAINS, *RAGGED_CHAINS,
                        *(c for c in (tile - 1, tile, tile + 1) if c)})
    for chains in k4_chains:
        # chain10 inputs are K1's of the same chain count: two hand-written
        # kernels of one function.
        fixed, x = check_k4("chain10", gd.model, params, chains, t10, chains)
        k4_out, k4_again, k1_out = fixed(x), fixed(x), fcl.fused_force_cl(x, t10, fw)
        torch.cuda.synchronize()
        err, scale = (k4_out - k1_out).abs().max().item(), k1_out.abs().max().item()
        same_bits = torch.equal(k4_out, k4_again)
        ok = err <= TOL_REL * scale and same_bits
        log(f"phase2 fused_force vs fused_force_cl chain10 chains={chains} "
            f"max_abs_diff={err:.3e} max_rel_diff={err / scale:.3e} tol_rel={TOL_REL} "
            f"same_bits={same_bits} ok={ok}")
        if not ok:
            fail("phase2: fused_force and fused_force_cl disagree on chain10, or fused_force "
                 "does not repeat bit for bit")
    fw4 = fsc.augment_params(gd.model, params, dev)
    alone_check("fused_force", lambda x: fsc.fused_force(x, t10, fw4),
                lambda k: plan_tiles(k, *k1_dims, sms), 10, K4_DDIM_BATCH)
    for spec in (TRP_CAGE, BBA):
        check_k4(spec["name"], make_gd(spec).model, load_ema_params(spec["name"]), 256,
                 spec["t_noise"] / 1000, spec["n"])
    gd_def = make_gd(CHIGNOLIN, DEFAULT_EDGES)
    params_def = init_params(gd_def.model, 0)
    for chains in (1000, K4_DDIM_BATCH):
        check_k4("seeded distances+abs", gd_def.model, params_def, chains, t10, 50 + chains)
    for seed, edges in enumerate((dict(DEFAULT_EDGES, use_intrinsic_coords=True),
                                  dict(DEFAULT_EDGES, use_distances=False)), start=1):
        label = "seeded " + "+".join(k[4:] for k, on in edges.items() if on)
        model = make_gd(CHIGNOLIN, edges).model
        check_k4(label, model, init_params(model, seed), 1000, t10, 60 + seed)
    for seed, (n, nf, chains) in enumerate(((TRP_CAGE["n"], TRP_CAGE["nf"], 256),
                                            (5, 64, 256), (11, 64, 3)), start=3):
        model = make_gd(dict(n=n, nf=nf, norm=1.0), DEFAULT_EDGES).model
        check_k4("seeded distances+abs", model, init_params(model, seed), chains, t10,
                 70 + seed)

    k4_timing = {}
    for label, model, weights, chains in (
            *((f"chain10_{c}", gd.model, params, c) for c in (*CHAINS, K4_DDIM_BATCH)),
            (f"default_edges_{K4_DDIM_BATCH}", gd_def.model, params_def, K4_DDIM_BATCH)):
        fixed = fsc.make_fused_force_kernel(model, weights, t10, dev)
        x = normal(7, (chains, 10, 3), dev)
        ms = cuda_time_ms(lambda: fixed(x), 50)
        plain_ms = cuda_time_ms(lambda: fsc.fused_force_reference(x, t10, fixed.folded),
                                PLAIN_REPS)
        f = fixed.folded
        flops = fused_force_flops(f, chains, f.intrinsic, f.distances, f.abs_coords)
        bound_ms, bound_by = bound(flops, 4 * (2 * x.numel() + fixed.folded.flat.numel()))
        scratch_bytes = scratch_traffic_bytes(f, chains, f.distances)
        k4_timing[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                flops=flops)
        log(f"phase2 timing fused_force {label} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} bound_by={bound_by} "
            f"residual_traffic_ms_at_hbm_rate={scratch_bytes / PEAK_BYTES_PER_S * 1e3:.4f} "
            f"gflop={flops / 1e9:.3f} achieved_tflops={flops / ms / 1e9:.3f}")
    # The two staged proteins of the attention-core path: the clx force
    # evaluation that the path gate picks there, graphed against eager (bits,
    # t across replays, launches per evaluation), and beside the whole-force
    # kernel.
    for spec in (TRP_CAGE, BBA):
        model, weights = make_gd(spec).model, load_ema_params(spec["name"])
        t_fixed = spec["t_noise"] / 1000
        packed = fsc.make_fused_force_kernel(model, weights, t_fixed, dev)
        clx = make_clx_force_fn(model, weights, t_fixed, dev)
        clx_eager = make_clx_force_fn(model, weights, t_fixed, dev, graphed=False)
        runtime = make_clx_force_fn(model, weights, None, dev)
        runtime_eager = make_clx_force_fn(model, weights, None, dev, graphed=False)
        x = normal(8, (TRP_CHAINS, spec["n"], 3), dev)
        clx(x)  # capture
        reset_counts()
        replay = clx(x)
        per_eval = counts()
        cases = [("fixed", t_fixed, replay, clx_eager(x))]
        runtime(x, 0.37)  # capture
        for t in (0.05, 0.37, 0.6):
            cases.append(("runtime", t, runtime(x, torch.tensor(t, device=dev)),
                          runtime_eager(x, t)))
        torch.cuda.synchronize()
        for label, t, got, ref in cases:
            same_bits = torch.equal(got, ref)
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            ok = (same_bits or rel <= TOL_GRAPH_REL) and per_eval == (0, 3, 3, 0)
            log(f"phase2 clx graphed vs eager {spec['name']} chains={TRP_CHAINS} t={label}:{t} "
                f"same_bits={same_bits} max_rel_diff={rel:.3e} tol_rel={TOL_GRAPH_REL} "
                f"launches_per_eval_k1_fwd_bwd_k4={per_eval} ok={ok}")
            if not ok:
                fail("phase2: the graphed clx evaluation disagrees with the eager one, or "
                     "counts other launches than 3 of K2 and 3 of K3")
        ms = cuda_time_ms(lambda: packed(x), 20)
        clx_ms = cuda_time_ms(lambda: clx(x), 20)
        eager_ms = cuda_time_ms(lambda: clx_eager(x), 20)
        f = packed.folded
        flops = fused_force_flops(f, TRP_CHAINS)
        plan = plan_tiles(TRP_CHAINS, f.n, f.c, f.heads, f.dh, f.ff, f.n_layers, sms)
        k4_timing[f"{spec['name']}_{TRP_CHAINS}"] = dict(
            ms=ms, clx_force_ms=clx_ms, clx_eager_force_ms=eager_ms, flops=flops)
        log(f"phase2 timing fused_force {spec['name']} N={spec['n']} C={spec['nf']} "
            f"chains={TRP_CHAINS} chains_per_tile={plan.chains_per_tile} rows={plan.rows} "
            f"kernel_ms={ms:.4f} clx_force_ms={clx_ms:.4f} (graphed) "
            f"clx_eager_force_ms={eager_ms:.4f} "
            f"bound_ms={flops / PEAK_FP32_FLOPS * 1e3:.4f} gflop={flops / 1e9:.3f} "
            f"achieved_tflops={flops / ms / 1e9:.3f}")
        del clx, clx_eager, runtime, runtime_eager

    launches = {"k1": 0, "fwd": 0, "bwd": 0, "k4": 0}

    def add_counts():
        got = counts()
        for name, count in zip(("k1", "fwd", "bwd", "k4"), got):
            launches[name] += count
        return got

    mark("phase2")

    # ---------------------------------------------------------- phase 3
    sps = {}
    for chains in CHAINS:
        ld = make_sim(gd, params, CHIGNOLIN, chains, "auto", 10_000_000, WARMUP_STEPS, dev)
        if ld.force_fn.mode != "cl":
            fail(f"phase3: fused='auto' resolved to {ld.force_fn.mode!r}")
        reset_counts()
        sps[chains], finite = timed_run(ld, WARMUP_STEPS, TIMED_STEPS)
        k1, fwd, bwd, k4 = add_counts()
        log(f"phase3 chignolin chains={chains} steps_per_s={sps[chains]:.2f} "
            f"launches={k1} steps={WARMUP_STEPS + TIMED_STEPS} finite={finite}")
        if k1 != WARMUP_STEPS + TIMED_STEPS or fwd or bwd or k4 or not finite:
            fail("phase3: kernel launches != steps, or non-finite coordinates")

    mark("phase3")

    # ---------------------------------------------------------- phase 4
    ten_steps_agree("phase4 chignolin", gd, params, CHIGNOLIN, 100, "cl", dev)

    mark("phase4")

    # ---------------------------------------------------------- phase 5
    # trp-cage and BBA Langevin at 1000 chains: fused="auto" (the graphed clx
    # evaluation) beside the plain path ("never") and the whole-force kernel
    # K4 ("always").
    gd_bba, params_bba = make_gd(BBA), load_ema_params(BBA["name"])
    protein_sps = {}
    for spec, g, weights in ((TRP_CAGE, gd_trp, params_trp), (BBA, gd_bba, params_bba)):
        name = spec["label"]
        for fused, warmup, timed, want in (
                ("auto", WARMUP_STEPS, TRP_TIMED_STEPS, lambda s: (0, 3 * s, 3 * s, 0)),
                ("never", 20, TRP_PLAIN_STEPS, lambda s: (0, 0, 0, 0)),
                ("always", WARMUP_STEPS, TRP_TIMED_STEPS, lambda s: (0, 0, 0, s))):
            ld = make_sim(g, weights, spec, TRP_CHAINS, fused, 10_000_000, warmup, dev)
            mode = ld.force_fn.mode
            if fused == "auto" and mode != "clx":
                fail(f"phase5: {name} fused='auto' resolved to {mode!r}")
            reset_counts()
            rate, finite = timed_run(ld, warmup, timed)
            got = add_counts()
            steps = warmup + timed
            protein_sps[name, mode] = rate
            ok = finite and got == want(steps)
            log(f"phase5 {name} N={spec['n']} chains={TRP_CHAINS} mode={mode} "
                f"steps_per_s={rate:.2f} steps={steps} launches_k1_fwd_bwd_k4={got} "
                f"finite={finite} ok={ok}")
            if not ok:
                fail(f"phase5: {name} {mode}: wrong launch counts or non-finite coordinates")
            del ld
        rate = {m: protein_sps[name, m] for m in ("clx", "never", "always")}
        step = {"chains": TRP_CHAINS, **{f"steps_per_s_{m}": r for m, r in rate.items()},
                "clx_over_never": rate["clx"] / rate["never"],
                "clx_over_always": rate["clx"] / rate["always"],
                "step_ms_clx": 1e3 / rate["clx"],
                "clx_force_ms": k4_timing[f"{spec['name']}_{TRP_CHAINS}"]["clx_force_ms"]}
        if spec is TRP_CAGE:
            core_ms = 3 * sum(main_core[w]["ms"] for w in ("fwd", "bwd"))
            step.update(attention_core_ms_per_step=core_ms,
                        attention_core_share=core_ms / step["step_ms_clx"],
                        rest_of_step_ms=step["step_ms_clx"] - core_ms)
        log(f"{name}_step " + json.dumps(step))
    ten_steps_agree("phase5 trp_cage", gd_trp, params_trp, TRP_CAGE, AGREE_BATCH, "clx", dev)
    ten_steps_agree("phase5 bba", gd_bba, params_bba, BBA, AGREE_BATCH, "clx", dev)

    mark("phase5")

    # ---------------------------------------------------------- phase 6
    samples_per_s = {}

    def sampling_run(phase, label, g, weights, spec, batch, sample_steps, kernel, per_call,
                     trained=True):
        """One timed draw through ``kernel="auto"``: the resolved kernel, the
        launch counts, shape, finiteness, centre of mass and, for trained
        weights, the spread of the samples against the data's."""
        g.make_fused_sample_fn(weights, batch, sample_steps=3, device=dev)(
            torch.Generator(device=dev).manual_seed(0))  # warm-up
        fn = g.make_fused_sample_fn(weights, batch, kernel="auto", sample_steps=sample_steps,
                                    device=dev)
        if fn.kernel != kernel:
            fail(f"{phase} {label}: kernel='auto' resolved to {fn.kernel!r}")
        calls = sample_steps or g.timesteps
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = add_counts()
        samples_per_s[label] = batch / elapsed
        finite = bool(torch.isfinite(out).all())
        com = (out.mean(dim=1).abs().max() / spec["norm"]).item()
        std_ratio = (out.std() / spec["norm"]).item()
        ok = (finite and got == tuple(c * calls for c in per_call) and com <= TOL_COM
              and (not trained or 0.5 <= std_ratio <= 2.0)
              and tuple(out.shape) == (batch, spec["n"], 3))
        log(f"{phase} {label} kernel={fn.kernel} samples_per_s={samples_per_s[label]:.2f} "
            f"seconds={elapsed:.3f} score_calls={calls} launches_k1_fwd_bwd_k4={got} "
            f"finite={finite} max_com_over_norm={com:.2e} std_over_norm={std_ratio:.3f} ok={ok}")
        if not ok:
            fail(f"{phase} {label}: wrong launch count, shape, centre of mass or spread")

    noise_table = {}

    def hook(tag, shape):
        """Injected noise of the DDIM-20 comparisons: one table per shape."""
        key = (tag, tuple(shape))
        if key not in noise_table:
            noise_table[key] = normal(10_000 if tag == "init" else tag, shape, dev)
        return noise_table[key]

    def ddim20_agree(phase, label, g, weights, spec, kernel, hold=True):
        """DDIM-20 with the same injected noise through the kernel path and
        the plain path, compared in units of norm_factor. ``hold=False``
        reports the numbers and fails only on non-finite samples."""

        outs = {kern: g.make_fused_sample_fn(weights, AGREE_BATCH, kernel=kern,
                                             sample_steps=20, device=dev)(noise=hook)
                for kern in (kernel, "xla")}
        norm = spec["norm"]
        delta = (outs[kernel] - outs["xla"]) / norm
        diff, rms = delta.abs().max().item(), delta.square().mean().sqrt().item()
        per_chain = delta.abs().amax(dim=(1, 2))
        # Chains of the plain path that end on the x0 clamp (|x| = 10 normalized).
        clipped = int((outs["xla"].abs().amax(dim=(1, 2)) >= 0.99 * CLIP_X0 * norm).sum())
        ok = bool(torch.isfinite(outs[kernel]).all()) and (
            not hold or (rms <= TOL_SAMPLE_RMS and diff <= TOL_SAMPLE_MAX))
        log(f"{phase} {label} DDIM-20 {kernel} vs plain, in units of norm_factor (held={hold}): "
            f"rms_diff={rms:.3e} tol_rms={TOL_SAMPLE_RMS} max_diff={diff:.3e} "
            f"tol_max={TOL_SAMPLE_MAX} median_chain_diff={per_chain.median().item():.3e} "
            f"worst_chain={int(per_chain.argmax())} "
            f"max_coord={outs['xla'].abs().max().item() / norm:.3f} "
            f"chains_on_x0_clip={clipped} ok={ok}")
        if not ok:
            fail(f"{phase} {label}: kernel path and plain path samples disagree")

    sampling_run("phase6", f"chignolin_ddim100_b{DDIM_BATCH}", gd, params, CHIGNOLIN,
                 DDIM_BATCH, 100, "cl", (1, 0, 0, 0))
    sampling_run("phase6", f"chignolin_ancestral1000_b{ANCESTRAL_BATCH}", gd, params, CHIGNOLIN,
                 ANCESTRAL_BATCH, None, "cl", (1, 0, 0, 0))
    sampling_run("phase6", f"trp_cage_ddim100_b{TRP_DDIM_BATCH}", gd_trp, params_trp, TRP_CAGE,
                 TRP_DDIM_BATCH, 100, "clx", (0, 3, 3, 0))
    ddim20_agree("phase6", "chignolin", gd, params, CHIGNOLIN, "cl")
    ddim20_agree("phase6", "trp_cage", gd_trp, params_trp, TRP_CAGE, "clx")

    mark("phase6")

    # ---------------------------------------------------------- phase 7
    k4_sps = {}
    for chains in CHAINS:
        ld = make_sim(gd, params, CHIGNOLIN, chains, "always", 10_000_000, WARMUP_STEPS, dev)
        if ld.force_fn.mode != "always":
            fail(f"phase7: fused='always' resolved to {ld.force_fn.mode!r}")
        reset_counts()
        k4_sps[chains], finite = timed_run(ld, WARMUP_STEPS, K4_TIMED_STEPS)
        k1, fwd, bwd, k4 = add_counts()
        steps = WARMUP_STEPS + K4_TIMED_STEPS
        log(f"phase7 chignolin fused=always chains={chains} steps_per_s={k4_sps[chains]:.2f} "
            f"(fused=auto, the cl kernel: {sps[chains]:.2f}) launches={k4} "
            f"launches_fused_force_cl={k1} steps={steps} finite={finite}")
        if k4 != steps or k1 or fwd or bwd or not finite:
            fail("phase7: kernel launches != steps, another kernel ran, or non-finite "
                 "coordinates")
    ten_steps_agree("phase7 chignolin", gd, params, CHIGNOLIN, 100, "always", dev)

    mark("phase7")

    # ---------------------------------------------------------- phase 8
    # Untrained weights: the spread of the samples says nothing and is not held.
    sampling_run("phase8", f"default_edges_ddim100_b{K4_DDIM_BATCH}", gd_def, params_def,
                 CHIGNOLIN, K4_DDIM_BATCH, 100, "packed", (0, 0, 0, 1), trained=False)
    # An untrained network is no denoiser: its x0 estimates sit on the clip_x0
    # clamp, its chain is chaotic and its states are badly conditioned (forces
    # reach 1e4 to 1e5 and a few chains of a batch lose most of their digits in
    # any float32 evaluation), so two float32 score functions that agree to
    # rounding at every state still end far apart, and the largest error of a
    # batch is the luck of its worst chain. What is held is every score call
    # of the kernel path's chain against the plain version in float64 at the
    # same state and t, chain by chain relative to the chain's own largest
    # force: the median within TOL_REL, the 9th decile within the larger of
    # TOL_REL and TOL_F32_FACTOR times the float32 plain version's. The
    # samples of the two paths are printed beside it.
    fn = gd_def.make_fused_sample_fn(params_def, AGREE_BATCH, kernel="packed", sample_steps=20,
                                     device=dev)
    fw32 = fsc.augment_params(gd_def.model, params_def, dev)
    fw64 = fsc.augment_params(gd_def.model, params_def, dev, dtype=torch.float64)
    steps_seen = []

    def checked_score(x, t):
        out = fn.score_fn(x, t)
        e = k4_against_f64(out, x, t, fw32, fw64)
        e["ok"] = (e["finite"] and e["q50"] <= TOL_REL
                   and e["q90"] <= max(TOL_REL, TOL_F32_FACTOR * e["plain_q90"]))
        steps_seen.append(dict(e, t=t))
        return out

    checked_score.scalar_t = True
    from twoforone_torch.core.diffusion import ddim_sample_loop

    reset_counts()
    mol = ddim_sample_loop(gd_def.buffers, checked_score, (AGREE_BATCH, 10, 3), sample_steps=20,
                           objective=gd_def.objective, noise=hook, device=dev)
    ok = (len(steps_seen) == 20 and all(e["ok"] for e in steps_seen)
          and counts() == (0, 0, 0, 20) and bool(torch.isfinite(mol).all()))
    worst = {k: max(e[k] for e in steps_seen) for k in ("q50", "q90", "plain_q50", "plain_q90")}
    log(f"phase8 default_edges DDIM-20 packed, every score call vs plain f64 at the same "
        f"state, per chain: calls={len(steps_seen)} worst_median_rel_err={worst['q50']:.3e} "
        f"(plain f32 {worst['plain_q50']:.3e}) worst_9th_decile_rel_err={worst['q90']:.3e} "
        f"(plain f32 {worst['plain_q90']:.3e}) "
        f"worst_batch_max_rel_err={max(e['err'] / e['scale'] for e in steps_seen):.3e} "
        f"(plain f32 {max(e['plain_err'] / e['scale'] for e in steps_seen):.3e}) "
        f"largest_force={max(e['scale'] for e in steps_seen):.3e} ok={ok}")
    if not ok:
        fail("phase8: a score call of the packed chain disagrees with its plain version")
    ddim20_agree("phase8", "default_edges", gd_def, params_def, CHIGNOLIN, "packed", hold=False)

    mark("phase8")
    log("steps_per_s " + json.dumps({
        **{f"chignolin_chains_{c}": sps[c] for c in CHAINS},
        **{f"{name}_chains_{TRP_CHAINS}_{mode}": rate
           for (name, mode), rate in protein_sps.items()},
        **{f"chignolin_chains_{c}_always": k4_sps[c] for c in CHAINS},
    }))
    log("samples_per_s " + json.dumps(samples_per_s))
    log("kernel_100_chains " + json.dumps(timing[100]))
    log(f"kernel_{DDIM_BATCH}_chains " + json.dumps(timing[DDIM_BATCH]))
    log("fused_force_timing " + json.dumps(k4_timing))
    main_k1 = timing[1000]
    kernels = [{
        "name": "fused_force_cl",
        "route": "cuda",
        "source": "twoforone_torch/ops/csrc/fused_score_cl.cu",
        "replaces": "twoforone_tpu/ops/fused_score_cl.py:309",
        "launches": launches["k1"],
        "max_abs_err": k1_err,
        "ms": main_k1["ms"],
        "plain_ms": main_k1["plain_ms"],
        "bound_ms": main_k1["bound_ms"],
        "bound_by": main_k1["bound_by"],
        "library_ms": None,
    }]
    for which, line in (("fwd", 175), ("bwd", 199)):
        tm = main_core[which]
        kernels.append({
            "name": f"cl_attention_{which}",
            "route": "cuda",
            "source": "twoforone_torch/ops/csrc/attention_cl_core.cu",
            "replaces": f"twoforone_tpu/ops/attention_cl_core.py:{line}",
            "launches": launches[which],
            "max_abs_err": core_err[which],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
        })
    main_k4 = k4_timing["chain10_1000"]
    kernels.append({
        "name": "fused_force",
        "route": "cuda",
        "source": "twoforone_torch/ops/csrc/fused_score.cu",
        "replaces": "twoforone_tpu/ops/fused_score.py:418",
        "launches": launches["k4"],
        "max_abs_err": k4_err["abs"],
        "max_rel_err": k4_err["rel"],
        "ms": main_k4["ms"],
        "plain_ms": main_k4["plain_ms"],
        "bound_ms": main_k4["bound_ms"],
        "bound_by": main_k4["bound_by"],
        "library_ms": None,
    })
    log(json.dumps({"kernels": kernels}))
    log(f"gpu: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
