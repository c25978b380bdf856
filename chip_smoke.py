"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path on the card: chignolin (N=10, nf=64, 3 layers,
8 x 64 heads) with the trained chain10 EMA weights at noise level t=20, run as
BAOA(F)B Langevin through ``LangevinDiffusion`` at 100 and 1000 chains, with
bench.py's settings. Phases (any failure exits non-zero):

1. build every CUDA kernel from ``twoforone_torch/ops/csrc`` (set-up time);
   print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, at every
   chain count of the main path (and 256), fixed t and runtime t; time both;
3. drive the main path with the launch counters set to 0 just before and read
   just after; check the counts, finiteness, and report steps/s;
4. run 10 steps with the same injected noise through the kernel path and the
   plain path and compare the coordinates.

Earlier lines carry the numbers (one ``{"kernels": [...]}`` JSON line among
them); the last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, the script exits non-zero and
prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor cores
# and HBM3 bandwidth. The fused force kernel computes in FP32 on CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL_REL = 1e-4  # kernel vs plain version, relative to the largest |eps_hat|
TOL_TRAJ_REL = 1e-4  # 10-step trajectories, relative to the largest |x|

T_NOISE = 20
CHAINS = (100, 1000)
WARMUP_STEPS = 100
TIMED_STEPS = 1000


def log(msg):
    print(msg, flush=True)


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


def fused_force_flops(fw, chains):
    """Operations of one fused force call: every product of the forward and
    of the input-gradient backward (elementwise work is a few % and left
    out). Per chain per layer: 16 N C I + 8 N C F + 12 H N^2 dh + 18 N I."""
    n, c, i, f, h, dh = fw.n, fw.c, fw.inner, fw.ff, fw.heads, fw.dh
    per_layer = 16 * n * c * i + 8 * n * c * f + 12 * h * n * n * dh + 18 * n * i
    return chains * fw.n_layers * per_layer


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from twoforone_torch.core.diffusion import GaussianDiffusion
    from twoforone_torch.dynamics.langevin import LangevinDiffusion
    from twoforone_torch.models.graph_transformer import GraphTransformer
    from twoforone_torch.ops import _build
    from twoforone_torch.ops import fused_score_cl as fcl
    from twoforone_torch.utils.artifacts import load_ema_params

    # ---------------------------------------------------------- phase 1
    t0 = time.perf_counter()
    _build.load("fused_score_cl")
    log(f"phase1 build_s={time.perf_counter() - t0:.2f} built={sorted(_build.logs)}")
    for name, text in _build.logs.items():
        print(f"--- nvcc {name}\n{text}", file=sys.stderr)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")

    model = GraphTransformer(10, 64, 3, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False)
    gd = GaussianDiffusion(model=model, num_atoms=10, timesteps=1000,
                           norm_factor=3.113133430480957, loss_weights="higheruntil_100")
    params = load_ema_params("chain10")
    dev = torch.device("cuda")
    fw = fcl.augment_params_cl(model, params, dev)

    # ---------------------------------------------------------- phase 2
    max_abs = 0.0
    for chains in (256, *CHAINS):
        x = torch.from_numpy(
            np.random.default_rng(chains).normal(size=(chains, 10, 3)).astype(np.float32)
        ).to(dev)
        for label, t in (("fixed", T_NOISE / 1000), ("runtime", 0.37)):
            out = fcl.fused_force_cl(x, t, fw)
            torch.cuda.synchronize()
            ref = fcl.fused_force_cl_reference(x, t, fw)
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= TOL_REL * scale
            log(f"phase2 chains={chains} t={label}:{t} max_abs_err={err:.3e} "
                f"max_rel_err={err / scale:.3e} tol_rel={TOL_REL} ok={ok}")
            if not ok:
                raise SystemExit("phase2: kernel disagrees with its plain version")
            max_abs = max(max_abs, err)

    timing = {}
    for chains in CHAINS:
        x = torch.from_numpy(
            np.random.default_rng(7).normal(size=(chains, 10, 3)).astype(np.float32)
        ).to(dev)
        t = T_NOISE / 1000
        ms = cuda_time_ms(lambda: fcl.fused_force_cl(x, t, fw), 50)
        plain_ms = cuda_time_ms(lambda: fcl.fused_force_cl_reference(x, t, fw), 10)
        flops = fused_force_flops(fw, chains)
        nbytes = 4 * (2 * x.numel() + fw.flat.numel())
        bound_s = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
        timing[chains] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
                              bound_by="operations" if flops / PEAK_FP32_FLOPS
                              >= nbytes / PEAK_BYTES_PER_S else "bytes", flops=flops)
        log(f"phase2 timing chains={chains} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_s * 1e3:.4f} gflop={flops / 1e9:.3f} "
            f"achieved_tflops={flops / ms / 1e9:.3f}")

    # ---------------------------------------------------------- phase 3
    def make_sim(chains, fused, n_timesteps, save_interval):
        rng = np.random.default_rng(0)
        init = rng.normal(size=(chains, 10, 3)).astype(np.float32)
        init = (init - init.mean(axis=1, keepdims=True)) * gd.norm_factor
        return LangevinDiffusion(
            gd, params, init, n_timesteps=n_timesteps, save_interval=save_interval,
            t=T_NOISE, temp_data=340, temp_sim=340, dt=2e-3, masses=[12.0] * 10,
            friction=1.0, kb="consistent", random_seed=0, steps_per_chunk=TIMED_STEPS,
            log=False, fused=fused, restraint_k=50.0, max_force=1e3, device=dev,
        )

    sps = {}
    main_launches = 0
    for chains in CHAINS:
        ld = make_sim(chains, "auto", 10_000_000, WARMUP_STEPS)
        if ld.force_fn.mode != "cl":
            raise SystemExit(f"phase3: fused='auto' resolved to {ld.force_fn.mode!r}")
        fcl.fused_force_cl.launches = 0
        ld.sim.simulate(sub_interval=WARMUP_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj = ld.sim.simulate(sub_interval=TIMED_STEPS)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = fcl.fused_force_cl.launches
        main_launches += launches
        sps[chains] = TIMED_STEPS / elapsed
        finite = bool(np.isfinite(traj).all()) and bool(
            torch.isfinite(ld.sim._state[0]).all()
        )
        log(f"phase3 chains={chains} steps_per_s={sps[chains]:.2f} "
            f"launches={launches} steps={WARMUP_STEPS + TIMED_STEPS} finite={finite}")
        if launches != WARMUP_STEPS + TIMED_STEPS or not finite:
            raise SystemExit("phase3: kernel launches != steps, or non-finite coordinates")

    # ---------------------------------------------------------- phase 4
    noise = torch.from_numpy(
        np.random.default_rng(9).normal(size=(10, 100, 10, 3)).astype(np.float32)
    ).to(dev)
    finals = {}
    for fused in ("cl", "never"):
        ld = make_sim(100, fused, 10, 10)
        draws = iter(noise)
        ld.sim._draw_noise = lambda like, draws=draws: next(draws)
        finals[fused] = ld.sample()
    diff = float(np.abs(finals["cl"] - finals["never"]).max())
    scale = float(np.abs(finals["never"]).max())
    ok = bool(np.isfinite(finals["cl"]).all()) and diff <= TOL_TRAJ_REL * scale
    log(f"phase4 10-step kernel vs plain max_coord_diff={diff:.3e} "
        f"max_coord={scale:.3f} tol_rel={TOL_TRAJ_REL} ok={ok}")
    if not ok:
        raise SystemExit("phase4: kernel path and plain path trajectories disagree")

    log("steps_per_s " + json.dumps({f"chains_{c}": sps[c] for c in CHAINS}))
    log("kernel_100_chains " + json.dumps(timing[100]))
    main = timing[1000]
    log(json.dumps({"kernels": [{
        "name": "fused_force_cl",
        "route": "cuda",
        "source": "twoforone_torch/ops/csrc/fused_score_cl.cu",
        "replaces": "twoforone_tpu/ops/fused_score_cl.py:309",
        "launches": main_launches,
        "max_abs_err": max_abs,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
    }]}))
    log(f"gpu: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
