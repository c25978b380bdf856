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
  chignolin width;
- the sampling CLI (``twoforone_torch.cli.sample.main``) on copies of the
  staged results directories: chignolin Langevin and i.i.d. sampling through
  ``--fused auto`` (the fused force kernel), trp-cage Langevin through
  ``--fused auto`` (the attention-core path), alanine dipeptide through
  ``--fused auto`` and villin and protein G through ``--fused always`` (the
  fused force kernel for every edge configuration);
- training: the trainer at chain10's published configuration on synthetic
  chignolin frames, the sampling CLI on the weights it wrote (the fused
  force kernel), and the train CLI on a synthetic protein-G data folder;
- the positive control: the Langevin stage of the chain controls on the
  staged chain10 and chain20 weights (the fused force kernel and the
  attention-core path), in resumable segments, scored by TIC JS and the
  basin-exchange report; and ``run_chain_control`` at chain10's widths;
- the multi-GPU layer (``twoforone_torch.parallel``): chignolin Langevin
  and two training steps in a world of one over NCCL, then two ranks that
  share the one card over gloo (chignolin and trp-cage Langevin, sharded
  DDIM-100, training steps, and the sampling CLI under two ranks).
- bfloat16 score-network compute: bench.py's ``bf16=True`` on every force
  path, sampling, training and the dipeptide positive control's bfloat16
  Langevin stage;
- the port as a user installs it: a wheel of the checkout, unpacked into a
  directory of its own, runs chignolin (K1), trp-cage (clx) and villin (K4)
  Langevin through its ``tfo-torch-sample`` console script, building its
  kernels from the shipped sources into ``TFO_KERNEL_CACHE``;
- the reproduction workflows (``scripts/torch_*.py``): the paper-scale
  chignolin Langevin production run, cut in steps, straight and then
  SIGKILLed, preempted and resumed (the fused force kernel), the evaluation
  scripts on its frames and on alanine-dipeptide samples, the noise-level
  sweep on trp-cage (the attention-core path) and the strided-sampler
  quality ladder;
- the JAX package's compiled loops: every Langevin run above replays a
  captured step from a CUDA graph, and every sampling closure of
  the plain network a captured reverse step; phase 16 holds each
  graphed path against the eager loop bit for bit and times both;
- the JAX package's jitted training programs: every training step above
  replays its captured halves (gradients, then update) and every loss
  evaluation a captured batch; the last phase holds them against the eager
  step bit for bit and times both.

Phases (any failure exits non-zero):

1. build every CUDA kernel from ``twoforone_torch/ops/csrc`` (all ``nvcc``
   runs started together; set-up time); print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the paths give it, and time both; for the two whole-force kernels
   also ragged tiles (chain counts around the tile size); for every kernel a
   chain's result alone against the same chain in a large batch and two calls
   bit for bit; the attention-core kernels beside one library call
   (scaled_dot_product_attention on augmented operands); the clx force evaluation graphed against eager (bits, t across
   replays, launches per evaluation, ms) and beside the whole-force kernel;
   the compiler's registers and spills; the staged models only the CLI runs
   (K4 on villin and protein G, K1 on alanine dipeptide) at its chain count,
   with K4's shared memory per block;
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
   state, and the chain's samples beside the plain path's);
9. the sampling CLI's runs, each with the counters set to 0 just before and
   read just after: resolved path and kernel, launches against score
   evaluations, output shape, finiteness, the .npy, .pt and .pdb files, wall
   seconds and rates (the chignolin Langevin rate beside phase 3's);
10. training: (a) ``Trainer.train`` at chain10's published configuration
   (losses finite and falling, KL-at-T, checkpoints, the EMA read back bit
   for bit, no kernel launched, the final samples scored on the golden
   chignolin references), then the step timed, graphed and eager, the
   graphed step under ``torch.profiler`` (idle share, top kernels) and the
   products of eager steps counted; (b) ``cli.sample`` on (a)'s results
   directory through the fused force kernel (path, launches, finiteness)
   and the kernel against its plain version on those weights; (c) ``cli.train`` on a
   synthetic protein-G data folder at chain56's widths (files, empty results:
   protein G has no metric);
11. the positive control's path: (a) chignolin (K1) and trp-cage (clx) on
   the staged weights: 1000 initial states by the ancestral chain through
   ``make_fused_sample_fn(kernel="auto")``, then ``_segmented_langevin_stage``
   (the resolved path, launches against score calls and steps, finiteness,
   TIC JS <= 0.10, the ergodicity report, wall seconds); (b) a segmented run
   killed and resumed in a fresh ``LangevinDiffusion`` equals one
   ``sample()`` bit for bit; (c) ``run_chain_control`` at chain10's widths
   with a cut budget (the JAX function's keys, finite values, no launch in
   training, K1 launches = Langevin steps, its stage files) and its resume
   (no launch, the same arrays); (d) ``trace`` around chignolin steps names
   K1's kernel; (e) the symmetry checkers through K1 against the plain
   network; (f) ``kabsch_rmsd`` on the card against the host. The stages are
   timed by ``PhaseTimer``;
12. the multi-GPU layer: (a) a world of 1 over NCCL on the card: chignolin
   Langevin at 1000 chains through K1 with phase 3's seed and steps, and 12
   Trainer steps at chain10's published configuration (batch 512) replayed
   from the step's graphs, each bit for bit equal to the run without a mesh
   (the meshless graphed steps equal to eager ones; steps/s beside phase 3's);
   (b) two ranks (this script with ``--mesh-rank``) sharing the card over
   gloo, since NCCL refuses two ranks on one device: the gathered
   1000-chain chignolin trajectory (500 chains a rank through K1) bit for
   bit equal to (a)'s, K1 launches equal to the steps on each rank;
   trp-cage at 1000 chains resolving clx on each rank, held against the
   single-process clx run after 10 steps; DDIM-100 at batch 4096 through K1
   (launches, finiteness, centre of mass, spread); 12 training steps, graphed
   and eager (graphed equal to eager on each rank, the weights bit for bit
   equal across the ranks, the first two steps' gradients against (a)'s);
   then ``python -m twoforone_torch.cli.sample`` under two ranks
   with ``--parallel_sim 999`` (padded to 1000, 999 chains' frames out, the
   files written by rank 0 alone). Every rank has a time limit; a rank that
   fails or hangs fails the phase. The two-rank rates are two processes on
   one card, not a scaling figure. The ranks' launches are added to the
   ``kernels`` line; those of the CLI's processes are not counted.
13. bfloat16 score-network compute: (a) bench.py's configuration,
   ``LangevinDiffusion(bf16=True, fused="auto")``: chignolin (K1) and
   trp-cage (clx) at 1000 chains give the ``bf16=False`` trajectory bit for
   bit with the same launches; villin and protein G at 100 chains resolve to
   the plain network, whose bfloat16 trajectory after 10 steps is held
   against the float32 one within C_RULE x the JAX package's own distance +
   2^-8 of max |x| (``scripts/torch_bf16_bars.py``), with both rates and the
   device's idle share; (b) ``sample(bf16=True)``, DDIM-100 on chignolin at
   batch 1024: the bead covariance within 0.05 of the float32 chain's,
   samples/s of both; (c) 100 trainer steps of a bfloat16 model at chain10's
   published configuration (losses finite and falling, weights, EMA and
   Adam's moments float32, no kernel); (d) ``run_positive_control`` with
   ``bf16_compare=True`` at the JAX package's CI tier (3500 steps, 64 chains
   x 8000 steps, T=250, 31 bins): the JAX function's keys, every frame
   finite, ``js_bf16_vs_f32 < 0.1`` and ``pwd_js_bf16_vs_f32 < 0.01``, the
   wall seconds of each stage.
14. the port from an installed copy: ``pip wheel`` of a copy of the
   checkout (``pyproject.toml`` and both packages, no staged weights); the
   wheel holds every ``ops/csrc`` file (``tile_gemm.cuh`` too) and the
   ``tfo-torch-*`` console scripts; unpacked into a temporary directory, it
   is the ``PYTHONPATH`` of one process (this script with ``-P
   --installed-run``, a temporary working directory, a fresh
   ``TFO_KERNEL_CACHE``) that loads ``tfo-torch-sample`` through the
   distribution's entry points and calls it on copies of the staged chain10
   (K1, 1000 chains), chain20 (clx: K2, K3) and chain35 (``--fused always``:
   K4) with phase 9's flags. Held: ``twoforone_torch`` imported from the
   wheel, the three libraries built on first use in ``TFO_KERNEL_CACHE``
   (seconds each) and nothing written inside the installed package,
   launches equal to score calls and steps (phase 9's rule), the JAX CLI's
   outputs, and chain10's output equal to phase 9's bit for bit; steps/s
   beside phase 9's. The process's launches are added to the ``kernels``
   line.
15. the reproduction workflows: (a) ``scripts/torch_paper_scale_langevin.py``
   on the staged chain10, 100 chains x 40 000 steps (cut from 6 000 000), a
   save every 500, segments of 10 000: a straight run through its ``main``
   (K1 launches equal to the 1000 i.i.d. calls plus the steps; steps/s,
   chain-steps/s and the 6M-step wall projected on this card), then its
   first 10 000 steps in segments of 2 500, in three processes sharing one
   ``--out``: SIGKILLed during the third segment, relaunched under
   ``TWOFORONE_PREEMPT_FLAG`` (the flag created once ``coords_seg002.npy``
   exists; exit code 75 at that boundary), relaunched to the end; the
   frames equal the straight run's first 20 saves bit for bit and score
   as they do, ``meta.json`` shows 2 resumes; (b)
   ``torch_evaluate_fastfolders.py --no_plots`` on (a)'s frames and
   ``torch_evaluate_ala2.py --no_plots`` on 4096 i.i.d. samples of the
   staged ala5 (K1), each in a process that cannot import JAX, flax, optax
   or the JAX package: exit 0, the JAX scripts' keys, finite values; (c)
   ``torch_langevin_t_sweep.py`` on the staged chain20 (two t, 256 chains x
   2000 steps; K2 and K3 three times a step) and ``torch_ddim_quality.py``
   (DDIM-100 and DDIM-20, 4096 samples, the plain network: no launch).
16. the CUDA graphs: (a) 200 steps (a save every 50) graphed against the
   eager loop (the simulation's private ``_graphs`` set to None), bit for
   bit in x, v, the frames, forces, kinetic energies and the generator
   state, with launches equal to the steps: chignolin ``cl``, ``always``
   and overdamped ``cl`` at 100 chains, trp-cage ``clx`` and ``never`` at
   256, villin ``never`` (float32, bfloat16, the tempering ramp) and
   ``always`` at 100; a graphed chignolin run stopped at its midpoint and
   resumed through ``state``/``load_state`` equals the straight one; (b)
   chignolin ``kernel="xla"`` at batch 1024, graphed against eager bit for
   bit: DDIM-20 and DPM-Solver++(2M)-20 over two calls of one closure, the
   1000-step ancestral chain once; (c) rates, printed and not held:
   graphed and eager steps/s of villin and protein G ``never`` (float32,
   bfloat16) and ``always`` at 100 chains, trp-cage ``never`` at 1000,
   chignolin ``cl`` at 100 and 1000, graphed villin ``never``'s device idle
   share under ``torch.profiler``, and chignolin DDIM-100 samples/s on the
   plain network; and the device memory of every graphed path's first call
   (its static buffers and its graphs' pool).
17. the training step's CUDA graphs at chain10's published configuration
   (batch 512) on phase 10's synthetic frames, graphed against eager (the
   trainer's private ``_step_graphs`` / ``_eval_graphs`` set to None): (a)
   bit for bit in every step's loss, KL-at-T and KL max, the weights, EMA,
   Adam's ``mu``/``nu`` and count, gradients and generator state: 120
   float32 steps (past the EMA's copy phase into its ramp, with its skipped
   calls), 40 with ``gradient_accumulate_every`` 2, 40 of a bfloat16 model,
   one ``_train_chunk`` of 50; no kernel launched; (b) saved at step 60,
   trained on, loaded back into the captured trainer and into a fresh one,
   continued to 120: equal to the straight run; (c) ``eval_loss`` graphed
   against eager, two calls; (d) rates, printed and not held: graphed and
   eager steps/s, float32 and bfloat16 (50 steps after 20), kernels a step,
   device-busy ms and idle share over 20 steps under ``torch.profiler``,
   and the memory of the first calls of the trainer's three graphs (the
   step, the evaluation, ``sample``'s reverse step).

Earlier lines carry the numbers (one ``{"kernels": [...]}`` JSON line among
them); the last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, the script exits non-zero and
prints no result.
"""

import contextlib
import gc
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
# Phase 13: the staged villin and protein-G weights at bench.py's protein
# settings (its protein-G noise level t=5, which villin shares; the
# molecules' data std and temperatures).
VILLIN = dict(name="chain35", label="villin", n=35, nf=128, norm=6.082900047302246, temp=360,
              t_noise=5)
PROTEIN_G = dict(name="chain56", label="protein_g", n=56, nf=128, norm=6.354289531707764,
                 temp=350, t_noise=5)
BF16_CHAINS = 100

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
# Phase 12: two ranks share the card, so each gives a kernel half of a run's
# chains (MESH_RANKS is not the card count: the machine has one GPU).
MESH_RANKS = 2
MESH_CLI_CHAINS = 999  # --parallel_sim of the 2-rank CLI run, padded to 1000
MESH_TRAIN_STEPS = 12  # both EMA variants of the update graph replay (calls 0 and 10)
MESH_GRAD_STEPS = 2  # the steps whose gradients are held against one rank's
MESH_TRAIN_FRAMES = 4000
MESH_TRP_STEPS = 10
MESH_RANK_TIMEOUT_S = 300  # a 2-rank world, start-up and kernel loads included
# The 2-rank gradient (a sum over gloo, then / 2) against one rank's, per
# step and leaf, relative to the larger of the leaf's largest entry and 1e-2
# of the largest entry of any leaf: the rule and the 1e-4 of the training
# tests (tests/test_torch_train.py), float32 sums taken in another order.
# The weights are not held to it: Adam's first steps move an entry by about
# lr * g / |g|, so an entry whose gradient is zero in exact arithmetic (the
# key bias: softmax ignores a shift shared by all keys) moves by +-lr on its
# rounding noise, whatever the summation order; they are held bit for bit
# across the ranks.
TOL_MESH_TRAIN_REL = 1e-4
K1_CHAINS = sorted({AGREE_BATCH, *CHAINS, ANCESTRAL_BATCH, DDIM_BATCH,
                    TRP_CHAINS // MESH_RANKS, DDIM_BATCH // MESH_RANKS})
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
CORE_SHAPES = (*((20, b) for b in sorted({AGREE_BATCH, TRP_CHAINS, TRP_DDIM_BATCH,
                                          TRP_CHAINS // MESH_RANKS})),
               (28, 256), (11, 3))
# Chain counts at which K2 and K3 are timed at trp-cage width: where the path
# gate starts sending chains to the attention core, and the Langevin runs'.
CORE_TIMED_CHAINS = (AGREE_BATCH, TRP_CHAINS)
# The graphed clx evaluation against the eager one: the same kernels in the
# same order give the same bits unless cuBLAS picks another algorithm under
# capture; then within this, relative to the largest force.
TOL_GRAPH_REL = 1e-6
# The fused force kernel for every edge configuration (K4).
K4_TIMED_STEPS = 500
K4_DDIM_BATCH = 1024
K4_CHAINS = sorted({AGREE_BATCH, *CHAINS, K4_DDIM_BATCH})
# The sampling CLI's runs (phase 9), each on a copy of a staged results
# directory: (artifact, beads, flags, Langevin force path, sampler kernel).
# Every chain count and batch is one phase 2 holds the kernel at: 1000 and
# 1024 chains for chignolin and trp-cage, CLI_SMALL_CHAINS for alanine
# dipeptide, villin and protein G.
CLI_SMALL_CHAINS = 100
CLI_T = 20 / 1000  # the CLI's default --noise_level over T
_SMALL_RUN = ["--parallel_sim", str(CLI_SMALL_CHAINS), "--batch_size_gen", str(CLI_SMALL_CHAINS),
              "--n_timesteps", "200", "--save_interval", "100", "--sample_steps", "20"]
CLI_RUNS = (
    ("chain10", 10, ["--gen_mode", "langevin", "--fused", "auto", "--parallel_sim", "1000",
                     "--batch_size_gen", "1000", "--n_timesteps", "1000", "--save_interval",
                     "250", "--sample_steps", "100"], "cl", "cl"),
    ("chain10", 10, ["--gen_mode", "iid", "--fused", "auto", "--sample_steps", "100",
                     "--num_samples_eval", "4096", "--batch_size_gen", "1024"], None, "cl"),
    ("chain20", 20, ["--gen_mode", "langevin", "--fused", "auto", "--parallel_sim", "1000",
                     "--batch_size_gen", "1000", "--n_timesteps", "500", "--sample_steps",
                     "100"], "clx", "clx"),
    ("ala5", 5, ["--gen_mode", "langevin", "--fused", "auto", *_SMALL_RUN], "cl", "cl"),
    ("chain35", 35, ["--gen_mode", "langevin", "--fused", "always", *_SMALL_RUN], "always",
     "packed"),
    ("chain56", 56, ["--gen_mode", "langevin", "--fused", "always", *_SMALL_RUN], "always",
     "packed"),
)
# Launches of (K1, K2, K3, K4) for one score evaluation on each path.
PER_CALL = {"cl": (1, 0, 0, 0), "clx": (0, 3, 3, 0), "always": (0, 0, 0, 1),
            "packed": (0, 0, 0, 1), "never": (0, 0, 0, 0)}


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


def start_state(chains, n, norm_factor):
    """The seeded random start of every Langevin run here, in data units."""
    rng = np.random.default_rng(0)
    init = rng.normal(size=(chains, n, 3)).astype(np.float32)
    return (init - init.mean(axis=1, keepdims=True)) * norm_factor


def make_sim(gd, params, spec, chains, fused, n_timesteps, save_interval, dev, mesh=None,
             bf16=False, friction=1.0):
    """bench.py's Langevin settings (dt 2e-3 ps, masses 12, friction 1,
    restraint_k 50, max_force 1e3) from a seeded random start; ``mesh``
    shards the chains over its ranks; ``friction=None`` is overdamped."""
    from twoforone_torch.dynamics.langevin import LangevinDiffusion

    return LangevinDiffusion(
        gd, params, start_state(chains, spec["n"], gd.norm_factor), n_timesteps=n_timesteps,
        save_interval=save_interval, t=spec["t_noise"], temp_data=spec["temp"],
        temp_sim=spec["temp"], dt=2e-3, masses=[12.0] * spec["n"], friction=friction,
        kb="consistent", random_seed=0, steps_per_chunk=1000, log=False, fused=fused,
        bf16=bf16, restraint_k=50.0, max_force=1e3, device=dev, mesh=mesh,
    )


def timed_run(ld, warmup, steps):
    """steps/s of ``steps`` Langevin steps after ``warmup`` steps; also
    whether every coordinate stayed finite."""
    if warmup:
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


@contextlib.contextmanager
def timed_cli(cli, seen):
    """The sampling CLI module ``cli`` with its Langevin engine and its
    i.i.d. sampling timed (synchronized) into ``seen``, beside the force path
    and the sampler kernel they took."""

    class TimedLangevin(cli.LangevinDiffusion):
        def sample(self, reference_temp=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().sample(reference_temp)
            torch.cuda.synchronize()
            seen.update(langevin_s=time.perf_counter() - t0, path=self.force_fn.mode)
            return out

    def recorded_sampling(sample_fn, *args, **kwargs):
        seen["kernel"] = sample_fn.kernel
        t0 = time.perf_counter()
        out = plain_sampling(sample_fn, *args, **kwargs)
        seen["sampling_s"] = seen.get("sampling_s", 0.0) + time.perf_counter() - t0
        return out

    plain_langevin, plain_sampling = cli.LangevinDiffusion, cli.sample_from_model
    cli.LangevinDiffusion, cli.sample_from_model = TimedLangevin, recorded_sampling
    try:
        yield
    finally:
        cli.LangevinDiffusion, cli.sample_from_model = plain_langevin, plain_sampling


def cli_expected(cli, argv, path, kernel):
    """Phase 9's rule for a CLI run: its parsed arguments, the launches of
    (K1, K2, K3, K4) that its score evaluations and steps make, the frames
    it writes, the samples it draws and its Langevin steps."""
    args = cli.build_parser().parse_args(argv)
    mode = args.gen_mode
    drawn = args.parallel_sim if mode == "langevin" else args.num_samples_eval
    calls = -(-drawn // args.batch_size_gen) * (args.sample_steps or 1000)
    steps = args.n_timesteps if mode == "langevin" else 0
    want = tuple(c * calls + p * steps
                 for c, p in zip(PER_CALL[kernel], PER_CALL.get(path, (0,) * 4)))
    frames = (args.parallel_sim * args.n_timesteps // args.save_interval
              if mode == "langevin" else args.num_samples_eval)
    return args, want, frames, drawn, steps


def cli_numbers(seen, wall, got, args, drawn, steps):
    """The wall seconds, rates and launches of a CLI run."""
    numbers = dict(wall_s=wall, sampling_s=seen["sampling_s"], launches_k1_fwd_bwd_k4=got)
    if args.gen_mode == "langevin":
        numbers.update(langevin_s=seen["langevin_s"], steps_per_s=steps / seen["langevin_s"],
                       chains=args.parallel_sim)
    else:
        numbers["samples_per_s"] = drawn / seen["sampling_s"]
    return numbers


def cli_output_ok(results, mode, out, frames, beads):
    """The JAX CLI's contract for what a run returns and writes: the shape,
    finite values, and the .npy, .pt and .pdb files under ``results``.
    Returns (ok, finite, the PDB read back)."""
    from twoforone_torch.data.pdb import load_pdb

    written = os.path.join(results, f"main_eval_output_{mode}", f"sample-{mode}")
    saved, pt = np.load(f"{written}.npy"), torch.load(f"{written}.pt")
    pdb = load_pdb(f"{written}.pdb")
    finite = bool(np.isfinite(out).all())
    ok = (tuple(out.shape) == (frames, beads, 3) and finite
          and np.array_equal(saved, out) and np.array_equal(pt.numpy(), out)
          and pdb.topology.n_atoms == beads and np.allclose(pdb.xyz, out[0], atol=1e-3))
    return ok, finite, pdb


def cli_phase(reset_counts, add_counts, chignolin_sps):
    """Phase 9: ``twoforone_torch.cli.sample.main`` on a copy of each staged
    results directory of ``CLI_RUNS`` (the CLI writes into ``--model_path``).
    For each run: the resolved force path and sampler kernel, the launch
    counts against the score evaluations, the output's shape (the JAX CLI's
    contract) and finiteness, the three files, the PDB reloaded, the wall
    seconds and the Langevin rate. Returns the rates and the outputs by run."""
    import shutil
    import tempfile

    from twoforone_torch.cli import sample as cli
    from twoforone_torch.utils.artifacts import trained_dir

    seen = {}
    rates, outputs = {}, {}
    with timed_cli(cli, seen):
        for name, beads, flags, path, kernel in CLI_RUNS:
            with tempfile.TemporaryDirectory() as tmp:
                results = os.path.join(tmp, name)
                shutil.copytree(trained_dir(name), results)
                argv = ["--model_path", results, *flags]
                args, want, frames, drawn, steps = cli_expected(cli, argv, path, kernel)
                seen.clear()
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = cli.main(argv)
                wall = time.perf_counter() - t0
                got = add_counts()
                label = f"{name}_{args.gen_mode}"
                rates[label] = cli_numbers(seen, wall, got, args, drawn, steps)
                outputs[label] = out
                files_ok, finite, pdb = cli_output_ok(results, args.gen_mode, out, frames, beads)
                ok = (seen["kernel"] == kernel and seen.get("path") == path and got == want
                      and files_ok)
                extra = "".join(f" {k}={v:.3f}" for k, v in rates[label].items()
                                if isinstance(v, float))
                log(f"phase9 cli {label} {' '.join(flags)}: force_path={seen.get('path')} "
                    f"(want {path}) sampler_kernel={seen['kernel']} (want {kernel}) "
                    f"launches_k1_fwd_bwd_k4={got} (want {want}) shape={tuple(out.shape)} "
                    f"(want {(frames, beads, 3)}) finite={finite} npy_pt_pdb_written=True "
                    f"pdb_atoms={pdb.topology.n_atoms} pdb_residues={pdb.topology.n_residues}"
                    f"{extra} ok={ok}")
                if not ok:
                    fail(f"phase9: the CLI run {label} took another path, launched other "
                         "kernels than its score evaluations, or wrote wrong output")
    ratio = rates["chain10_langevin"]["steps_per_s"] / chignolin_sps
    rates["chain10_langevin"]["over_phase3"] = ratio
    log(f"phase9 chignolin Langevin through the CLI at 1000 chains: "
        f"{rates['chain10_langevin']['steps_per_s']:.2f} steps/s, phase 3 {chignolin_sps:.2f}, "
        f"ratio {ratio:.3f} (not held: host noise around the kernel)")
    return rates, outputs


# Phase 10, training. (a) The trainer at chain10's published configuration
# (read from its config.json: nf 64, 3 layers, batch 512, lr 4e-4 cosine to
# 1e-5, EMA 0.995, data_aug) on synthetic chignolin frames, for TRAIN_STEPS
# steps with an evaluation halfway; then the step alone, timed and profiled.
# (b) The sampling CLI on (a)'s results directory through K1. (c) The train
# CLI on a synthetic protein-G data folder at chain56's widths: the card has
# no matplotlib, so the fast folders' evaluators (which always plot in
# training) cannot run there; protein G is the fast folder the JAX package's
# Evaluator scores no metric for and draws no plot of.
TRAIN_FRAMES = 20_000
TRAIN_STEPS = 200
TRAIN_WARMUP = 20
TRAIN_TIMED = 50
TRAIN_PROFILED = 20
TRAIN_FLOP_STEPS = 5  # eager steps whose products the profiler counts
TRAIN_CLI_RUN = ["--gen_mode", "langevin", "--fused", "auto", "--parallel_sim", "100",
                 "--batch_size_gen", "100", "--n_timesteps", "200", "--save_interval", "100",
                 "--sample_steps", "20"]
PROTEIN_G_FRAMES = 4000
PROTEIN_G_STEPS = 30
PROTEIN_G_EVAL = 20  # one evaluation, which saves the last checkpoint
# Diffusion steps of the protein-G run: its two ancestral chains (the
# evaluation's and the final one) run the plain network eagerly, one score
# call a step; 200 keeps KL-at-T ~4e-6 on its data.
PROTEIN_G_DIFFUSION_STEPS = 200


def timed_steps(trainer, it, gen, warmup=TRAIN_WARMUP, timed=TRAIN_TIMED):
    """ms a training step: ``warmup`` steps (a graphed trainer's first call
    captures), then ``timed`` steps on the host clock, synchronized."""
    for _ in range(warmup):
        trainer._train_step(next(it), gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        trainer._train_step(next(it), gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / timed


def training_phase(reset_counts, add_counts, dev):
    """Phase 10 (a)-(c); returns the numbers it measured and K1's largest
    distance from its plain version on the trained weights."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from twoforone_torch.cli import sample as sample_cli
    from twoforone_torch.cli import train as train_cli
    from twoforone_torch.core.diffusion import GaussianDiffusion
    from twoforone_torch.data.datasets import CGDataset
    from twoforone_torch.data.molecules import FOLDED_PDB_DIR, Molecules
    from twoforone_torch.data.pdb import load_pdb
    from twoforone_torch.data.synthetic import chain10_dataset, chain_dataset, make_chain_components
    from twoforone_torch.evaluate.evaluators import Evaluator
    from twoforone_torch.models import get_model
    from twoforone_torch.ops import fused_score_cl as fcl
    from twoforone_torch.train.trainer import Trainer, batch_iterator
    from twoforone_torch.utils.artifacts import trained_dir
    from twoforone_torch.utils.checkpoint import load_checkpoint
    from twoforone_torch.utils.config import TrainConfig
    from twoforone_torch.utils.convert import params_from_jax

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # ------------------------------------------------------------ (a)
        with open(os.path.join(trained_dir("chain10"), "config.json")) as f:
            published = json.load(f)
        cfg = TrainConfig.from_dict(dict(
            published, results_folder=tmp, tensorboard_folder=os.path.join(tmp, "runs"),
            experiment_name="chain10", train_iter=TRAIN_STEPS, eval_interval=TRAIN_STEPS // 2,
            num_samples_final_eval=published["batch_size"]))
        frames = chain10_dataset(TRAIN_FRAMES, seed=0)
        topology = load_pdb(os.path.join(FOLDED_PDB_DIR, "CLN025-0-c-alpha.pdb")).topology
        cut = (int(0.7 * TRAIN_FRAMES), int(0.8 * TRAIN_FRAMES))
        sets = tuple(CGDataset(d, topology, Molecules.CHIGNOLIN)
                     for d in (frames[:cut[0]], frames[cut[0]:cut[1]], frames[cut[1]:]))
        gd = GaussianDiffusion(model=get_model(cfg, 10), num_atoms=10,
                               timesteps=cfg.diffusion_steps,
                               norm_factor=float(sets[0].data.std()),
                               loss_weights=cfg.loss_weights)
        trainer = Trainer(gd, sets, cfg.mol, cfg, use_tensorboard=False, evaluators=False,
                          device=dev)
        step_fn, metrics = trainer._train_step, []

        def recorded(*args, **kwargs):
            metrics.append(step_fn(*args, **kwargs))
            return metrics[-1]

        trainer._train_step = recorded
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = add_counts()
        trainer._train_step = step_fn
        losses = np.array([float(m["loss"]) for m in metrics])
        kl_max = float(metrics[-1]["kl_max"])
        rf = trainer.results_folder
        written = {name: os.path.exists(os.path.join(rf, name)) for name in (
            "model-last.msgpack", "model-best.msgpack", "config.json", "sample-final_iid.npy")}
        best = load_checkpoint(rf, "best")
        ema_back = params_from_jax(best["ema_params"])
        ema_same = all(torch.equal(ema_back[k].to(dev), v)
                       for k, v in trainer.ema.state_dict().items())
        last_step = int(load_checkpoint(rf, "last")["step"])
        samples = np.load(os.path.join(rf, "sample-final_iid.npy"))
        scores = Evaluator(None, None, mol_name="chignolin").eval(samples, "chip_smoke")
        first, final = float(losses[:50].mean()), float(losses[-50:].mean())
        ok = (len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()) and final < first
              and kl_max <= 1e-4 and all(written.values()) and ema_same
              and last_step == TRAIN_STEPS and launched == (0, 0, 0, 0)
              and samples.shape == (cfg.batch_size, 10, 3) and bool(np.isfinite(samples).all())
              and bool(np.isfinite(scores["PWD JS"])))
        out["chain10_train"] = dict(steps=len(losses), wall_s=wall, loss_first_50=first,
                                    loss_last_50=final, kl_max=kl_max,
                                    best_val_loss=trainer.best_val_loss,
                                    tic_js=scores["TIC JS"], pwd_js=scores["PWD JS"])
        log(f"phase10 (a) chignolin Trainer.train at chain10's published configuration "
            f"(nf {cfg.hidden_features_gnn}, {cfg.num_layers_gnn} layers, batch {cfg.batch_size}, "
            f"lr {cfg.learning_rate} cosine to {cfg.min_lr_cosine_anneal}, EMA {cfg.ema_decay}, "
            f"data_aug {cfg.data_aug}, steps_per_host_loop {cfg.steps_per_host_loop}): "
            f"steps={len(losses)} wall_s={wall:.2f} (evaluation at {TRAIN_STEPS // 2} and the "
            f"final 1000-step sampling included) loss_first_50={first:.4f} "
            f"loss_last_50={final:.4f} all_finite={bool(np.isfinite(losses).all())} "
            f"kl_max={kl_max:.3e} best_val_loss={trainer.best_val_loss:.4f} "
            f"written={written} last_step={last_step} ema_read_back_same_bits={ema_same} "
            f"launches_k1_fwd_bwd_k4={launched} (want none: training runs no kernel) "
            f"final_samples={samples.shape} golden_pwd_js={scores['PWD JS']:.4f} "
            f"golden_tic_js={scores['TIC JS']:.4f} (not held: synthetic frames may fall "
            f"outside the chignolin TICA histogram, which gives nan) ok={ok}")
        if not ok:
            fail("phase10 (a): the training run failed a check")

        it = batch_iterator(sets[0].data, cfg.batch_size, seed=1)
        gen = torch.Generator(dev).manual_seed(5)
        step_ms = timed_steps(trainer, it, gen)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRAIN_PROFILED):
                trainer._train_step(next(it), gen)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
        kernels, n_kernels = {}, 0
        for ev in prof.events():  # kernels, not the annotations that span them
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(ev, "is_user_annotation", False)):
                kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time / 1e3
                n_kernels += 1
        busy_ms = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        graphs, trainer._step_graphs = trainer._step_graphs, None
        eager_ms = timed_steps(trainer, it, gen)
        # The profiler's count of the products (matrix multiplies), the bulk
        # of a step's arithmetic; elementwise work is not counted. It counts
        # the operators the host runs, so it is read from eager steps (a
        # replay runs none).
        with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
            for _ in range(TRAIN_FLOP_STEPS):
                trainer._train_step(next(it), gen)
        flops = sum(e.flops for e in prof.key_averages()) / TRAIN_FLOP_STEPS
        trainer._step_graphs = graphs
        out["chain10_step"] = dict(
            ms_per_step=step_ms, steps_per_s=1e3 / step_ms, batch=cfg.batch_size,
            eager_ms_per_step=eager_ms, eager_steps_per_s=1e3 / eager_ms,
            gflop_per_step=flops / 1e9, bound_ms=flops / PEAK_FP32_FLOPS * 1e3,
            profiled_ms_per_step=profiled_ms / TRAIN_PROFILED,
            device_busy_ms_per_step=busy_ms / TRAIN_PROFILED,
            device_idle_share=max(0.0, 1.0 - busy_ms / profiled_ms),
            kernels_per_step=n_kernels / TRAIN_PROFILED,
            top_kernels_ms_per_step={k[:70]: v / TRAIN_PROFILED for k, v in top})
        log(f"phase10 (a) chignolin training step, batch {cfg.batch_size}, after "
            f"{TRAIN_WARMUP} warm-up steps, replayed from its CUDA graphs: "
            f"ms_per_step={step_ms:.4f} steps_per_s={1e3 / step_ms:.2f} (eager: "
            f"ms_per_step={eager_ms:.4f} steps_per_s={1e3 / eager_ms:.2f}) "
            f"gflop_per_step={flops / 1e9:.2f} "
            f"(the profiler's count of the products) "
            f"fp32_bound_ms={flops / PEAK_FP32_FLOPS * 1e3:.4f}; "
            f"torch.profiler over {TRAIN_PROFILED} graphed steps: "
            + json.dumps({k: v for k, v in out["chain10_step"].items()
                          if "ms_per_step" not in k and "steps_per_s" not in k}))

        # ------------------------------------------------------------ (b)
        seen = {}

        class RecordedLangevin(sample_cli.LangevinDiffusion):
            def sample(self, reference_temp=None):
                seen["path"] = self.force_fn.mode
                return super().sample(reference_temp)

        def recorded_sampling(sample_fn, *args, **kwargs):
            seen["kernel"] = sample_fn.kernel
            return plain_sampling(sample_fn, *args, **kwargs)

        plain_langevin, plain_sampling = sample_cli.LangevinDiffusion, sample_cli.sample_from_model
        sample_cli.LangevinDiffusion, sample_cli.sample_from_model = (RecordedLangevin,
                                                                      recorded_sampling)
        argv = ["--model_path", rf, *TRAIN_CLI_RUN]
        args = sample_cli.build_parser().parse_args(argv)
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            traj = sample_cli.main(argv)
            wall = time.perf_counter() - t0
            got = add_counts()
        finally:
            sample_cli.LangevinDiffusion, sample_cli.sample_from_model = (plain_langevin,
                                                                          plain_sampling)
        want = (args.n_timesteps + args.sample_steps, 0, 0, 0)
        frames_out = args.parallel_sim * args.n_timesteps // args.save_interval
        ok = (seen.get("path") == "cl" and seen.get("kernel") == "cl" and got == want
              and traj.shape == (frames_out, 10, 3) and bool(np.isfinite(traj).all()))
        log(f"phase10 (b) cli.sample on the results directory trained in (a) "
            f"{' '.join(TRAIN_CLI_RUN)}: force_path={seen.get('path')} (want cl) "
            f"sampler_kernel={seen.get('kernel')} (want cl) launches_k1_fwd_bwd_k4={got} "
            f"(want {want}: the steps and the sampler's score calls) shape={traj.shape} "
            f"finite={bool(np.isfinite(traj).all())} wall_s={wall:.2f} ok={ok}")
        if not ok:
            fail("phase10 (b): the trained weights did not sample through K1 as asked")
        out["chain10_cli_sample"] = dict(wall_s=wall, launches_k1=got[0])

        gd_trained, params, _, _ = sample_cli.load_model(rf, "best", device=dev)
        fw = fcl.augment_params_cl(gd_trained.model, params, dev)
        k1_err = 0.0
        for label, t in (("fixed", args.noise_level / 1000), ("runtime", 0.37)):
            x = normal(10 + len(label), (args.parallel_sim, 10, 3), dev)
            got_f, ref = fcl.fused_force_cl(x, t, fw), fcl.fused_force_cl_reference(x, t, fw)
            err, scale = (got_f - ref).abs().max().item(), ref.abs().max().item()
            ok = bool(torch.isfinite(got_f).all()) and err <= TOL_REL * scale
            log(f"phase10 (b) fused_force_cl on the weights trained in (a) "
                f"chains={args.parallel_sim} t={label}:{t} max_abs_err={err:.3e} "
                f"max_rel_err={err / scale:.3e} tol_rel={TOL_REL} ok={ok}")
            if not ok:
                fail("phase10 (b): K1 disagrees with its plain version on the trained weights")
            k1_err = max(k1_err, err)

        # ------------------------------------------------------------ (c)
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        protein_g = chain_dataset(PROTEIN_G_FRAMES, make_chain_components(53, n_slow=5, seed=13),
                                  seed=0)
        np.save(os.path.join(data, f"{Molecules.PROTEIN_G.value}-0-c-alpha.npy"),
                protein_g / 10.0)  # nm, as the loader reads it
        with open(os.path.join(trained_dir("chain56"), "config.json")) as f:
            chain56 = json.load(f)
        results = os.path.join(tmp, "cli")
        argv = ["--mol", "protein_g", "--data_folder", data, "--results_folder", results,
                "--tensorboard_folder", os.path.join(tmp, "runs"), "--experiment_name", "cli",
                "--hidden_features_gnn", str(chain56["hidden_features_gnn"]),
                "--num_layers_gnn", str(chain56["num_layers_gnn"]),
                "--use_intrinsic_coords", "true", "--use_abs_coords", "false",
                "--use_distances", "false", "--conservative", "true",
                "--batch_size", str(chain56["batch_size"]),
                "--learning_rate", str(chain56["learning_rate"]),
                "--train_iter", str(PROTEIN_G_STEPS), "--eval_interval", str(PROTEIN_G_EVAL),
                "--num_samples", str(chain56["batch_size"]),
                "--num_samples_final_eval", str(chain56["batch_size"]),
                "--iterations_on_val", "1", "--log_tensorboard_interval", "10",
                "--diffusion_steps", str(PROTEIN_G_DIFFUSION_STEPS)]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_trainer = train_cli.main(argv)
        wall = time.perf_counter() - t0
        launched = add_counts()
        rf = cli_trainer.results_folder
        final = json.load(open(os.path.join(rf, "results-final_iid_val.json")))
        milestone = json.load(open(os.path.join(rf, "results-1_iid.json")))
        samples = np.load(os.path.join(rf, "sample-final_iid.npy"))
        written = all(os.path.exists(os.path.join(rf, f)) for f in (
            "model-best.msgpack", "model-last.msgpack", "config.json"))
        ok = (final == {} and milestone == {} and written and launched == (0, 0, 0, 0)
              and int(load_checkpoint(rf, "last")["step"]) == PROTEIN_G_EVAL
              and samples.shape == (chain56["batch_size"], 56, 3)
              and bool(np.isfinite(samples).all()))
        out["protein_g_cli_train"] = dict(wall_s=wall, steps=PROTEIN_G_STEPS)
        log(f"phase10 (c) cli.train on a synthetic protein-G data folder at chain56's widths "
            f"(nf {chain56['hidden_features_gnn']}, {chain56['num_layers_gnn']} layers, batch "
            f"{chain56['batch_size']}, {PROTEIN_G_DIFFUSION_STEPS} diffusion steps): "
            f"steps={PROTEIN_G_STEPS} wall_s={wall:.2f} (one evaluation and the final "
            f"sampling included) "
            f"results-final_iid_val.json={final} results-1_iid.json={milestone} (protein G: no "
            f"metric, as in the JAX package) checkpoints_and_config_written={written} "
            f"final_samples={samples.shape} finite={bool(np.isfinite(samples).all())} "
            f"launches_k1_fwd_bwd_k4={launched} ok={ok}")
        if not ok:
            fail("phase10 (c): the train CLI run failed a check")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, k1_err


# Phase 11, the positive control's path. (a) The Langevin stage of the chain
# controls on the staged weights, the protocol of the JAX package's
# scripts/backfill_ergodicity.py through the port: the model rebuilt as
# run_chain_control builds it (norm factor: the train split's std at its
# defaults, 400 000 frames at seed 0), initial states drawn by the ancestral
# chain through make_fused_sample_fn(kernel="auto"), then
# _segmented_langevin_stage on the LangevinDiffusion run_chain_control
# builds, scored by its SyntheticTicScorer and the basin-exchange report.
# (b) Segmenting invisible on the card: one sample() against a half-length
# run (the kill) resumed in a fresh LangevinDiffusion, bit for bit. (c)
# run_chain_control at chain10's published widths with a cut budget, and
# its resume. (d) torch.profiler around chignolin steps. (e) The symmetry
# checkers on K1 and on the plain network. (f) kabsch_rmsd on the card.
# Every step count is cut from the staged runs' 50 000; no width is.
CONTROL_NORM_FRAMES = 400_000  # run_chain_control's default n_data
CONTROL_EVAL_SAMPLES = 50_000  # and eval_samples
CONTROL_CHAINS = 1000
# (beads, Langevin steps, save interval, the path fused="auto" must take,
# the sampler's kernel): 40 000 frames each, in 4 segments.
STAGED_CONTROLS = ((10, 10_000, 250, "cl"), (20, 5_000, 125, "clx"))
STAGED_SEGMENTS = 4
TIC_JS_BAR = 0.10  # physics_bars_ok's bar on tic_js_langevin
SEGMENT_CHAINS, SEGMENT_STEPS, SEGMENT_SAVE = 100, 2000, 250
CONTROL_RUN = dict(n_beads=10, train_iter=200, n_data=20_000, num_samples=1024,
                   langevin_chains=1000, langevin_steps=2000, eval_samples=20_000,
                   fused="auto")
# The keys run_chain_control's results carry: the JAX function's
# (tests/test_torch_positive_control.py holds the two sets equal).
CHAIN_CONTROL_KEYS = (
    "langevin_chains", "langevin_dt_scale", "langevin_ergodic", "langevin_max_occupancy_error",
    "langevin_min_hop_fraction", "langevin_steps", "nonfinite_frac_iid",
    "nonfinite_frac_langevin", "pwd_js_iid", "results_folder", "t_noise_langevin",
    "tic_js_floor", "tic_js_iid", "tic_js_langevin", "val_loss",
)
TRACE_STEPS = 20  # traced, after as many untraced
TRACE_SAVE = 10
TOL_EQUIVARIANCE = 1e-4  # of the mean |eps| on the checkers' inputs
TOL_KABSCH = 1e-5  # Angstrom, card against host


def positive_control_phase(reset_counts, add_counts, counts, dev):
    """Phase 11 (a)-(f); returns the numbers it measured."""
    import shutil
    import tempfile

    from twoforone_torch.data.synthetic import chain_trajectory
    from twoforone_torch.dynamics.segmented import segmented_sample
    from twoforone_torch.evaluate.ergodicity import slow_torsion_ergodicity
    from twoforone_torch.evaluate.evaluators import RmsdEvaluator
    from twoforone_torch.ops import fused_score_cl as fcl
    from twoforone_torch.ops.geometry import kabsch_rmsd
    from twoforone_torch.train import positive_control as pc
    from twoforone_torch.train.trainer import Trainer
    from twoforone_torch.utils.artifacts import load_ema_params, load_results
    from twoforone_torch.utils.equivariance import (
        check_reflection_equivariance,
        check_rotation_equivariance,
        check_translation_invariance,
    )
    from twoforone_torch.utils.profiling import PhaseTimer, trace

    timer = PhaseTimer()
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_control_")
    try:
        # ------------------------------------------------------------ (a)
        staged = {}
        for n, steps, save, path in STAGED_CONTROLS:
            name = f"chain{n}"
            comps = pc.chain_control_components(n)
            with timer.phase(f"(a) {name} reference data and scorer (host)"):
                traj = chain_trajectory(CONTROL_NORM_FRAMES, comps, seed=0)
                norm = float(traj[:int(0.7 * CONTROL_NORM_FRAMES)].std())
                del traj
                scorer, floor = pc.chain_control_scorer(comps, CONTROL_NORM_FRAMES,
                                                        CONTROL_EVAL_SAMPLES, seed=0)
            gd = pc.chain_control_diffusion(n, norm)
            params = load_ema_params(name)
            fn = gd.make_fused_sample_fn(params, CONTROL_CHAINS, kernel="auto", device=dev)
            if fn.kernel != path:
                fail(f"phase11 (a) {name}: kernel='auto' resolved to {fn.kernel!r}")
            reset_counts()
            with timer.phase(f"(a) {name} initial states ({path}, ancestral)"):
                init = fn(torch.Generator(device=dev).manual_seed(3)).cpu().numpy()
            sampler = add_counts()
            ld = pc.chain_control_langevin(gd, params, init, n, steps, save, seed=0,
                                           fused="auto", log=False, device=dev)
            if ld.force_fn.mode != path:
                fail(f"phase11 (a) {name}: fused='auto' resolved to {ld.force_fn.mode!r}")
            stage = f"langevin_{name}"
            reset_counts()
            t0 = time.perf_counter()
            with timer.phase(f"(a) {name} Langevin ({path}, segmented)"):
                frames = pc._segmented_langevin_stage(ld, tmp, stage, resume=False,
                                                      segment_steps=steps // STAGED_SEGMENTS)
            wall = time.perf_counter() - t0
            lang = add_counts()
            left = [f for f in os.listdir(tmp) if f.startswith(stage)]
            with timer.phase(f"(a) {name} scoring (host)"):
                finite = bool(np.isfinite(frames).all())
                tic = scorer.tic_js(frames)
                erg = slow_torsion_ergodicity(frames.reshape(CONTROL_CHAINS, -1, n, 3), comps)
            staged_tic = load_results(name)["tic_js_langevin"]
            per_call = PER_CALL[path]
            want_sampler = tuple(c * gd.timesteps for c in per_call)
            want_lang = tuple(c * steps for c in per_call)
            ok = (sampler == want_sampler and lang == want_lang and finite
                  and bool(np.isfinite(init).all()) and tic <= TIC_JS_BAR and not left
                  and frames.shape == (CONTROL_CHAINS * steps // save, n, 3))
            staged[name] = dict(
                norm_factor=norm, tic_js_floor=floor, tic_js_langevin=tic,
                staged_tic_js_langevin=staged_tic,
                langevin_min_hop_fraction=erg["min_hop_fraction"],
                langevin_max_occupancy_error=erg["max_occupancy_error"],
                langevin_ergodic=erg["ergodic"], steps=steps, chains=CONTROL_CHAINS,
                frames=len(frames), langevin_wall_s=wall, steps_per_s=steps / wall, path=path)
            log(f"phase11 (a) {name} staged weights, norm_factor={norm:.6f} path={path} "
                f"initial states: {CONTROL_CHAINS} by the {gd.timesteps}-step ancestral chain, "
                f"launches_k1_fwd_bwd_k4={sampler} (want {want_sampler}); Langevin "
                f"{steps} steps x {CONTROL_CHAINS} chains in {STAGED_SEGMENTS} segments: "
                f"wall_s={wall:.2f} steps_per_s={steps / wall:.2f} launches={lang} (want "
                f"{want_lang}) finite={finite} segment_files_left={left} tic_js_floor={floor:.4f} "
                f"tic_js_langevin={tic:.4f} (bar {TIC_JS_BAR}; staged 50 000-step run "
                f"{staged_tic:.4f}) ergodicity: min_hop_fraction="
                f"{erg['min_hop_fraction']:.3f} max_occupancy_error="
                f"{erg['max_occupancy_error']:.3f} ergodic={erg['ergodic']} "
                f"per_torsion_hops={ {k: round(v['hop_fraction'], 3) for k, v in erg['per_torsion'].items()} } "
                f"ok={ok}")
            if not ok:
                fail(f"phase11 (a) {name}: wrong launch count, a non-finite frame, segment "
                     f"files left, or TIC JS above {TIC_JS_BAR}")
            if n == 10:
                gd10, params10, init10, frames10 = gd, params, init, frames
        out["staged"] = staged

        # ------------------------------------------------------------ (b)
        def segment_ld(steps, save=SEGMENT_SAVE):
            return pc.chain_control_langevin(gd10, params10, init10[:SEGMENT_CHAINS], 10, steps,
                                             save, seed=0, fused="auto", log=False, device=dev)

        folder = os.path.join(tmp, "segments")
        os.makedirs(folder)
        reset_counts()
        with timer.phase("(b) one sample() and a killed, resumed segmented run"):
            one_shot = segment_ld(SEGMENT_STEPS).sample()
            segmented_sample(segment_ld(SEGMENT_STEPS // 2), folder, "lang",
                             segment_steps=SEGMENT_STEPS // 4)
            state = np.load(os.path.join(folder, "lang_state.npz"))
            resumed = segmented_sample(segment_ld(SEGMENT_STEPS), folder, "lang",
                                       segment_steps=SEGMENT_STEPS // 4, resume=True)
        got = add_counts()
        same = bool(np.array_equal(one_shot, resumed))
        want = (2 * SEGMENT_STEPS, 0, 0, 0)
        ok = same and got == want and int(state["t"]) == SEGMENT_STEPS // 2 and \
            state["key"].dtype == np.uint8
        log(f"phase11 (b) chignolin {SEGMENT_CHAINS} chains {SEGMENT_STEPS} steps through K1: "
            f"sample() against a {SEGMENT_STEPS // 2}-step segmented run resumed in a fresh "
            f"LangevinDiffusion: same_bits={same} checkpointed CUDA generator state "
            f"{state['key'].size} bytes at step {int(state['t'])} launches={got} (want {want}) "
            f"ok={ok}")
        if not ok:
            fail("phase11 (b): the resumed segmented run differs from one sample()")

        # ------------------------------------------------------------ (c)
        train = Trainer.train
        during_training = []

        def recorded_train(self):
            train(self)
            during_training.append(counts())

        Trainer.train = recorded_train
        try:
            results_folder = os.path.join(tmp, "chain10_control")
            reset_counts()
            t0 = time.perf_counter()
            with timer.phase("(c) run_chain_control"):
                res = pc.run_chain_control(results_folder=results_folder, device=dev,
                                           **CONTROL_RUN)
            wall = time.perf_counter() - t0
            after = add_counts()
            files = sorted(os.listdir(results_folder))
            post = [f for f in files if f.startswith("post_")]
            arrays = {f: np.load(os.path.join(results_folder, f)) for f in post}
            reset_counts()
            t0 = time.perf_counter()
            with timer.phase("(c) run_chain_control, resume=True"):
                again = pc.run_chain_control(results_folder=results_folder, resume=True,
                                             device=dev, **CONTROL_RUN)
            wall_resume = time.perf_counter() - t0
            resumed_counts = add_counts()
        finally:
            Trainer.train = train
        same = all(np.array_equal(arrays[f], np.load(os.path.join(results_folder, f)))
                   for f in post) and again == res
        finite = all(np.isfinite(v) for k, v in res.items() if k != "results_folder")
        steps = CONTROL_RUN["langevin_steps"]
        ok = (set(res) == set(CHAIN_CONTROL_KEYS) and finite
              and during_training == [(0, 0, 0, 0), (0, 0, 0, 0)]
              and after == (steps, 0, 0, 0) and resumed_counts == (0, 0, 0, 0) and same
              and "post_iid.npy" in post and any(f.startswith("post_langevin_") for f in post)
              and not [f for f in files if "_seg" in f or "_state" in f])
        out["run_chain_control"] = dict(res, wall_s=wall, resume_wall_s=wall_resume)
        log(f"phase11 (c) run_chain_control({CONTROL_RUN}) wall_s={wall:.2f} "
            f"results={json.dumps({k: v for k, v in res.items() if k != 'results_folder'})} "
            f"keys_equal_jax={set(res) == set(CHAIN_CONTROL_KEYS)} finite={finite} "
            f"launches_in_training={during_training[0]} launches_total={after} "
            f"(want ({steps}, 0, 0, 0)) post_files={post}; resume=True: wall_s="
            f"{wall_resume:.2f} launches={resumed_counts} same_arrays_and_results={same} "
            f"ok={ok}")
        if not ok:
            fail("phase11 (c): run_chain_control failed a check")

        # ------------------------------------------------------------ (d)
        ld = segment_ld(2 * TRACE_STEPS, TRACE_SAVE)
        ld.sim.simulate(sub_interval=TRACE_STEPS)  # warm-up outside the trace
        logdir = os.path.join(tmp, "trace")
        reset_counts()
        with timer.phase("(d) traced chignolin steps"), trace(logdir) as prof:
            ld.sim.simulate(sub_interval=TRACE_STEPS)
            torch.cuda.synchronize()
        got = add_counts()
        path = os.path.join(logdir, "trace.json")
        with open(path) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        k1_events = [e for e in prof.key_averages() if "fused_force_cl_kernel" in e.key]
        k1_calls = sum(e.count for e in k1_events)
        k1_device_ms = sum(e.device_time_total for e in k1_events) / 1e3
        # The launch counters say how many steps ran; the profiler's own count
        # may miss a kernel at the start of its window (19 of 20 seen once).
        ok = ("fused_force_cl_kernel" in " ".join(str(n) for n in names)
              and got == (TRACE_STEPS, 0, 0, 0) and k1_calls >= 1)
        out["trace"] = dict(bytes=os.path.getsize(path), k1_calls=k1_calls,
                            k1_device_ms_per_call=k1_device_ms / max(1, k1_calls))
        log(f"phase11 (d) trace() around {TRACE_STEPS} chignolin steps through K1 "
            f"({SEGMENT_CHAINS} chains): trace.json {os.path.getsize(path)} bytes names K1's "
            f"kernel: {'fused_force_cl_kernel' in ' '.join(str(n) for n in names)}; "
            f"key_averages: {k1_calls} K1 calls, device ms a call "
            f"{k1_device_ms / max(1, k1_calls):.4f}; launches={got} ok={ok}")
        if not ok:
            fail("phase11 (d): the trace misses K1's kernel or the launch count is wrong")

        # ------------------------------------------------------------ (e)
        folded = fcl.augment_params_cl(gd10.model, params10, dev)
        plain = gd10.score_fn(params10, dev)

        def k1(x, t):
            return fcl.fused_force_cl(x, t[0], folded)

        gaps = {}
        with timer.phase("(e) symmetry checkers, K1 and plain"):
            for label, fn in (("k1", k1), ("plain", plain)):
                gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
                with torch.no_grad():
                    gaps[label] = dict(
                        translation=check_translation_invariance(fn, 10, gen()),
                        rotation=check_rotation_equivariance(fn, 10, gen()),
                        reflection=check_reflection_equivariance(fn, 10, gen()))
            x = torch.randn((256, 10, 3), generator=torch.Generator(device=dev).manual_seed(0),
                            device=dev)
            scale = k1(x, torch.full((256,), 0.5, device=dev)).abs().mean().item()
        tol = TOL_EQUIVARIANCE * scale
        diffs = [abs(gaps["k1"]["rotation"] - gaps["plain"]["rotation"]),
                 *(abs(a - b) for a, b in zip(gaps["k1"]["reflection"],
                                              gaps["plain"]["reflection"]))]
        ok = gaps["k1"]["translation"] <= tol and max(diffs) <= tol
        out["equivariance"] = dict(gaps, mean_abs_eps=scale)
        log(f"phase11 (e) symmetry checkers on chain10's score at t=0.5, 256 chains, the same "
            f"generator seed: K1 {gaps['k1']} plain {gaps['plain']} mean|eps|={scale:.4f}; "
            f"held: K1 translation gap <= {tol:.2e} and K1's rotation and reflection gaps within "
            f"{tol:.2e} of the plain network's (largest difference {max(diffs):.2e}; "
            f"intrinsic-coordinate edges are not rotation-invariant, so the rotation gap itself "
            f"is not held) ok={ok}")
        if not ok:
            fail("phase11 (e): K1 breaks translation invariance or its symmetry gaps differ "
                 "from the plain network's")

        # ------------------------------------------------------------ (f)
        ev = RmsdEvaluator("chignolin")
        with timer.phase("(f) kabsch_rmsd, card and host"):
            ref = torch.from_numpy(ev.folded.xyz)
            host = kabsch_rmsd(torch.from_numpy(frames10), ref)
            card = kabsch_rmsd(torch.from_numpy(frames10).to(dev), ref.to(dev)).cpu()
            err = (card - host).abs().max().item()
            curve = ev.eval("langevin", frames10)
        ok = err <= TOL_KABSCH and bool(torch.isfinite(card).all())
        out["kabsch"] = dict(frames=len(frames10), max_abs_diff=err)
        log(f"phase11 (f) kabsch_rmsd of (a)'s {len(frames10)} chignolin frames to the folded "
            f"chignolin structure, card (cuSOLVER) against host: max_abs_diff={err:.2e} A "
            f"(tol {TOL_KABSCH}) RMSD median={host.median().item():.3f} A; "
            f"RmsdEvaluator('chignolin').eval: {int(np.isfinite(curve['energies']).sum())} of "
            f"{len(curve['energies'])} bins populated up to {curve['bin_mids'][-1]:.2f} A "
            f"(no plot) ok={ok}")
        if not ok:
            fail("phase11 (f): kabsch_rmsd on the card disagrees with the host")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report = timer.report()
    log("phase11 PhaseTimer:\n" + report)
    out["phases_s"] = dict(timer.totals)
    return out


# ------------------------------------------------------------------ phase 14
# The port as a user installs it: a wheel of the checkout, unpacked into a
# directory of its own, and three of phase 9's runs through its console script
# in a process that imports the port from there and builds the kernels from
# the shipped sources into a fresh TFO_KERNEL_CACHE: chain10 Langevin (K1),
# chain20 (clx: K2, K3) and chain35 with --fused always (K4), with phase 9's
# flags, so that chain10's output is held to phase 9's bit for bit.
INSTALLED_RUNS = tuple(CLI_RUNS[i] for i in (0, 2, 4))
LIBRARIES = ("fused_score", "fused_score_cl", "attention_cl_core")
CONSOLE_SCRIPTS = {"tfo-torch-sample": "twoforone_torch.cli.sample:console_main",
                   "tfo-torch-train": "twoforone_torch.cli.train:console_main"}
WHEEL_TIMEOUT_S = 300
INSTALLED_TIMEOUT_S = 600  # three cold builds, one after another, and the runs


def not_shipped(folder, names):
    """What the wheel's source copy leaves out: built libraries, byte code
    and the staged weights (no package data; the runs read them by path)."""
    return {n for n in names if n in ("_build", "__pycache__")
            or (n == "trained" and os.path.basename(folder) == "assets")}


def tree_state(root):
    """Every file and directory under ``root`` with its size and mtime."""
    state = {}
    for folder, dirs, files in os.walk(root):
        for n in dirs + files:
            st = os.stat(os.path.join(folder, n))
            state[os.path.relpath(os.path.join(folder, n), root)] = (st.st_size, st.st_mtime_ns)
    return state


def build_wheel(tmp):
    """A wheel of this checkout, built by pip from a copy in ``tmp`` (the
    build leaves ``build/`` and ``*.egg-info`` beside its source); returns
    its path and the seconds pip took."""
    import glob
    import shutil

    repo = os.path.dirname(os.path.abspath(__file__))
    src, out = os.path.join(tmp, "src"), os.path.join(tmp, "wheel")
    os.makedirs(src)
    shutil.copy(os.path.join(repo, "pyproject.toml"), src)
    for package in ("twoforone_tpu", "twoforone_torch"):
        shutil.copytree(os.path.join(repo, package), os.path.join(src, package),
                        ignore=not_shipped)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", src, "--no-deps", "--no-build-isolation",
         "--no-index", "--no-cache-dir", "--disable-pip-version-check", "-w", out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=WHEEL_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase14: pip could not build a wheel of the checkout:\n{proc.stdout[-6000:]}")
    (wheel,) = glob.glob(os.path.join(out, "*.whl"))
    return wheel, seconds


def installed_phase(cli_outputs, cli_rates):
    """Phase 14: the port from an installed copy. Builds a wheel of the
    checkout, checks that it ships every kernel source and header and the
    port's console scripts, unpacks it, and runs ``INSTALLED_RUNS`` through
    the ``tfo-torch-sample`` entry point in a process whose ``PYTHONPATH`` is
    the unpacked wheel, whose working directory is a temporary one and whose
    ``TFO_KERNEL_CACHE`` is a fresh directory (``installed_run_main``).
    Holds: the port imported from the wheel, the three libraries built there
    and nothing written inside the installed package, launches equal to the
    score calls and steps (phase 9's rule), the JAX CLI's outputs, and
    chain10's output equal to phase 9's bit for bit. Returns its numbers and
    the launches of (K1, K2, K3, K4) in the process."""
    import configparser
    import shutil
    import tempfile
    import zipfile

    from twoforone_torch.cli import sample as cli
    from twoforone_torch.utils.artifacts import trained_dir

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        wheel, wheel_s = build_wheel(tmp)
        site = os.path.join(tmp, "installed")
        with zipfile.ZipFile(wheel) as z:
            names = set(z.namelist())
            z.extractall(site)
            (eps,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
            scripts = configparser.ConfigParser()
            scripts.read_string(z.read(eps).decode())
        csrc = sorted(f"twoforone_torch/ops/csrc/{f}"
                      for f in os.listdir(os.path.join(repo, "twoforone_torch", "ops", "csrc")))
        shipped = {n: n in names for n in csrc}
        console = {k: scripts["console_scripts"].get(k) for k in CONSOLE_SCRIPTS}
        ok = all(shipped.values()) and console == CONSOLE_SCRIPTS
        log(f"phase14 wheel {os.path.basename(wheel)} built_s={wheel_s:.2f} "
            f"files={len(names)} csrc_shipped={shipped} console_scripts={console} ok={ok}")
        if not ok:
            fail("phase14: the wheel lacks a kernel source or header, or the port's "
                 "console scripts")

        cache, work = os.path.join(tmp, "kernel_cache"), os.path.join(tmp, "work")
        os.makedirs(cache)
        os.makedirs(work)
        runs = []
        for name, beads, flags, path, kernel in INSTALLED_RUNS:
            results = os.path.join(tmp, "runs", name)
            shutil.copytree(trained_dir(name), results)
            runs.append(["--model_path", results, *flags])
        spec = os.path.join(tmp, "spec.json")
        result_path = os.path.join(tmp, "result.json")
        with open(spec, "w") as f:
            json.dump(dict(runs=runs, result=result_path), f)
        package = os.path.join(site, "twoforone_torch")
        before = tree_state(package)
        env = dict(os.environ, PYTHONPATH=site, TFO_KERNEL_CACHE=cache,
                   PYTHONDONTWRITEBYTECODE="1")
        # -P: the script's own directory, the checkout, is not put on sys.path.
        cmd = [sys.executable, "-P", os.path.abspath(__file__), "--installed-run", spec]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=work, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, timeout=INSTALLED_TIMEOUT_S)
        process_s = time.perf_counter() - t0
        if proc.returncode != 0:
            print(f"--- phase14 installed process\n{proc.stdout[-12000:]}", file=sys.stderr)
            fail(f"phase14: the installed copy's process exited {proc.returncode}")
        with open(result_path) as f:
            got = json.load(f)
        untouched = tree_state(package) == before
        real_site = os.path.realpath(site) + os.sep
        from_site = all(os.path.realpath(got[k]).startswith(real_site)
                        for k in ("module", "cli_module"))
        libraries = got["libraries"]
        built_s = {n: s for r in got["runs"] for n, s in r["built_s"].items()}
        in_cache = (got["build_dir"] == cache and sorted(built_s) == sorted(LIBRARIES)
                    and all(os.path.dirname(p) == cache and os.path.isfile(p)
                            for p in libraries.values())
                    and sorted(os.listdir(cache)) == sorted(map(os.path.basename,
                                                                libraries.values())))
        ok = (from_site and got["dist_root"] == os.path.realpath(site) and in_cache
              and untouched and got["entry_point"] == CONSOLE_SCRIPTS["tfo-torch-sample"])
        log(f"phase14 installed copy: twoforone_torch={got['module']} "
            f"entry_point=tfo-torch-sample -> {got['entry_point']} from {got['dist_root']} "
            f"from_wheel={from_site} process_s={process_s:.2f}")
        log(f"phase14 kernel builds from the installed sources, on first use: "
            + " ".join(f"{n}={s:.2f}s" for n, s in sorted(built_s.items()))
            + f" build_dir={got['build_dir']} (TFO_KERNEL_CACHE) libraries_there={in_cache} "
            f"nothing_written_in_the_installed_package={untouched} ok={ok}")
        if not ok:
            fail("phase14: the installed copy imported the checkout, built its kernels "
                 "elsewhere than TFO_KERNEL_CACHE, or wrote inside the installed package")

        numbers = dict(wheel_s=wheel_s, process_s=process_s, build_s=built_s, runs={})
        total, outs = [0, 0, 0, 0], {}
        for (name, beads, flags, path, kernel), argv, run in zip(INSTALLED_RUNS, runs,
                                                                   got["runs"]):
            args, want, frames, drawn, steps = cli_expected(cli, argv, path, kernel)
            label = f"{name}_{args.gen_mode}"
            counts = tuple(run["counts"])
            total = [a + b for a, b in zip(total, counts)]
            out = outs[label] = np.load(os.path.join(
                argv[1], f"main_eval_output_{args.gen_mode}", f"sample-{args.gen_mode}.npy"))
            files_ok, finite, _ = cli_output_ok(argv[1], args.gen_mode, out, frames, beads)
            rate = cli_numbers(run, run["wall_s"], counts, args, drawn, steps)
            rate["phase9_steps_per_s"] = cli_rates[label]["steps_per_s"]
            numbers["runs"][label] = rate
            ok = (run["rc"] == 0 and run["kernel"] == kernel and run.get("path") == path
                  and counts == want and files_ok)
            log(f"phase14 installed tfo-torch-sample {label} {' '.join(flags)}: "
                f"exit={run['rc']} force_path={run.get('path')} (want {path}) "
                f"sampler_kernel={run['kernel']} (want {kernel}) launches_k1_fwd_bwd_k4="
                f"{counts} (want {want}: score calls and steps) shape={tuple(out.shape)} "
                f"finite={finite} files_ok={files_ok} wall_s={run['wall_s']:.3f} "
                f"steps_per_s={rate['steps_per_s']:.2f} (phase 9 "
                f"{rate['phase9_steps_per_s']:.2f}) ok={ok}")
            if not ok:
                fail(f"phase14: the installed run {label} took another path, launched other "
                     "kernels than its score evaluations, or wrote wrong output")
        ref, out = cli_outputs["chain10_langevin"], outs["chain10_langevin"]
        same = out.dtype == ref.dtype and out.shape == ref.shape and out.tobytes() == ref.tobytes()
        log(f"phase14 chain10 Langevin from the installed copy equals phase 9's output "
            f"bit for bit: {same}")
        if not same:
            fail("phase14: the installed copy's chain10 run differs from phase 9's")
    return numbers, tuple(total)


def installed_run_main(spec_path):
    """The process of phase 14, started by ``installed_phase`` with the
    unpacked wheel as ``PYTHONPATH``: loads the ``tfo-torch-sample`` console
    script through the installed distribution's entry points and calls it,
    as its wrapper would, on each run of the spec with the counters set to 0
    just before; writes where the port came from, the build directory, the
    libraries and each run's exit value, launches, build seconds and times
    to the spec's result file."""
    from importlib.metadata import entry_points

    import twoforone_torch
    from twoforone_torch.cli import sample as cli
    from twoforone_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    (ep,) = entry_points(group="console_scripts", name="tfo-torch-sample")
    script = ep.load()
    seen, runs = {}, []
    with timed_cli(cli, seen):
        for argv in spec["runs"]:
            seen.clear()
            built_before = set(_build.seconds)
            zero_counts()
            sys.argv = ["tfo-torch-sample", *argv]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = script()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append(dict(seen, rc=rc, wall_s=wall, counts=kernel_counts(),
                             built_s={n: _build.seconds[n]
                                      for n in set(_build.seconds) - built_before}))
    with open(spec["result"], "w") as f:
        json.dump(dict(module=twoforone_torch.__file__, cli_module=cli.__file__,
                       entry_point=ep.value,
                       dist_root=os.path.realpath(ep.dist.locate_file("")),
                       build_dir=_build.build_dir(),
                       libraries={n: _build.library_path(n) for n in LIBRARIES},
                       runs=runs), f)
    return 0


# ------------------------------------------------------------------ phase 12
def kernel_counts():
    """Launches of (K1, K2, K3, K4) since the counters were last set to 0."""
    from twoforone_torch.ops import attention_cl_core as acc
    from twoforone_torch.ops import fused_score as fsc
    from twoforone_torch.ops import fused_score_cl as fcl

    return (fcl.fused_force_cl.launches, acc.cl_attention_core.launches_fwd,
            acc.cl_attention_core.launches_bwd, fsc.fused_force.launches)


def zero_counts():
    from twoforone_torch.ops import attention_cl_core as acc
    from twoforone_torch.ops import fused_score as fsc
    from twoforone_torch.ops import fused_score_cl as fcl

    fcl.fused_force_cl.launches = fsc.fused_force.launches = 0
    acc.cl_attention_core.launches_fwd = acc.cl_attention_core.launches_bwd = 0


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def langevin_kept(ld, warmup, steps):
    """Phase 3's timed run that keeps the trajectory: ``warmup`` steps, then
    ``steps`` timed; returns (steps/s of the timed part, the whole saved
    trajectory)."""
    first = ld.sim.simulate(sub_interval=warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rest = ld.sim.simulate(sub_interval=steps)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0), np.concatenate([first, rest], axis=1)


def mesh_trainer(dev, folder, mesh=None):
    """A Trainer at chain10's published configuration (batch 512) on
    synthetic chignolin frames, with the global batches of
    MESH_TRAIN_STEPS steps as MESH_RANKS ranks draw them (rank r from its
    iterator seeded seed + 7919 r, rank-major). Its results folder is
    under ``folder``; nothing is written there."""
    from twoforone_torch.core.diffusion import GaussianDiffusion
    from twoforone_torch.data.datasets import CGDataset
    from twoforone_torch.data.molecules import FOLDED_PDB_DIR, Molecules
    from twoforone_torch.data.pdb import load_pdb
    from twoforone_torch.data.synthetic import chain10_dataset
    from twoforone_torch.models import get_model
    from twoforone_torch.train.trainer import Trainer, batch_iterator
    from twoforone_torch.utils.artifacts import trained_dir
    from twoforone_torch.utils.config import TrainConfig

    with open(os.path.join(trained_dir("chain10"), "config.json")) as f:
        published = json.load(f)
    cfg = TrainConfig.from_dict(dict(published, results_folder=folder,
                                     tensorboard_folder=folder))
    frames = chain10_dataset(MESH_TRAIN_FRAMES, seed=0)
    topology = load_pdb(os.path.join(FOLDED_PDB_DIR, "CLN025-0-c-alpha.pdb")).topology
    sets = tuple(CGDataset(d, topology, Molecules.CHIGNOLIN)
                 for d in (frames[:3000], frames[3000:3500], frames[3500:]))
    gd = GaussianDiffusion(model=get_model(cfg, 10), num_atoms=10,
                           timesteps=cfg.diffusion_steps, norm_factor=float(frames.std()),
                           loss_weights=cfg.loss_weights)
    trainer = Trainer(gd, sets, cfg.mol, cfg, mesh=mesh, use_tensorboard=False,
                      evaluators=False, device=dev)
    its = [batch_iterator(np.asarray(sets[0].data), cfg.batch_size // MESH_RANKS,
                          seed=cfg.seed + 7919 * r) for r in range(MESH_RANKS)]
    batches = [np.concatenate([next(it) for it in its]) for _ in range(MESH_TRAIN_STEPS)]
    return trainer, batches


def mesh_train_steps(trainer, batches, graphed=True):
    """MESH_TRAIN_STEPS steps from the training loop's generator seed, each
    rank on its rows of the global batch: replayed from the trainer's CUDA
    graphs, or eager (``graphed=False``: the private ``_step_graphs`` set to
    None). Returns the weights and the EMA after, and each step's gradient
    (the mean over the global batch)."""
    from twoforone_torch.parallel.mesh import local_rows

    if not graphed:
        trainer._step_graphs = None
    gen = torch.Generator(trainer.device).manual_seed(trainer.config.seed + 1)
    rows = local_rows(len(batches[0]), trainer.mesh)
    grads = []
    for batch in batches:
        trainer._train_step(batch[rows], gen)
        grads.append({n: p.grad.cpu() for n, p in trainer.net.named_parameters()})
    return ({k: v.cpu() for k, v in trainer.net.state_dict().items()},
            {k: v.cpu() for k, v in trainer.ema.state_dict().items()}, grads)


def same_train_run(a, b):
    """Whether two :func:`mesh_train_steps` results are equal bit for bit."""
    (wa, ea, ga), (wb, eb, gb) = a, b
    return (all(torch.equal(wa[k], wb[k]) for k in wb)
            and all(torch.equal(ea[k], eb[k]) for k in eb) and len(ga) == len(gb)
            and all(torch.equal(x[k], y[k]) for x, y in zip(ga, gb) for k in y))


def rank_command(*args):
    """The command line of a rank of phase 12 (b): this script, as a rank."""
    return [sys.executable, os.path.abspath(__file__), "--mesh-rank", *map(str, args)]


def mesh_rank_main(rank, port, folder, device):
    """One of the MESH_RANKS ranks of phase 12 (b), all on ``device`` (the
    one card) over gloo (NCCL refuses two ranks on one device). Runs chignolin Langevin (K1),
    trp-cage Langevin (clx), DDIM-100 (K1) and two training steps with the
    mesh, each with the counters set to 0 just before, and saves what it
    got into ``folder``."""
    from datetime import timedelta

    import torch.distributed as dist

    from twoforone_torch.parallel.mesh import get_mesh, initialize_distributed
    from twoforone_torch.utils.artifacts import load_ema_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    initialize_distributed(f"127.0.0.1:{port}", MESH_RANKS, rank, backend="gloo", device=dev,
                           timeout=timedelta(seconds=MESH_RANK_TIMEOUT_S))
    mesh = get_mesh(dev)
    out = {"counts": {}}

    gd, params = make_gd(CHIGNOLIN), load_ema_params(CHIGNOLIN["name"])
    ld = make_sim(gd, params, CHIGNOLIN, CHAINS[-1], "auto", 10_000_000, WARMUP_STEPS, dev, mesh)
    zero_counts()
    rate, traj = langevin_kept(ld, WARMUP_STEPS, TIMED_STEPS)
    out["counts"]["chignolin"] = kernel_counts()
    out.update(chignolin_mode=ld.force_fn.mode, chignolin_steps_per_s=rate,
               chignolin_traj=torch.from_numpy(traj), local_chains=ld.sim._state[0].shape[0])
    del ld

    gd_trp, params_trp = make_gd(TRP_CAGE), load_ema_params(TRP_CAGE["name"])
    ld = make_sim(gd_trp, params_trp, TRP_CAGE, TRP_CHAINS, "auto", MESH_TRP_STEPS,
                  MESH_TRP_STEPS, dev, mesh)
    zero_counts()
    out["trp_final"] = torch.from_numpy(ld.sample())
    out["counts"]["trp_cage"] = kernel_counts()
    out["trp_mode"] = ld.force_fn.mode
    del ld

    fn = gd.make_fused_sample_fn(params, DDIM_BATCH, kernel="auto", sample_steps=100,
                                 device=dev, mesh=mesh)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = fn(torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    out.update(ddim_seconds=time.perf_counter() - t0, ddim_kernel=fn.kernel,
               ddim_samples=samples.cpu())
    out["counts"]["ddim"] = kernel_counts()

    zero_counts()
    for graphed, key in ((True, ""), (False, "eager_")):
        trainer, batches = mesh_trainer(dev, os.path.join(folder, f"train{rank}{key}"), mesh)
        out[f"{key}weights"], out[f"{key}ema"], out[f"{key}grads"] = mesh_train_steps(
            trainer, batches, graphed)
    out["counts"]["train"] = kernel_counts()
    torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def wait_ranks(procs, logs, what):
    """Wait for every rank within MESH_RANK_TIMEOUT_S; a rank that hangs or
    fails fails the phase (the others are stopped)."""
    deadline = time.perf_counter() + MESH_RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        fail(f"phase12 {what}: a rank did not finish within {MESH_RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for r, (p, path) in enumerate(zip(procs, logs)):
        with open(path) as f:
            texts.append(f.read())
        print(f"--- phase12 {what} rank {r}\n{texts[-1][-6000:]}", file=sys.stderr)
        if p.returncode != 0:
            fail(f"phase12 {what}: rank {r} exited {p.returncode}:\n{texts[-1][-3000:]}")
    return texts


def mesh_phase(reset_counts, add_counts, dev, phase3_sps):
    """Phase 12 in a temporary folder (see :func:`mesh_phase_in`)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        return mesh_phase_in(tmp, reset_counts, add_counts, dev, phase3_sps)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_phase_in(tmp, reset_counts, add_counts, dev, phase3_sps):
    """Phase 12, the multi-GPU layer. (a) A world of 1 over NCCL: chignolin
    Langevin at 1000 chains through K1 and two training steps at chain10's
    published configuration, each bit for bit equal to the run without a
    mesh. (b) MESH_RANKS ranks sharing the card over gloo: the gathered
    1000-chain chignolin trajectory bit for bit equal to (a)'s, K1 launches
    equal to the steps on each rank, trp-cage resolving clx on each rank and
    held against the single-process clx run, sharded DDIM-100 at batch 4096
    through K1, two training steps (weights equal across the ranks, and to
    each step's gradient against (a)'s); then the sampling CLI
    under MESH_RANKS ranks with --parallel_sim 999. Returns the numbers and
    the ranks' launches (K1, K2, K3, K4), which the counters of this process
    do not see."""
    import shutil
    from datetime import timedelta

    import torch.distributed as dist

    from twoforone_torch.parallel.mesh import get_mesh, initialize_distributed
    from twoforone_torch.utils.artifacts import load_ema_params, trained_dir

    out = {}
    gd, params = make_gd(CHIGNOLIN), load_ema_params(CHIGNOLIN["name"])
    steps = WARMUP_STEPS + TIMED_STEPS
    chains = CHAINS[-1]

    # ------------------------------------------------------------ (a)
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev,
                           timeout=timedelta(seconds=MESH_RANK_TIMEOUT_S))
    mesh = get_mesh(dev)
    dev = mesh.device
    reset_counts()
    _, ref_traj = langevin_kept(make_sim(gd, params, CHIGNOLIN, chains, "auto", 10_000_000,
                                         WARMUP_STEPS, dev), WARMUP_STEPS, TIMED_STEPS)
    add_counts()
    ld = make_sim(gd, params, CHIGNOLIN, chains, "auto", 10_000_000, WARMUP_STEPS, dev, mesh)
    reset_counts()
    rate_a, traj_a = langevin_kept(ld, WARMUP_STEPS, TIMED_STEPS)
    got = add_counts()
    same = bool(np.array_equal(traj_a, ref_traj))
    backend = "nccl" if dev.type == "cuda" else "gloo"  # gloo: a rehearsal on the CPU
    ok = (mesh.backend, mesh.size) == (backend, 1) and ld.force_fn.mode == "cl" and same \
        and got == (steps, 0, 0, 0)
    log(f"phase12 (a) world of 1 over {mesh.backend} on {mesh.device}: chignolin chains={chains} "
        f"steps_per_s={rate_a:.2f} (phase 3 without a mesh: {phase3_sps:.2f}) "
        f"launches_k1_fwd_bwd_k4={got} steps={steps} trajectory_bitwise_equal={same} ok={ok}")
    if not ok:
        fail("phase12 (a): the world of 1 differs from the run without a mesh")
    del ld

    reset_counts()
    runs = {}
    for name, use_mesh, graphed in (("graphed", None, True), ("eager", None, False),
                                    ("mesh", mesh, True)):
        trainer, batches = mesh_trainer(dev, os.path.join(tmp, name), use_mesh)
        runs[name] = mesh_train_steps(trainer, batches, graphed)
    got = add_counts()
    same = same_train_run(runs["mesh"], runs["graphed"])
    graphed_eager = same_train_run(runs["graphed"], runs["eager"])
    w_a, ema_a, grads_a = runs["mesh"]
    log(f"phase12 (a) {MESH_TRAIN_STEPS} Trainer steps at chain10's published configuration "
        f"(batch {trainer.batch_size}), replayed from the step's CUDA graphs, with the mesh: "
        f"weights_ema_and_gradients_bitwise_equal_to_the_meshless_graphed_run={same} "
        f"meshless_graphed_equal_to_eager={graphed_eager} launches={got}")
    if not (same and graphed_eager) or got != (0, 0, 0, 0):
        fail("phase12 (a): training with the world of 1 differs from training without a mesh, "
             "or the graphed steps from the eager ones")
    del trainer
    dist.destroy_process_group()

    gd_trp, params_trp = make_gd(TRP_CAGE), load_ema_params(TRP_CAGE["name"])
    reset_counts()
    trp_ref = make_sim(gd_trp, params_trp, TRP_CAGE, TRP_CHAINS, "auto", MESH_TRP_STEPS,
                       MESH_TRP_STEPS, dev).sample()
    add_counts()
    out["a"] = dict(chignolin_chains=chains, steps_per_s=rate_a, phase3_steps_per_s=phase3_sps)

    # ------------------------------------------------------------ (b)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    rank_counts = np.zeros(4, dtype=np.int64)
    port = free_port()
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(MESH_RANKS)]
    t0 = time.perf_counter()
    procs = []
    for r in range(MESH_RANKS):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(rank_command(r, port, tmp, dev), cwd=root, env=env,
                                          stdout=f, stderr=subprocess.STDOUT))
    wait_ranks(procs, logs, "(b) ranks")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(MESH_RANKS)]
    for res in ranks:
        for c in res["counts"].values():
            rank_counts += np.asarray(c)
    first = ranks[0]
    per_rank = chains // MESH_RANKS

    traj_b = first["chignolin_traj"].numpy()
    traj_diff = float(np.abs(traj_b - traj_a).max())
    same = bool(np.array_equal(traj_b, traj_a)) and all(
        torch.equal(res["chignolin_traj"], first["chignolin_traj"]) for res in ranks)
    counts = [res["counts"]["chignolin"] for res in ranks]
    rates = [res["chignolin_steps_per_s"] for res in ranks]
    ok = same and all(c == (steps, 0, 0, 0) for c in counts) and all(
        res["chignolin_mode"] == "cl" and res["local_chains"] == per_rank for res in ranks)
    log(f"phase12 (b) two ranks on one card (gloo, {dev}; not a scaling figure): chignolin "
        f"chains={chains} ({per_rank} a rank) steps_per_s_by_rank={[round(x, 2) for x in rates]} "
        f"launches_k1_fwd_bwd_k4_by_rank={counts} steps={steps} "
        f"gathered_trajectory_bitwise_equal_to_a={same} max_diff={traj_diff:.3e} ok={ok}")
    if not ok:
        fail("phase12 (b): the 2-rank chignolin run differs from the world of 1")

    trp_b = first["trp_final"].numpy()
    diff = float(np.abs(trp_b - trp_ref).max())
    scale = float(np.abs(trp_ref).max())
    counts = [res["counts"]["trp_cage"] for res in ranks]
    want = (0, 3 * MESH_TRP_STEPS, 3 * MESH_TRP_STEPS, 0)
    ok = (all(res["trp_mode"] == "clx" for res in ranks) and all(c == want for c in counts)
          and bool(np.isfinite(trp_b).all()) and diff <= TOL_TRAJ_REL * scale
          and all(torch.equal(res["trp_final"], first["trp_final"]) for res in ranks))
    log(f"phase12 (b) trp_cage chains={TRP_CHAINS} ({TRP_CHAINS // MESH_RANKS} a rank) "
        f"modes={[res['trp_mode'] for res in ranks]} launches_by_rank={counts} after "
        f"{MESH_TRP_STEPS} steps max_coord_diff_vs_single_process_clx={diff:.3e} "
        f"max_coord={scale:.3f} tol_rel={TOL_TRAJ_REL} ok={ok}")
    if not ok:
        fail("phase12 (b): trp-cage on two ranks is not clx or disagrees with one process")

    samples = first["ddim_samples"]
    counts = [res["counts"]["ddim"] for res in ranks]
    finite = bool(torch.isfinite(samples).all())
    com = (samples.mean(dim=1).abs().max() / CHIGNOLIN["norm"]).item()
    std_ratio = (samples.std() / CHIGNOLIN["norm"]).item()
    ok = (finite and tuple(samples.shape) == (DDIM_BATCH, 10, 3) and com <= TOL_COM
          and 0.5 <= std_ratio <= 2.0 and all(c == (100, 0, 0, 0) for c in counts)
          and all(res["ddim_kernel"] == "cl" for res in ranks)
          and all(torch.equal(res["ddim_samples"], samples) for res in ranks))
    ddim_s = max(res["ddim_seconds"] for res in ranks)
    log(f"phase12 (b) chignolin DDIM-100 batch={DDIM_BATCH} ({DDIM_BATCH // MESH_RANKS} a "
        f"rank) kernel={first['ddim_kernel']} samples_per_s={DDIM_BATCH / ddim_s:.2f} "
        f"launches_by_rank={counts} finite={finite} max_com_over_norm={com:.2e} "
        f"std_over_norm={std_ratio:.3f} ok={ok}")
    if not ok:
        fail("phase12 (b): sharded DDIM-100 gave wrong launches, shape, centre or spread")

    across = all(torch.equal(res[key][k], first[key][k]) for res in ranks
                 for key in ("weights", "ema") for k in first[key])
    graphed_eager = all(same_train_run(
        (res["weights"], res["ema"], res["grads"]),
        (res["eager_weights"], res["eager_ema"], res["eager_grads"])) for res in ranks)

    def worst(got, ref, floor=0.0):
        """The largest distance over the leaves, each over the larger of its
        largest entry and ``floor``; and that leaf's name."""
        return max((float((got[k] - ref[k]).abs().max()
                          / max(float(ref[k].abs().max()), floor, 1e-30)), k) for k in ref)

    grad_diffs = [worst(g, r, 1e-2 * max(float(v.abs().max()) for v in r.values()))
                  for g, r in zip(first["grads"], grads_a)]
    grad_worst, grad_leaf = max(grad_diffs[:MESH_GRAD_STEPS])
    later_worst = max(grad_diffs[MESH_GRAD_STEPS:], default=(0.0, ""))
    weight_worst, weight_leaf = worst(first["weights"], w_a)
    counts = [res["counts"]["train"] for res in ranks]
    ok = (across and graphed_eager and grad_worst <= TOL_MESH_TRAIN_REL
          and all(c == (0, 0, 0, 0) for c in counts))
    log(f"phase12 (b) {MESH_TRAIN_STEPS} Trainer steps over {MESH_RANKS} ranks, replayed from "
        f"the step's CUDA graphs: weights_and_ema_bitwise_equal_across_ranks={across} "
        f"graphed_equal_to_eager_on_each_rank={graphed_eager} "
        f"worst_leaf_gradient_diff_vs_a_first_{MESH_GRAD_STEPS}_steps={grad_worst:.3e} "
        f"({grad_leaf}) tol={TOL_MESH_TRAIN_REL} later_steps={later_worst[0]:.3e} "
        f"({later_worst[1]}; not held: the weights have parted) "
        f"worst_leaf_weight_diff_vs_a_over_leaf_max={weight_worst:.3e} "
        f"({weight_leaf}; not held: Adam) launches_by_rank={counts} ok={ok}")
    if not ok:
        fail("phase12 (b): 2-rank training steps differ across ranks, from one rank, or "
             "graphed from eager")
    out["b"] = dict(wall_s=wall, chignolin_steps_per_s_by_rank=rates,
                    ddim100_samples_per_s=DDIM_BATCH / ddim_s, trp_cage_max_diff=diff,
                    train_grad_worst_leaf_rel=grad_worst,
                    train_weight_worst_leaf_rel=weight_worst)

    # The sampling CLI under MESH_RANKS ranks, configured as torchrun
    # configures them, each on its own copy of chain10; --device names the
    # one card, so the ranks share it over gloo (default_backend).
    port = free_port()
    logs, procs = [], []
    t0 = time.perf_counter()
    for r in range(MESH_RANKS):
        path = os.path.join(tmp, f"chain10_r{r}")
        shutil.copytree(trained_dir("chain10"), path)
        logs.append(os.path.join(tmp, f"cli{r}.log"))
        rank_env = dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        WORLD_SIZE=str(MESH_RANKS), RANK=str(r), LOCAL_RANK=str(r),
                        LOCAL_WORLD_SIZE=str(MESH_RANKS))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "twoforone_torch.cli.sample", "--model_path", path,
                 "--gen_mode", "langevin", "--fused", "auto", "--parallel_sim",
                 str(MESH_CLI_CHAINS), "--batch_size_gen", str(chains), "--n_timesteps",
                 "200", "--save_interval", "100", "--sample_steps", "100", "--device",
                 str(dev)], cwd=root, env=rank_env, stdout=f, stderr=subprocess.STDOUT))
    texts = wait_ranks(procs, logs, "(b) sampling CLI")
    cli_wall = time.perf_counter() - t0
    padded = -(-MESH_CLI_CHAINS // MESH_RANKS) * MESH_RANKS
    lines = (f"Sharding over {MESH_RANKS} devices (batch {chains}, parallel_sim {padded})",
             "Langevin force path: cl", "i.i.d. sampler kernel: cl")
    printed = all(line in t for t in texts for line in lines)
    folders = [os.path.join(tmp, f"chain10_r{r}", "main_eval_output_langevin")
               for r in range(MESH_RANKS)]
    files = [sorted(os.listdir(f)) for f in folders]
    arr = np.load(os.path.join(folders[0], "sample-langevin.npy"))
    ok = (printed and files[0] == ["sample-langevin.npy", "sample-langevin.pdb",
                                   "sample-langevin.pt"]
          and all(f == [] for f in files[1:]) and arr.shape == (MESH_CLI_CHAINS * 2, 10, 3)
          and bool(np.isfinite(arr).all()))
    log(f"phase12 (b) cli.sample under {MESH_RANKS} ranks --parallel_sim {MESH_CLI_CHAINS}: "
        f"padded_to={padded} lines_printed={printed} output_shape={arr.shape} "
        f"files_by_rank={files} wall_s={cli_wall:.1f} ok={ok}")
    if not ok:
        fail("phase12 (b): the 2-rank sampling CLI padded, wrote or printed the wrong thing")
    out["b"]["cli_wall_s"] = cli_wall
    return out, tuple(int(c) for c in rank_counts)


# ------------------------------------------------------------------ phase 13
# bfloat16 score-network compute. (a) bench.py's configuration,
# LangevinDiffusion(bf16=True, fused="auto"): on chain10 (K1) and chain20
# (clx) at 1000 chains the kernels compute in float32 and ignore the flag, so
# the trajectory is the float32 run's bit for bit; at villin and protein-G
# width "auto" resolves to the plain network, which then runs in bfloat16.
# (b) DDIM-100 through sample(bf16=True). (c) Steps of the trainer on a
# bfloat16 model. (d) The dipeptide positive control with its bfloat16
# Langevin stage, at the JAX package's CI tier.
BF16_BITS_STEPS = 200  # bench.py runs 10 000-step chunks; a comparison needs few
BF16_WARMUP = 20
BF16_TIMED = 200  # plain-network steps timed at 100 chains (host-bound)
BF16_PROFILED = 20  # a multiple of BF16_WARMUP, the runs' save interval
# 10 steps bfloat16 against float32 from the same start and noise, in units
# of max |x|: the rule of tests/test_torch_bf16.py, C_RULE = 2 times the JAX
# package's own distance on these inputs plus FLOOR = 2**-8
# (scripts/torch_bf16_bars.py, JAX on the CPU). The card has no JAX, so the
# port's bfloat16 trajectory is held against its own float32 one.
BF16_TRAJ_BAR = {"chain35": 0.0065207873931735095, "chain56": 0.0063710940360593}
BF16_DDIM_BATCH = 1024
TOL_BEAD_COV = 0.05  # tests/test_diffusion.py's rule, relative Frobenius
BF16_TRAIN_STEPS = 100  # phase 10 takes 200; losses compared over 20 steps at each end
BF16_TRAIN_WARMUP = 20  # steps before the rate is timed
# The JAX package's CI tier (tests/test_positive_control.py), on which its
# bars were calibrated: no budget is cut. The trainer's evaluators are left
# out (they draw the Ramachandran map, and the card has no matplotlib); the
# control's own scores do not use them.
DIPEPTIDE_CONTROL = dict(train_iter=3500, n_data=40000, batch_size=256, num_samples=2048,
                         langevin_chains=64, langevin_steps=8000, langevin_save_interval=50,
                         n_bins=31, final_eval_samples=256, timesteps=250, t_noise=4, seed=0)
BAR_BF16_VS_F32, BAR_BF16_PWD = 0.1, 0.01
# The keys run_positive_control's results carry: the JAX function's
# (tests/test_torch_positive_control.py holds the two sets equal).
DIPEPTIDE_CONTROL_KEYS = (
    "js_bf16_vs_f32", "js_floor", "js_iid", "js_langevin_bf16", "js_langevin_f32",
    "langevin_chains", "langevin_dt_scale", "langevin_ergodic", "langevin_max_occupancy_error",
    "langevin_min_hop_fraction", "langevin_steps", "nonfinite_frac_iid",
    "nonfinite_frac_langevin", "pwd_js_bf16_vs_f32", "pwd_js_floor", "pwd_js_iid",
    "pwd_js_langevin_f32", "results_folder", "t_noise_langevin",
)


def wall_and_busy_ms(fn):
    """(wall ms, device-busy ms, kernels) of one call of ``fn`` under
    ``torch.profiler``: the kernels' summed device time against the wall.
    It traces the device alone (an eager training step's thousands of host
    operations would take the trace many seconds to read; a rehearsal on
    the CPU traces the host)."""
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA if card else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)]
    return wall_ms, sum(ev.device_time / 1e3 for ev in kernels), len(kernels)


def bead_cov(s):
    s = np.asarray(s, np.float64)
    return np.einsum("bic,bjc->ij", s, s) / (s.shape[0] * 3)


def bf16_phase(reset_counts, add_counts, dev, train_sps):
    """Phase 13 (a)-(d); returns the numbers it measured."""
    import tempfile

    from twoforone_torch.core.diffusion import GaussianDiffusion
    from twoforone_torch.data.datasets import CGDataset
    from twoforone_torch.data.molecules import FOLDED_PDB_DIR, Molecules
    from twoforone_torch.data.pdb import load_pdb
    from twoforone_torch.data.synthetic import chain10_dataset
    from twoforone_torch.models import get_model
    from twoforone_torch.train import positive_control as pc
    from twoforone_torch.train.trainer import Trainer, batch_iterator
    from twoforone_torch.utils.artifacts import load_ema_params, trained_dir
    from twoforone_torch.utils.config import TrainConfig
    from twoforone_torch.utils.profiling import PhaseTimer

    out = {}
    log(f"phase13 cuts to step counts: (a) {BF16_BITS_STEPS} steps a bit comparison at 1000 "
        f"chains (bench.py: chunks of 10 000), {BF16_TIMED} timed plain-network steps at "
        f"{BF16_CHAINS} chains; (c) {BF16_TRAIN_STEPS} training steps (the staged chain10: "
        f"50 000); (b) and (d) none (DDIM-100 as phase 6; the JAX package's CI tier)")
    # ---------------------------------------------------------------- (a)
    for spec, mode, per_step in ((CHIGNOLIN, "cl", (1, 0, 0, 0)), (TRP_CAGE, "clx", (0, 3, 3, 0))):
        g, w = make_gd(spec), load_ema_params(spec["name"])
        trajs, got = {}, {}
        for bf16 in (False, True):
            ld = make_sim(g, w, spec, 1000, "auto", BF16_BITS_STEPS, BF16_BITS_STEPS // 2, dev,
                          bf16=bf16)
            reset_counts()
            trajs[bf16] = ld.sample() if ld.force_fn.mode == mode else None
            got[bf16] = add_counts()
            del ld
        want = tuple(c * BF16_BITS_STEPS for c in per_step)
        same = trajs[True] is not None and np.array_equal(trajs[True], trajs[False])
        ok = same and got[True] == got[False] == want
        log(f"phase13 (a) {spec['label']} LangevinDiffusion(bf16=True, fused='auto') chains=1000 "
            f"steps={BF16_BITS_STEPS}: path={mode} same_bits_as_bf16_false={same} "
            f"launches_k1_fwd_bwd_k4 bf16={got[True]} f32={got[False]} (want {want}) ok={ok}")
        if not ok:
            fail(f"phase13 (a): bf16=True changed the {mode} trajectory, or its launches")

    for spec in (VILLIN, PROTEIN_G):
        g, w = make_gd(spec), load_ema_params(spec["name"])
        noise = normal(9, (10, BF16_CHAINS, spec["n"], 3), dev)
        finals, rates, profiled = {}, {}, {}
        for bf16 in (False, True):
            ld = make_sim(g, w, spec, BF16_CHAINS, "auto", 10, 10, dev, bf16=bf16)
            draws = iter(noise)
            ld.sim._draw_noise = lambda like, draws=draws: next(draws)
            reset_counts()
            finals[bf16] = ld.sample()
            ld = make_sim(g, w, spec, BF16_CHAINS, "auto", 10_000_000, BF16_WARMUP, dev,
                          bf16=bf16)
            rates[bf16], finite = timed_run(ld, BF16_WARMUP, BF16_TIMED)
            wall_ms, busy_ms, _ = wall_and_busy_ms(
                lambda ld=ld: ld.sim.simulate(sub_interval=BF16_PROFILED))
            profiled[bf16] = dict(wall_ms_per_step=wall_ms / BF16_PROFILED,
                                  device_busy_ms_per_step=busy_ms / BF16_PROFILED,
                                  device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms))
            launched = add_counts()
            if ld.force_fn.mode != "never" or launched != (0, 0, 0, 0) or not finite:
                fail(f"phase13 (a) {spec['label']}: 'auto' resolved to {ld.force_fn.mode!r}, "
                     f"launches {launched}, finite={finite}")
            del ld
        scale = float(np.abs(finals[False]).max())
        diff = float(np.abs(finals[True] - finals[False]).max()) / scale
        bar = BF16_TRAJ_BAR[spec["name"]]
        ok = bool(np.isfinite(finals[True]).all()) and 0.0 < diff <= bar
        out[f"{spec['label']}_never_{BF16_CHAINS}"] = dict(
            steps_per_s_bf16=rates[True], steps_per_s_f32=rates[False],
            ten_step_diff_in_max_x=diff, bar=bar, max_abs_x=scale,
            profiled_bf16=profiled[True], profiled_f32=profiled[False])
        log(f"phase13 (a) {spec['label']} N={spec['n']} chains={BF16_CHAINS} path=never: "
            f"10-step bf16 vs f32 max_coord_diff/max|x|={diff:.3e} (bar {bar:.3e}, JAX's own "
            f"distance x2 + 2^-8) max|x|={scale:.3f} steps_per_s bf16={rates[True]:.2f} "
            f"f32={rates[False]:.2f} bf16 {json.dumps(profiled[True])} "
            f"f32 {json.dumps(profiled[False])} ok={ok}")
        if not ok:
            fail(f"phase13 (a) {spec['label']}: the bf16 trajectory is outside its bar")

    # ---------------------------------------------------------------- (b)
    gd, params = make_gd(CHIGNOLIN), load_ema_params(CHIGNOLIN["name"])
    samples, sps = {}, {}
    for bf16 in (False, True):
        gen = torch.Generator(dev).manual_seed(3)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples[bf16] = gd.sample(params, BF16_DDIM_BATCH, gen, sample_steps=100, device=dev,
                                  bf16=bf16).cpu().numpy()
        torch.cuda.synchronize()
        sps[bf16] = BF16_DDIM_BATCH / (time.perf_counter() - t0)
        if add_counts() != (0, 0, 0, 0):
            fail("phase13 (b): a kernel ran in the plain sampler")
    c32 = bead_cov(samples[False])
    rel = float(np.linalg.norm(bead_cov(samples[True]) - c32) / np.linalg.norm(c32))
    com = float(np.abs(samples[True].mean(axis=1)).max()) / gd.norm_factor
    ok = (bool(np.isfinite(samples[True]).all()) and rel < TOL_BEAD_COV and com <= TOL_COM
          and not np.array_equal(samples[True], samples[False]))
    out["chignolin_ddim100_plain"] = dict(batch=BF16_DDIM_BATCH, samples_per_s_bf16=sps[True],
                                          samples_per_s_f32=sps[False], bead_cov_rel_diff=rel)
    log(f"phase13 (b) chignolin sample(bf16=True) DDIM-100 batch={BF16_DDIM_BATCH}: "
        f"bead_cov_rel_diff_vs_f32={rel:.4e} (limit {TOL_BEAD_COV}) com={com:.2e} "
        f"samples_per_s bf16={sps[True]:.2f} f32={sps[False]:.2f} ok={ok}")
    if not ok:
        fail("phase13 (b): the bf16 samples' bead covariance is off the f32 chain's")

    # ---------------------------------------------------------------- (c)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        with open(os.path.join(trained_dir("chain10"), "config.json")) as f:
            published = json.load(f)
        cfg = TrainConfig.from_dict(dict(
            published, results_folder=tmp, tensorboard_folder=os.path.join(tmp, "runs"),
            experiment_name="chain10_bf16", train_iter=BF16_TRAIN_STEPS, bf16=True))
        frames = chain10_dataset(TRAIN_FRAMES, seed=0)
        topology = load_pdb(os.path.join(FOLDED_PDB_DIR, "CLN025-0-c-alpha.pdb")).topology
        cut = (int(0.7 * TRAIN_FRAMES), int(0.8 * TRAIN_FRAMES))
        sets = tuple(CGDataset(d, topology, Molecules.CHIGNOLIN)
                     for d in (frames[:cut[0]], frames[cut[0]:cut[1]], frames[cut[1]:]))
        g = GaussianDiffusion(model=get_model(cfg, 10), num_atoms=10,
                              timesteps=cfg.diffusion_steps,
                              norm_factor=float(sets[0].data.std()),
                              loss_weights=cfg.loss_weights)
        trainer = Trainer(g, sets, cfg.mol, cfg, use_tensorboard=False, evaluators=False,
                          device=dev)
        it = batch_iterator(sets[0].data, cfg.batch_size, seed=1)
        gen = torch.Generator(dev).manual_seed(5)
        reset_counts()
        losses = []
        for step in range(BF16_TRAIN_STEPS):
            if step == BF16_TRAIN_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(trainer._train_step(next(it), gen)["loss"])
        torch.cuda.synchronize()
        rate = (BF16_TRAIN_STEPS - BF16_TRAIN_WARMUP) / (time.perf_counter() - t0)
        launched = add_counts()
        losses = np.array([float(v) for v in losses])
        first, last = float(losses[:20].mean()), float(losses[-20:].mean())
        f32 = [p.dtype == torch.float32 for m in (trainer.net, trainer.ema)
               for p in m.parameters()]
        moments = [s[k].dtype == torch.float32 for s in trainer.optimizer.state.values()
                   for k in ("mu", "nu")]
        ok = (trainer.net.dtype == torch.bfloat16 and bool(np.isfinite(losses).all())
              and last < first and all(f32) and all(moments) and launched == (0, 0, 0, 0))
        out["chain10_train_bf16"] = dict(steps=BF16_TRAIN_STEPS, steps_per_s_bf16=rate,
                                         steps_per_s_f32_phase10=train_sps,
                                         loss_first_20=first, loss_last_20=last)
        log(f"phase13 (c) chignolin Trainer steps at chain10's published configuration, "
            f"bf16=True, batch {cfg.batch_size}: steps={BF16_TRAIN_STEPS} "
            f"steps_per_s={rate:.2f} over the last {BF16_TRAIN_STEPS - BF16_TRAIN_WARMUP} "
            f"(phase 10, float32: {train_sps:.2f}) loss_first_20={first:.4f} "
            f"loss_last_20={last:.4f} "
            f"params_and_ema_float32={all(f32)} adam_moments_float32={all(moments)} "
            f"launches_k1_fwd_bwd_k4={launched} ok={ok}")
        if not ok:
            fail("phase13 (c): the bf16 training run failed a check")
        del trainer

        # ------------------------------------------------------------ (d)
        timer = PhaseTimer()
        stage, train, sample = pc._segmented_langevin_stage, Trainer.train, Trainer.sample

        def timed(name, fn):
            def run(*args, **kwargs):
                with timer.phase(name(*args) if callable(name) else name):
                    return fn(*args, **kwargs)
            return run

        pc._segmented_langevin_stage = timed(lambda ld, folder, name, *a: name, stage)
        Trainer.train = timed("train", train)
        Trainer.sample = timed("trainer.sample (final evaluation and the i.i.d. stage)", sample)
        folder = os.path.join(tmp, "dipeptide")
        try:
            reset_counts()
            t0 = time.perf_counter()
            res = pc.run_positive_control(results_folder=folder, bf16_compare=True,
                                          evaluators=False, device=dev, **DIPEPTIDE_CONTROL)
            wall = time.perf_counter() - t0
        finally:
            pc._segmented_langevin_stage, Trainer.train, Trainer.sample = stage, train, sample
        launched = add_counts()
        post = {f: np.load(os.path.join(folder, f)) for f in os.listdir(folder)
                if f.startswith("post_")}
        finite = (all(np.isfinite(a).all() for a in post.values())
                  and all(np.isfinite(v) for k, v in res.items() if k != "results_folder"))
        stages = sorted(post)
        ok = (set(res) == set(DIPEPTIDE_CONTROL_KEYS) and finite and len(post) == 3
              and any(f.startswith("post_langevin_bf16") for f in post)
              and res["js_bf16_vs_f32"] < BAR_BF16_VS_F32
              and res["pwd_js_bf16_vs_f32"] < BAR_BF16_PWD and launched == (0, 0, 0, 0))
        out["dipeptide_control"] = dict(res, wall_s=wall, stages_s=dict(timer.totals))
        log(f"phase13 (d) run_positive_control(bf16_compare=True) at the JAX package's CI tier "
            f"{json.dumps(DIPEPTIDE_CONTROL)}: wall_s={wall:.1f} keys_equal_jax="
            f"{set(res) == set(DIPEPTIDE_CONTROL_KEYS)} stages={stages} all_finite={finite} "
            f"js_langevin_f32={res['js_langevin_f32']:.4f} "
            f"js_langevin_bf16={res['js_langevin_bf16']:.4f} "
            f"js_bf16_vs_f32={res['js_bf16_vs_f32']:.4f} (bar {BAR_BF16_VS_F32}) "
            f"pwd_js_bf16_vs_f32={res['pwd_js_bf16_vs_f32']:.5f} (bar {BAR_BF16_PWD}) "
            f"js_iid={res['js_iid']:.4f} js_floor={res['js_floor']:.4f} "
            f"launches_k1_fwd_bwd_k4={launched} stage_wall_s={json.dumps(timer.totals)} ok={ok}")
        if not ok:
            fail("phase13 (d): the positive control's bf16 stage failed a check")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------------------------ phase 15
# The reproduction workflows (scripts/torch_*.py) as a user runs them on the
# card. (a) The paper-scale production run (100 chains x 6 000 000 steps,
# a save every 500) cut in steps: a straight run through the script's main
# in this process, then its first quarter again in subprocesses sharing one
# --out, in four shorter segments: the first SIGKILLed during its third
# segment, the second relaunched under TWOFORONE_PREEMPT_FLAG and yielding
# (exit 75) at the boundary after its first segment, the third finishing;
# its frames equal the straight run's first quarter bit for bit. (b)
# The two evaluation scripts, in subprocesses, on (a)'s frames and on
# i.i.d. samples of the staged ala5. (c) The t-sweep on the staged chain20
# (clx: K2, K3) and the quality ladder (the plain network).
PAPER_CHAINS = 100
PAPER_STEPS = 40_000  # cut from the production run's 6 000 000
PAPER_FULL_STEPS = 6_000_000
PAPER_SAVE = 500
PAPER_SEGMENT = 10_000
# The killed and resumed run: the straight run's first 10 000 steps in four
# segments (the straight run's noise is drawn step by step, so the segment
# length does not change the frames).
RESUME_STEPS, RESUME_SEGMENT = 10_000, 2_500
PAPER_PROCESS_TIMEOUT_S = 240
EVAL_TIMEOUT_S = 300
ALA2_SAMPLES = 4096
SWEEP_T = (10, 15)
SWEEP_CHAINS, SWEEP_STEPS, SWEEP_SAVE = 256, 2000, 100
SWEEP_EVAL_SAMPLES = 20_000  # cut from 50 000
QUALITY_STEPS = (100, 20)
QUALITY_SAMPLES = 4096  # cut from 100 000
PHASE15_BUDGET_S = 180
# The keys of the JAX scripts' products (tests/test_torch_workflow_scripts.py
# holds each set equal to the JAX script's).
PAPER_RESULT_KEYS = (
    "chain_steps_per_s", "dt_scale", "frames_saved", "integration_wall_s",
    "langevin_ergodic", "langevin_max_occupancy_error", "langevin_min_hop_fraction",
    "min_median_hops_per_chain", "nonfinite_chain_frac", "resumes", "steps_per_s",
    "t_noise", "tic_js_langevin", "workload",
)
FASTFOLDER_KEYS = ("Contact BCE to folded", "PWD JS (offset 3)", "RMSD mean (A)", "TIC JS")
ALA2_KEYS = ("Dihedral JS", "Dihedral free-energy MSE (kcal/mol)^2", "KL(ref||sample)",
             "KL(sample||ref)")
SWEEP_KEYS = ("chains", "dt_scale", "n_beads", "steps", "t", "tic_js_floor")
QUALITY_KEYS = ("bf16", "eta", "n_beads", "num_samples", "solver", "tic_js_floor",
                *(f"{name}_{k}" for k in QUALITY_STEPS
                  for name in ("tic_js_steps", "samples_per_sec_steps")))
# Every script of phase 15 runs in a process of its own through this runner:
# JAX, flax, optax and the JAX package cannot be imported there (a machine
# without them), and with a flag path and a segment file name it creates the
# preemption flag the moment that file is in place (the relaunch of (a): an
# outside watcher could miss the milliseconds between the file and the next
# segment boundary).
SCRIPT_RUNNER = """
import os, runpy, sys
for name in ("jax", "flax", "optax", "twoforone_tpu"):
    sys.modules[name] = None
flag, target, script = sys.argv[1:4]
if flag:
    replace = os.replace
    def hooked(src, dst, *a, **k):
        replace(src, dst, *a, **k)
        if os.path.basename(dst) == target:
            open(flag, "w").close()
    os.replace = hooked
sys.argv = [script, *sys.argv[4:]]
runpy.run_path(script, run_name="__main__")
"""


def script_command(name, args, flag="", target=""):
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", name)
    return [sys.executable, "-c", SCRIPT_RUNNER, flag, target, script, *args]


def run_script(name, args, log_path, env=None, timeout=EVAL_TIMEOUT_S):
    """``scripts/<name>`` in a process of its own (``SCRIPT_RUNNER``);
    returns its exit code and the end of its output (also in ``log_path``)."""
    with open(log_path, "w") as f:
        proc = subprocess.run(script_command(name, args), stdout=f,
                              stderr=subprocess.STDOUT, env=env, timeout=timeout)
    with open(log_path) as f:
        return proc.returncode, f.read()[-3000:]


def all_finite(tree):
    if isinstance(tree, dict):
        return all(all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(all_finite(v) for v in tree)
    return tree is None or isinstance(tree, (bool, str)) or bool(np.isfinite(tree))


def workflow_phase(reset_counts, add_counts, dev, phase3_sps):
    """Phase 15 (a)-(c); returns the numbers it measured."""
    import importlib.util
    import shutil
    import signal
    import tempfile

    from twoforone_torch.cli.sample import load_model
    from twoforone_torch.data.synthetic import chain_dataset
    from twoforone_torch.train.positive_control import chain_control_components
    from twoforone_torch.utils.artifacts import trained_dir

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(repo, "scripts"))
    import torch_ddim_quality
    import torch_langevin_t_sweep
    import torch_paper_scale_langevin

    absent = {m: importlib.util.find_spec(m) is None for m in ("jax", "matplotlib", "sklearn")}
    out = {"not_installed": absent}
    started = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_workflows_")
    env = {k: v for k, v in os.environ.items() if k != "TWOFORONE_PREEMPT_FLAG"}
    try:
        # ------------------------------------------------------------ (a)
        n_seg = PAPER_STEPS // PAPER_SEGMENT
        args = ["--chains", str(PAPER_CHAINS), "--steps", str(PAPER_STEPS),
                "--save_interval", str(PAPER_SAVE), "--segment_steps", str(PAPER_SEGMENT),
                "--device", str(dev)]
        straight = os.path.join(tmp, "straight")
        reset_counts()
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "straight.log"), "w") as f, contextlib.redirect_stdout(f):
            res = torch_paper_scale_langevin.main(["--out", straight, *args])
        wall = time.perf_counter() - t0
        got = add_counts()
        want = (1000 + PAPER_STEPS, 0, 0, 0)  # the ancestral chain's calls and the steps
        frames = torch_paper_scale_langevin.segment_frames(straight, n_seg)
        ok = (got == want and set(res) == set(PAPER_RESULT_KEYS) and all_finite(res)
              and frames.shape == (PAPER_CHAINS, PAPER_STEPS // PAPER_SAVE, 10, 3)
              and res["resumes"] == 0 and res["nonfinite_chain_frac"] == 0.0)
        projected = PAPER_FULL_STEPS / res["steps_per_s"]
        out["paper_scale"] = dict(
            res, wall_s=wall, launches=got, projected_6m_wall_s=projected,
            projected_6m_wall_h=projected / 3600)
        log(f"phase15 (a) torch_paper_scale_langevin.py {PAPER_CHAINS} chains x {PAPER_STEPS} "
            f"steps (cut from {PAPER_FULL_STEPS}), save every {PAPER_SAVE}, {n_seg} segments of "
            f"{PAPER_SEGMENT}: wall_s={wall:.2f} steps_per_s={res['steps_per_s']} "
            f"chain_steps_per_s={res['chain_steps_per_s']} (phase 3 at 100 chains "
            f"{phase3_sps:.2f}) projected 6M-step wall_s={projected:.0f} "
            f"({projected / 3600:.2f} h) launches_k1_fwd_bwd_k4={got} (want {want}: 1000 "
            f"i.i.d. calls + {PAPER_STEPS} steps) results={json.dumps(res)} ok={ok}")
        if not ok:
            fail("phase15 (a): the straight paper-scale run launched K1 another number of "
                 "times than its i.i.d. calls and steps, or its results are incomplete")

        resumed = os.path.join(tmp, "resumed")
        script = "torch_paper_scale_langevin.py"
        argv = ["--out", resumed, "--chains", str(PAPER_CHAINS), "--steps", str(RESUME_STEPS),
                "--save_interval", str(PAPER_SAVE), "--segment_steps", str(RESUME_SEGMENT),
                "--device", str(dev)]
        n_resumed = RESUME_STEPS // RESUME_SEGMENT
        seg = lambda s: os.path.join(resumed, f"coords_seg{s:03d}.npy")  # noqa: E731
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "killed.log"), "w") as f:
            first = subprocess.Popen(script_command(script, argv), stdout=f,
                                     stderr=subprocess.STDOUT, env=env)
            while not os.path.exists(seg(1)) and first.poll() is None:
                if time.perf_counter() - t0 > PAPER_PROCESS_TIMEOUT_S:
                    first.kill()
                    fail("phase15 (a): the first process wrote no second segment in time")
                time.sleep(0.05)
            first.send_signal(signal.SIGKILL)
            first.wait()
        killed_in_third = first.returncode == -signal.SIGKILL and not os.path.exists(seg(2))
        flag = os.path.join(tmp, "preempt.flag")
        with open(os.path.join(tmp, "preempted.log"), "w") as f:
            second = subprocess.run(
                script_command(script, argv, flag, os.path.basename(seg(2))), stdout=f,
                stderr=subprocess.STDOUT, env=dict(env, TWOFORONE_PREEMPT_FLAG=flag),
                timeout=PAPER_PROCESS_TIMEOUT_S)
        yielded = (second.returncode == 75 and os.path.exists(flag) and os.path.exists(seg(2))
                   and not os.path.exists(seg(3)))
        os.remove(flag)
        third, tail = run_script(script, argv,
                                 os.path.join(tmp, "finished.log"), env,
                                 PAPER_PROCESS_TIMEOUT_S)
        kill_wall = time.perf_counter() - t0
        with open(os.path.join(resumed, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(resumed, "results.json")) as f:
            res_resumed = json.load(f)
        prefix = np.ascontiguousarray(frames[:, :RESUME_STEPS // PAPER_SAVE])
        same = bool(np.array_equal(
            torch_paper_scale_langevin.segment_frames(resumed, n_resumed), prefix))
        same_scores = all(res_resumed[k] == v for k, v in
                          torch_paper_scale_langevin.score_frames(prefix).items())
        ok = (killed_in_third and yielded and third == 0 and same and same_scores
              and meta["resumes"] == 2 and res_resumed["resumes"] == 2
              and meta["segments_done"] == n_resumed)
        out["paper_scale_resumed"] = dict(
            wall_s=kill_wall, killed_rc=first.returncode, preempted_rc=second.returncode,
            finished_rc=third, same_bits=same, resumes=meta["resumes"],
            steps_per_s=res_resumed["steps_per_s"])
        log(f"phase15 (a) its first {RESUME_STEPS} steps again in {n_resumed} segments of "
            f"{RESUME_SEGMENT}, in three processes sharing one --out: SIGKILL during "
            f"the third segment (rc {first.returncode}, coords_seg002 absent: "
            f"{killed_in_third}), relaunched under TWOFORONE_PREEMPT_FLAG, the flag set once "
            f"coords_seg002.npy existed: rc {second.returncode} (want 75) at the boundary "
            f"(coords_seg003 absent: {yielded}), relaunched: rc {third}; frames equal the "
            f"straight run's first {prefix.shape[1]} saves bit for bit: {same}; scores equal "
            f"those of those frames: {same_scores}; meta resumes="
            f"{meta['resumes']} (want 2) segments_done={meta['segments_done']}; wall_s="
            f"{kill_wall:.2f} ok={ok}")
        if not ok:
            fail(f"phase15 (a): the killed and preempted run differs from the straight one or "
                 f"broke the resume contract; last process's output:\n{tail}")
        mark_a = time.perf_counter() - started

        # ------------------------------------------------------------ (b)
        frames_path = os.path.join(tmp, "paper_frames.npy")
        np.save(frames_path, frames.reshape(-1, 10, 3))
        rc, tail = run_script("torch_evaluate_fastfolders.py",
                              ["--mol", "chignolin", "--samples", frames_path, "--out",
                               os.path.join(tmp, "eval_ff"), "--no_plots"],
                              os.path.join(tmp, "eval_ff.log"), env)
        ff = {}
        if rc == 0:
            with open(os.path.join(tmp, "eval_ff", "results_chignolin.json")) as f:
                ff = json.load(f)
        ok = rc == 0 and set(ff) == set(FASTFOLDER_KEYS) and all_finite(ff)
        out["evaluate_fastfolders"] = ff
        log(f"phase15 (b) torch_evaluate_fastfolders.py --mol chignolin --no_plots on (a)'s "
            f"{len(frames.reshape(-1, 10, 3))} frames: rc={rc} {json.dumps(ff)} ok={ok}")
        if not ok:
            fail(f"phase15 (b): the fast-folder evaluation failed:\n{tail}")

        gd5, params5, _, _ = load_model(trained_dir("ala5"), "best", device=dev)
        sample = gd5.make_fused_sample_fn(params5, ALA2_SAMPLES, kernel="auto", device=dev)
        reset_counts()
        iid = sample(torch.Generator(device=dev).manual_seed(0)).cpu().numpy()
        got = add_counts()
        samples_path = os.path.join(tmp, "ala5_iid.npy")
        np.save(samples_path, iid)
        rc, tail = run_script("torch_evaluate_ala2.py",
                              ["--samples", samples_path, "--out", os.path.join(tmp, "eval_ala2"),
                               "--no_plots"], os.path.join(tmp, "eval_ala2.log"), env)
        ala2 = {}
        if rc == 0:
            with open(os.path.join(tmp, "eval_ala2", "results_ala2.json")) as f:
                ala2 = json.load(f)
        want = (gd5.timesteps, 0, 0, 0)
        ok = (rc == 0 and set(ala2) == set(ALA2_KEYS) and all_finite(ala2) and got == want
              and sample.kernel == "cl" and bool(np.isfinite(iid).all()))
        out["evaluate_ala2"] = ala2
        log(f"phase15 (b) {ALA2_SAMPLES} i.i.d. samples of the staged ala5 ({sample.kernel}, "
            f"ancestral; launches_k1_fwd_bwd_k4={got}, want {want}), then "
            f"torch_evaluate_ala2.py --no_plots: rc={rc} {json.dumps(ala2)}; not installed "
            f"here: {absent}, and no script process could import jax, flax, optax or "
            f"twoforone_tpu ok={ok}")
        if not ok:
            fail(f"phase15 (b): the alanine-dipeptide evaluation failed:\n{tail}")
        mark_b = time.perf_counter() - started

        # ------------------------------------------------------------ (c)
        init_path = os.path.join(tmp, "chain20_init.npy")
        np.save(init_path, chain_dataset(SWEEP_CHAINS, chain_control_components(20), seed=5)
                .astype(np.float32))
        sweep_args = ["--n_beads", "20", "--init", init_path, "--t", *map(str, SWEEP_T),
                      "--chains", str(SWEEP_CHAINS), "--steps", str(SWEEP_STEPS),
                      "--save_interval", str(SWEEP_SAVE), "--eval_samples",
                      str(SWEEP_EVAL_SAMPLES), "--device", str(dev),
                      "--out", os.path.join(tmp, "sweep.json")]
        reset_counts()
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "sweep.log"), "w") as f, contextlib.redirect_stdout(f):
            sweep, sweep_sps = torch_langevin_t_sweep.main(sweep_args)
        wall = time.perf_counter() - t0
        got = add_counts()
        per_step = 3 * len(SWEEP_T) * SWEEP_STEPS
        want = (0, per_step, per_step, 0)
        ok = (got == want and set(sweep) == set(SWEEP_KEYS) and all_finite(sweep)
              and set(sweep["t"]) == set(SWEEP_T)
              and all(v["nonfinite_frac"] == 0.0 for v in sweep["t"].values()))
        out["t_sweep"] = dict(sweep, t={str(k): v for k, v in sweep["t"].items()},
                              steps_per_s={str(k): v for k, v in sweep_sps.items()},
                              wall_s=wall, launches=got)
        log(f"phase15 (c) torch_langevin_t_sweep.py on the staged chain20, t={SWEEP_T}, "
            f"{SWEEP_CHAINS} chains x {SWEEP_STEPS} steps, eval_samples {SWEEP_EVAL_SAMPLES} "
            f"(cut from 500 chains x 20 000 steps, 50 000): wall_s={wall:.2f} steps_per_s="
            f"{json.dumps(out['t_sweep']['steps_per_s'])} launches_k1_fwd_bwd_k4={got} "
            f"(want {want}: 3 of K2 and 3 of K3 a step) results={json.dumps(out['t_sweep']['t'])} "
            f"tic_js_floor={sweep['tic_js_floor']:.4f} ok={ok}")
        if not ok:
            fail("phase15 (c): the t-sweep launched K2/K3 another number of times than 3 a "
                 "step, or its results are incomplete")

        quality_args = ["--n_beads", "20", "--steps", *map(str, QUALITY_STEPS),
                        "--num_samples", str(QUALITY_SAMPLES), "--device", str(dev),
                        "--out", os.path.join(tmp, "quality.json")]
        reset_counts()
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "quality.log"), "w") as f, contextlib.redirect_stdout(f):
            quality = torch_ddim_quality.main(quality_args)
        wall = time.perf_counter() - t0
        got = add_counts()
        ok = (got == (0, 0, 0, 0) and set(quality) == set(QUALITY_KEYS) and all_finite(quality))
        out["ddim_quality"] = dict(quality, wall_s=wall)
        log(f"phase15 (c) torch_ddim_quality.py on the staged chain20, --steps "
            f"{' '.join(map(str, QUALITY_STEPS))}, {QUALITY_SAMPLES} samples (cut from 100 000; "
            f"the plain network, no kernel): wall_s={wall:.2f} launches={got} "
            f"results={json.dumps(quality)} ok={ok}")
        if not ok:
            fail("phase15 (c): the quality ladder launched a kernel or its results are "
                 "incomplete")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        sys.path.remove(os.path.join(repo, "scripts"))
    total = time.perf_counter() - started
    out["phase_s"] = dict(a=mark_a, b=mark_b - mark_a, c=total - mark_b, total=total)
    log(f"phase15 seconds: (a) {mark_a:.1f}, (b) {mark_b - mark_a:.1f}, (c) "
        f"{total - mark_b:.1f}, total {total:.1f} (budget {PHASE15_BUDGET_S})")
    return out


# ------------------------------------------------------------------ phase 16
# The JAX package's compiled loops as CUDA graphs: on the card every Langevin
# run above replays a captured step, and every plain-network sampling
# closure a captured reverse step. Here each is held against the eager loop
# (reached through the private ``_graphs`` attribute set to None) bit for
# bit, both are timed, and the device memory of each graphed path's first
# call (its static buffers and its graphs' pool) is read.
GRAPH_BITS_STEPS = 200
GRAPH_BITS_SAVE = 50
# (spec, fused, chains, bf16, friction, reference temperature): every force
# path, both dynamics and the tempering ramp.
GRAPH_BITS_RUNS = (
    (CHIGNOLIN, "cl", 100, False, 1.0, None),
    (CHIGNOLIN, "always", 100, False, 1.0, None),
    (CHIGNOLIN, "cl", 100, False, None, None),
    (TRP_CAGE, "clx", 256, False, 1.0, None),
    (TRP_CAGE, "never", 256, False, 1.0, None),
    (VILLIN, "never", 100, False, 1.0, None),
    (VILLIN, "never", 100, True, 1.0, None),
    (VILLIN, "always", 100, False, 1.0, None),
    (VILLIN, "never", 100, False, 1.0, 2 * VILLIN["temp"]),
)
GRAPH_SAMPLER_BATCH = 1024
GRAPH_SAMPLERS = (("ddim20", dict(sample_steps=20), 2),
                  ("dpm2m20", dict(sample_steps=20, solver="dpm2m"), 2),
                  ("ancestral1000", dict(sample_steps=None), 1))  # (name, sampler, calls)
GRAPH_WARMUP = 20  # steps before a rate is timed, and the runs' save interval
GRAPH_TIMED = {True: 400, False: 100}  # steps timed graphed / eager
# (spec, fused, chains, bf16): the path gate's question at villin and
# protein-G width, trp-cage's plain network, chignolin's kernel.
GRAPH_RATE_RUNS = (
    *((spec, mode, 100, bf16) for spec in (VILLIN, PROTEIN_G)
      for mode, bf16 in (("never", False), ("never", True), ("always", False))),
    (TRP_CAGE, "never", 1000, False),
    (CHIGNOLIN, "cl", 100, False),
    (CHIGNOLIN, "cl", 1000, False),
)
GRAPH_DDIM_STEPS = 100


def first_call_memory(fn):
    """(``fn()``, its seconds, MiB that the device holds more after it): the
    first call of a graphed loop, whose static buffers and graph pool stay
    while the loop lives. Unreachable loops of earlier runs are collected
    and the allocator's free cache is emptied before and after (outside the
    seconds), so ``reserved`` counts the segments kept (a live graph's pool
    is not released) and ``allocated`` the tensors that are live."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0, a0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return result, seconds, {"reserved": (torch.cuda.memory_reserved() - r0) / 2**20,
                             "allocated": (torch.cuda.memory_allocated() - a0) / 2**20}


def first_call(fn, graphed):
    """:func:`first_call_memory` of a graphed loop's first call; an eager
    one's seconds alone (its memory None)."""
    if graphed:
        return first_call_memory(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, None


def graph_phase(reset_counts, add_counts, dev):
    """Phase 16; returns the numbers it measured."""
    from twoforone_torch.utils.artifacts import load_ema_params

    models = {}

    def model(spec):
        if spec["name"] not in models:
            models[spec["name"]] = make_gd(spec), load_ema_params(spec["name"])
        return models[spec["name"]]

    def tag(spec, mode, chains, bf16=False, friction=1.0, ref_temp=None):
        return (f"{spec['label']}_{mode}{'_bf16' if bf16 else ''}_{chains}"
                f"{'_overdamped' if friction is None else ''}{'_ramp' if ref_temp else ''}")

    out = {}
    memory = out["first_graphed_call_memory_mib"] = {}
    log(f"phase16 cuts: {GRAPH_BITS_STEPS} steps a bit comparison (a save every "
        f"{GRAPH_BITS_SAVE}), {GRAPH_TIMED[True]} / {GRAPH_TIMED[False]} steps timed graphed / "
        f"eager after {GRAPH_WARMUP}")
    # ------------------------------------------------------------ (a)
    def bits_run(spec, mode, chains, bf16, friction, ref_temp, graphed, steps=GRAPH_BITS_STEPS,
                 state=None):
        g, w = model(spec)
        ld = make_sim(g, w, spec, chains, mode, GRAPH_BITS_STEPS, GRAPH_BITS_SAVE, dev,
                      bf16=bf16, friction=friction)
        if not graphed:
            ld.sim._graphs = None
        if state is not None:
            ld.sim.load_state(state)
        ld.sim.save_forces = True
        ref_beta = None if ref_temp is None else ld.kb_inv / ref_temp
        reset_counts()
        coords, _, mem = first_call(
            lambda: ld.sim.simulate(sub_interval=steps, reference_beta=ref_beta), graphed)
        got = add_counts()
        st = ld.sim.state
        run = dict(coords=coords, forces=ld.sim.simulated_forces, ke=ld.sim.kinetic_energies,
                   x=st["x"], v=st["v"], key=st["key"])
        return run, got, st, (ld.sim._graphs and list(ld.sim._graphs.graphs)), mem

    def same(a, b):
        return all((a[k] is None and b[k] is None) or np.array_equal(a[k], b[k]) for k in a)

    for spec, mode, chains, bf16, friction, ref_temp in GRAPH_BITS_RUNS:
        name = tag(spec, mode, chains, bf16, friction, ref_temp)
        want = tuple(c * GRAPH_BITS_STEPS for c in PER_CALL[mode])
        eager, got_e, _, _, _ = bits_run(spec, mode, chains, bf16, friction, ref_temp, False)
        graphed, got_g, _, keys, mem = bits_run(spec, mode, chains, bf16, friction, ref_temp,
                                                True)
        memory[name] = mem
        bits = same(graphed, eager)
        finite = bool(np.isfinite(graphed["coords"]).all())
        ok = bits and finite and got_e == got_g == want and bool(keys)
        log(f"phase16 (a) {name} steps={GRAPH_BITS_STEPS} save_interval={GRAPH_BITS_SAVE} "
            f"graphed_vs_eager_same_bits(x, v, frames, forces, ke, generator)={bits} "
            f"graphs={keys} launches_k1_fwd_bwd_k4 graphed={got_g} eager={got_e} "
            f"(want {want}) finite={finite} first_graphed_call_memory_mib={mem} ok={ok}")
        if not ok:
            fail(f"phase16 (a) {name}: the graphed run differs from the eager one, or its "
                 "launches from the steps")
    # A graphed run stopped at its midpoint and resumed from its state in a
    # fresh simulation, against the straight graphed run.
    spec, mode, chains = CHIGNOLIN, "cl", 100
    straight, _, _, _, _ = bits_run(spec, mode, chains, False, 1.0, None, True)
    half = GRAPH_BITS_STEPS // 2
    first, _, st, _, _ = bits_run(spec, mode, chains, False, 1.0, None, True, steps=half)
    rest, got, _, _, _ = bits_run(spec, mode, chains, False, 1.0, None, True, steps=half,
                                  state=st)
    joined = {k: np.concatenate([first[k], rest[k]], axis=1) for k in ("coords", "forces", "ke")}
    bits = (same(joined, {k: straight[k] for k in joined})
            and same({k: rest[k] for k in ("x", "v", "key")},
                     {k: straight[k] for k in ("x", "v", "key")}))
    ok = bits and got == (half, 0, 0, 0)
    log(f"phase16 (a) {tag(spec, mode, chains)} stopped at step {half} and resumed through "
        f"state/load_state: same_bits_as_straight_graphed_run={bits} "
        f"launches_after_resume={got} ok={ok}")
    if not ok:
        fail("phase16 (a): a resumed graphed run differs from the straight one")

    # ------------------------------------------------------------ (b)
    g, w = model(CHIGNOLIN)
    for name, kw, calls in GRAPH_SAMPLERS:
        samples, times, gens = {}, {}, {}
        for graphed in (False, True):
            fn = g.make_fused_sample_fn(w, GRAPH_SAMPLER_BATCH, kernel="xla", device=dev, **kw)
            if not graphed:
                fn._graphs = None
            gen = torch.Generator(dev).manual_seed(11)
            reset_counts()
            first, first_s, mem = first_call(lambda: fn(gen), graphed)
            t0 = time.perf_counter()
            samples[graphed] = [first] + [fn(gen) for _ in range(calls - 1)]
            torch.cuda.synchronize()
            times[graphed] = first_s + time.perf_counter() - t0
            if graphed:
                memory[f"chignolin_{name}_xla_{GRAPH_SAMPLER_BATCH}"] = mem
            gens[graphed] = gen.get_state()
            if add_counts() != (0, 0, 0, 0):
                fail(f"phase16 (b) {name}: a kernel ran in the plain sampler")
            graphs = fn._graphs and list(fn._graphs.graphs)
        bits = (all(torch.equal(a, b) for a, b in zip(samples[True], samples[False]))
                and torch.equal(gens[True], gens[False]))
        finite = all(bool(torch.isfinite(s).all()) for s in samples[True])
        ok = bits and finite and bool(graphs)
        log(f"phase16 (b) chignolin {name} kernel=xla batch={GRAPH_SAMPLER_BATCH} calls={calls} "
            f"graphed_vs_eager_same_bits={bits} graphs={len(graphs or ())} finite={finite} "
            f"seconds graphed={times[True]:.3f} eager={times[False]:.3f} (the graphed first "
            f"call captures) first_graphed_call_memory_mib="
            f"{memory[f'chignolin_{name}_xla_{GRAPH_SAMPLER_BATCH}']} ok={ok}")
        if not ok:
            fail(f"phase16 (b) {name}: the graphed chain's samples differ from the eager one's")

    # ------------------------------------------------------------ (c)
    rates = out["steps_per_s"] = {}
    for spec, mode, chains, bf16 in GRAPH_RATE_RUNS:
        name = tag(spec, mode, chains, bf16)
        g, w = model(spec)
        for graphed in (False, True):
            ld = make_sim(g, w, spec, chains, mode, 10_000_000, GRAPH_WARMUP, dev, bf16=bf16)
            if not graphed:
                ld.sim._graphs = None
            steps = GRAPH_TIMED[graphed]
            reset_counts()
            # graphed: warm-up and capture
            _, first_s, mem = first_call(lambda: ld.sim.simulate(sub_interval=GRAPH_WARMUP),
                                         graphed)
            if graphed:
                memory.setdefault(name, mem)
            rate, finite = timed_run(ld, 0, steps)
            got = add_counts()
            want = tuple(c * (GRAPH_WARMUP + steps) for c in PER_CALL[mode])
            if got != want or not finite:
                fail(f"phase16 (c) {name}: launches {got} (want {want}), finite={finite}")
            which = "graphed" if graphed else "eager"
            rates.setdefault(name, {}).update({which: rate, f"first_{GRAPH_WARMUP}_steps_s_{which}":
                                               first_s})
            del ld
        r = rates[name]
        r["graphed_over_eager"] = r["graphed"] / r["eager"]
        log(f"phase16 (c) {name} steps_per_s graphed={r['graphed']:.2f} eager={r['eager']:.2f} "
            f"ratio={r['graphed_over_eager']:.2f} first {GRAPH_WARMUP} steps of a new simulation "
            f"(graphed: with the capture) graphed_s="
            f"{r[f'first_{GRAPH_WARMUP}_steps_s_graphed']:.3f} "
            f"eager_s={r[f'first_{GRAPH_WARMUP}_steps_s_eager']:.3f}")
    g, w = model(VILLIN)
    ld = make_sim(g, w, VILLIN, 100, "never", 10_000_000, GRAPH_WARMUP, dev)
    ld.sim.simulate(sub_interval=GRAPH_WARMUP)
    wall_ms, busy_ms, _ = wall_and_busy_ms(lambda: ld.sim.simulate(sub_interval=GRAPH_WARMUP))
    out["villin_never_100_profiled"] = dict(
        steps=GRAPH_WARMUP, wall_ms_per_step=wall_ms / GRAPH_WARMUP,
        device_busy_ms_per_step=busy_ms / GRAPH_WARMUP, device_idle_share=1.0 - busy_ms / wall_ms)
    log(f"phase16 (c) villin_never_100 graphed under torch.profiler: "
        + json.dumps(out["villin_never_100_profiled"]))
    if busy_ms > wall_ms:
        fail("phase16 (c): the profiler's device time exceeds the wall time of the run")
    del ld
    sps = out["chignolin_ddim100_xla_samples_per_s"] = {}
    g, w = model(CHIGNOLIN)
    for graphed in (False, True):
        fn = g.make_fused_sample_fn(w, GRAPH_SAMPLER_BATCH, kernel="xla",
                                    sample_steps=GRAPH_DDIM_STEPS, device=dev)
        if not graphed:
            fn._graphs = None
        fn(torch.Generator(dev).manual_seed(0))  # the graphed closure captures here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(torch.Generator(dev).manual_seed(1))
        torch.cuda.synchronize()
        sps["graphed" if graphed else "eager"] = GRAPH_SAMPLER_BATCH / (time.perf_counter() - t0)
        del fn
    log(f"phase16 (c) chignolin DDIM-{GRAPH_DDIM_STEPS} kernel=xla batch={GRAPH_SAMPLER_BATCH} "
        f"samples_per_s graphed={sps['graphed']:.2f} eager={sps['eager']:.2f}")
    log(f"phase16 memory of a graphed path's first call, MiB: {json.dumps(memory)}")
    return out



# ------------------------------------------------------------------ phase 17
# The JAX package's jitted training programs as CUDA graphs: a training step
# replays its two captured halves (the gradients, then the update), a chunk
# replays them K times, a loss evaluation replays one captured batch. Each is
# held against the eager form (the private ``_step_graphs`` / ``_eval_graphs``
# set to None) bit for bit at chain10's published configuration on phase
# 10's synthetic frames, then both are timed and profiled, and the memory the
# trainer's three graphs keep is read.
TRAIN_BITS_STEPS = 120  # past the EMA's copy phase (update_after_step 100), into its ramp
TRAIN_BITS_SHORT = 40  # gradient_accumulate_every 2, and a bf16 model
TRAIN_RESUME_AT = 60
TRAIN_RESUME_DRIFT = 20  # steps trained past the checkpoint before it is loaded back
TRAIN_CHUNK = 50  # chain10's steps_per_host_loop
TRAIN_EVAL_ITERS = 5


def train_graph_phase(reset_counts, add_counts, dev):
    """Phase 17; returns the numbers it measured."""
    import shutil
    import tempfile

    from twoforone_torch.core.diffusion import GaussianDiffusion
    from twoforone_torch.data.datasets import CGDataset
    from twoforone_torch.data.molecules import FOLDED_PDB_DIR, Molecules
    from twoforone_torch.data.pdb import load_pdb
    from twoforone_torch.data.synthetic import chain10_dataset
    from twoforone_torch.models import get_model
    from twoforone_torch.train.trainer import Trainer, batch_iterator
    from twoforone_torch.utils.artifacts import trained_dir
    from twoforone_torch.utils.config import TrainConfig

    with open(os.path.join(trained_dir("chain10"), "config.json")) as f:
        published = json.load(f)
    frames = chain10_dataset(TRAIN_FRAMES, seed=0)
    topology = load_pdb(os.path.join(FOLDED_PDB_DIR, "CLN025-0-c-alpha.pdb")).topology
    cut = (int(0.7 * TRAIN_FRAMES), int(0.8 * TRAIN_FRAMES))
    sets = tuple(CGDataset(d, topology, Molecules.CHIGNOLIN)
                 for d in (frames[:cut[0]], frames[cut[0]:cut[1]], frames[cut[1]:]))
    batch = published["batch_size"]
    it = batch_iterator(sets[0].data, batch, seed=1)
    batches = [next(it) for _ in range(TRAIN_BITS_STEPS)]
    pairs = [np.stack([next(it), next(it)]) for _ in range(TRAIN_BITS_SHORT)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_graphs_")
    out = {}

    def make(name, graphed=True, **overrides):
        cfg = TrainConfig.from_dict(dict(published, results_folder=tmp, tensorboard_folder=tmp,
                                         experiment_name=name, **overrides))
        gd = GaussianDiffusion(model=get_model(cfg, 10), num_atoms=10,
                               timesteps=cfg.diffusion_steps,
                               norm_factor=float(sets[0].data.std()),
                               loss_weights=cfg.loss_weights)
        trainer = Trainer(gd, sets, cfg.mol, cfg, use_tensorboard=False, evaluators=False,
                          device=dev)
        if not graphed:
            trainer._step_graphs = trainer._eval_graphs = None
        return trainer

    def state(trainer, gen):
        opt = trainer.optimizer
        return dict(weights=[t.clone() for t in trainer.net.state_dict().values()],
                    ema=[t.clone() for t in trainer.ema.state_dict().values()],
                    grads=[p.grad.clone() for p in trainer.net.parameters()],
                    moments=[opt.state[p][k].clone() for p in trainer.net.parameters()
                             for k in ("mu", "nu")],
                    count=opt.param_groups[0]["count"], step=trainer.step,
                    kl_max=trainer.kl_max.clone(), generator=gen.get_state())

    def same(a, b, keys=None):
        def eq(x, y):
            if isinstance(x, list):
                return len(x) == len(y) and all(eq(u, v) for u, v in zip(x, y))
            if torch.is_tensor(x):
                return x.dtype == y.dtype and torch.equal(x, y)
            return x == y
        return all(eq(a[k], b[k]) for k in (keys or b))

    def steps(trainer, todo, gen):
        ms = [trainer._train_step(b, gen) for b in todo]
        return {k: torch.stack([m[k] for m in ms]) for k in ("loss", "kl_at_T", "kl_max")}

    def bits(label, overrides, todo, chunk=False):
        """The same steps graphed and eager from one seed: every step's
        metrics and the state after, bit for bit."""
        got = {}
        for graphed in (True, False):
            trainer = make(f"{label}_{graphed}", graphed, **overrides)
            gen = torch.Generator(dev).manual_seed(published["seed"] + 1)
            if chunk:
                last = trainer._train_chunk(np.stack(todo), gen)
                metrics = {k: v[None] for k, v in last.items()}
            else:
                metrics = steps(trainer, todo, gen)
            got[graphed] = (metrics, state(trainer, gen), trainer)
        (m_g, s_g, trainer), (m_e, s_e, _) = got[True], got[False]
        ok = same(m_g, m_e) and same(s_g, s_e) and s_g["step"] == s_g["count"] == len(todo)
        log(f"phase17 (a) {label}: {len(todo)} steps{' in one _train_chunk' if chunk else ''} "
            f"graphed_vs_eager_same_bits: metrics={same(m_g, m_e)} "
            f"weights={same(s_g, s_e, ['weights'])} ema={same(s_g, s_e, ['ema'])} "
            f"adam_mu_nu={same(s_g, s_e, ['moments'])} grads={same(s_g, s_e, ['grads'])} "
            f"count={s_g['count']} step={s_g['step']} "
            f"generator={same(s_g, s_e, ['generator'])} kl_max={float(s_g['kl_max']):.3e} "
            f"graphs={sorted(map(str, trainer._step_graphs.graphs))} "
            f"finite={bool(torch.isfinite(m_g['loss']).all())} ok={ok}")
        if not ok:
            fail(f"phase17 (a) {label}: the graphed steps differ from the eager ones")
        return m_g, s_g, trainer

    started = time.perf_counter()
    try:
        # ------------------------------------------------------------ (a)
        reset_counts()
        m_a, s_a, trained = bits("float32", {}, batches)
        bits("gradient_accumulate_every_2", dict(gradient_accumulate_every=2), pairs)
        bits("bf16", dict(bf16=True), batches[:TRAIN_BITS_SHORT])
        bits("chunk", {}, batches[:TRAIN_CHUNK], chunk=True)
        launched = add_counts()
        if launched != (0, 0, 0, 0):
            fail(f"phase17 (a): a kernel ran in a training step: {launched}")
        mark_a = time.perf_counter() - started

        # ------------------------------------------------------------ (b)
        for fresh in (False, True):
            trainer = make("resume")
            gen = torch.Generator(dev).manual_seed(published["seed"] + 1)
            steps(trainer, batches[:TRAIN_RESUME_AT], gen)
            trainer.save(1)
            at_save = gen.get_state()
            steps(trainer, batches[TRAIN_RESUME_AT:TRAIN_RESUME_AT + TRAIN_RESUME_DRIFT], gen)
            if fresh:
                trainer = make("resume")
            trainer.load("last")
            gen.set_state(at_save)
            rest = steps(trainer, batches[TRAIN_RESUME_AT:], gen)
            s_r = state(trainer, gen)
            kept = ["weights", "ema", "grads", "moments", "count", "step", "generator"]
            losses = torch.equal(rest["loss"], m_a["loss"][TRAIN_RESUME_AT:])
            ok = (same(s_r, s_a, kept) and losses
                  and torch.equal(s_r["kl_max"], m_a["kl_at_T"][TRAIN_RESUME_AT:].max()))
            log(f"phase17 (b) save at step {TRAIN_RESUME_AT}, {TRAIN_RESUME_DRIFT} steps on, "
                f"load('last') into {'a fresh trainer' if fresh else 'the captured trainer'}, "
                f"continue to {TRAIN_BITS_STEPS}: equal_to_the_straight_run="
                f"{same(s_r, s_a, kept)} losses={losses} "
                f"kl_max_since_the_load={float(s_r['kl_max']):.3e} ok={ok}")
            if not ok:
                fail("phase17 (b): a resumed graphed run differs from the straight one")
            del trainer
        mark_b = time.perf_counter() - started

        # ------------------------------------------------------------ (c)
        val = np.asarray(sets[1].data)
        graphs, losses = trained._eval_graphs, {}
        for graphed in (True, False):
            trained._eval_graphs = graphs if graphed else None
            gen = torch.Generator(dev).manual_seed(11)
            with contextlib.redirect_stdout(sys.stderr):
                losses[graphed] = [trained.eval_loss(val, TRAIN_EVAL_ITERS, gen)
                                   for _ in range(2)] + [gen.get_state()]
        ok = (losses[True][:2] == losses[False][:2] and torch.equal(losses[True][2],
                                                                     losses[False][2])
              and all(np.isfinite(losses[True][:2])) and len(graphs.graphs) == 1)
        out["eval_loss"] = losses[True][:2]
        log(f"phase17 (c) eval_loss of the EMA weights, {TRAIN_EVAL_ITERS} batches of {batch}, "
            f"two calls: graphed={losses[True][:2]} eager={losses[False][:2]} same_bits="
            f"{losses[True][:2] == losses[False][:2]} graphs={list(graphs.graphs)} ok={ok}")
        if not ok:
            fail("phase17 (c): the graphed loss evaluation differs from the eager one")
        mark_c = time.perf_counter() - started

        # ------------------------------------------------------------ (d)
        rates, memory = out["steps_per_s"], out["memory_mib"] = {}, {}
        it = batch_iterator(sets[0].data, batch, seed=2)
        for label, overrides in (("float32", {}), ("bf16", dict(bf16=True))):
            trainer = make(f"rates_{label}", **overrides)
            gen = torch.Generator(dev).manual_seed(5)
            _, _, memory[f"step_{label}"] = first_call_memory(
                lambda: [trainer._train_step(next(it), gen) for _ in range(2)])
            r = rates[label] = {}
            for graphed in (True, False):
                which = "graphed" if graphed else "eager"
                if not graphed:
                    trainer._step_graphs = None
                ms = timed_steps(trainer, it, gen)
                wall, busy, kernels = wall_and_busy_ms(
                    lambda: [trainer._train_step(next(it), gen) for _ in range(TRAIN_PROFILED)])
                r[which] = dict(ms_per_step=ms, steps_per_s=1e3 / ms,
                                profiled_ms_per_step=wall / TRAIN_PROFILED,
                                device_busy_ms_per_step=busy / TRAIN_PROFILED,
                                device_idle_share=1.0 - busy / wall,
                                kernels_per_step=kernels / TRAIN_PROFILED)
                if busy > wall:
                    fail("phase17 (d): the profiler's device time exceeds the wall time")
            r["graphed_over_eager"] = r["graphed"]["steps_per_s"] / r["eager"]["steps_per_s"]
            log(f"phase17 (d) chignolin training step {label}, batch {batch}, "
                f"{TRAIN_TIMED} steps after {TRAIN_WARMUP}, {TRAIN_PROFILED} under "
                f"torch.profiler: " + json.dumps(r))
            if label == "float32":
                gen = torch.Generator(dev).manual_seed(5)
                _, _, memory["eval"] = first_call_memory(
                    lambda: trainer.eval_loss(val, TRAIN_EVAL_ITERS, gen))
                _, _, memory["sample"] = first_call_memory(lambda: trainer.sample(batch, gen))
            del trainer
        log(f"phase17 (d) memory of the trainer's graphs' first calls, MiB (the step's two "
            f"halves and Adam's moments at the first two steps; eval_loss; sample's "
            f"reverse step at batch {batch}): {json.dumps(memory)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = time.perf_counter() - started
    out["phase_s"] = dict(a=mark_a, b=mark_b - mark_a, c=mark_c - mark_b, d=total - mark_c,
                          total=total)
    log("phase17 seconds: " + json.dumps(out["phase_s"]))
    return out


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
    from twoforone_torch.cli.sample import load_model
    from twoforone_torch.utils.artifacts import load_ema_params, trained_dir
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

    def k1_plan(chains):
        """K1's plan as its wrapper makes it: tiles shared by clusters where few."""
        return plan_tiles(chains, *k1_dims, sms,
                          resident_clusters=fcl._resident_clusters(fcl._lib()))

    k1_chains = sorted({*K1_CHAINS, *RAGGED_CHAINS, *(c for c in (tile - 1, tile, tile + 1) if c)})
    k1_err = 0.0
    for chains in k1_chains:
        x = normal(chains, (chains, 10, 3), dev)
        plan = k1_plan(chains)
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
                f"rows={plan.rows} tiles={plan.tiles} blocks={plan.blocks} "
                f"cluster={plan.cluster} t={label}:{t} "
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
        plan = k1_plan(chains)
        scratch_bytes = scratch_traffic_bytes(fw, chains)
        timing[chains] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              flops=flops)
        log(f"phase2 timing fused_force_cl chains={chains} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} bound_by={bound_by} "
            f"residual_traffic_mb={scratch_bytes / 1e6:.1f} "
            f"residual_traffic_ms_at_hbm_rate={scratch_bytes / PEAK_BYTES_PER_S * 1e3:.4f} "
            f"scratch_allocated_mb={4 * plan.groups * plan.scratch_floats / 1e6:.1f} "
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
            log(f"phase2 timing cl_attention_{which} N={n} B={b} kernel_ms={tm['ms']:.4f} "
                f"device_ms={tm['device_ms']:.4f}{extra} "
                f"bound_ms={tm['bound_ms']:.4f} bound_by={tm['bound_by']} "
                f"share_of_bound={tm['bound_ms'] / tm['device_ms']:.3f} "
                f"gflop={flops / 1e9:.3f} mbytes={nbytes / 1e6:.1f} "
                f"achieved_gb_per_s={nbytes / tm['device_ms'] / 1e6:.1f}")

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

    # The staged models that only the CLI phase runs: K4 on villin (N=35) and
    # protein G (N=56), K1 on alanine dipeptide (N=5), at the chain count
    # the CLI phase gives them and at its noise level (fixed t) and a
    # sampler's (runtime t), before the CLI phase times them.
    from twoforone_torch.ops.tile_plan import UNIT_CAP_FLOATS, head_group, unit_floats

    staged = {name: load_model(trained_dir(name), "best", device=dev)[:2]
              for name in ("ala5", "chain35", "chain56")}
    for name in ("chain35", "chain56"):
        g, w = staged[name]
        check_k4(name, g.model, w, CLI_SMALL_CHAINS, CLI_T, 90 + g.num_atoms)
        f = fsc.augment_params(g.model, w, dev)
        plan = plan_tiles(CLI_SMALL_CHAINS, f.n, f.c, f.heads, f.dh, f.ff, f.n_layers, sms)
        group = head_group(f.n, f.heads, f.dh)
        log(f"phase2 fused_force {name} N={f.n} chains={CLI_SMALL_CHAINS} "
            f"chains_per_tile={plan.chains_per_tile} rows={plan.rows} "
            f"shared_memory_per_block_bytes={plan.smem_bytes} "
            f"attention_unit_bytes={4 * unit_floats(f.n, group, f.dh, 4)} "
            f"of_limit_bytes={4 * UNIT_CAP_FLOATS} heads_per_unit={group}")
    g, w = staged["ala5"]
    fw_ala = fcl.augment_params_cl(g.model, w, dev)
    x = normal(5, (CLI_SMALL_CHAINS, 5, 3), dev)
    for label, t in (("fixed", CLI_T), ("runtime", 0.37)):
        out = fcl.fused_force_cl(x, t, fw_ala)
        torch.cuda.synchronize()
        ref = fcl.fused_force_cl_reference(x, t, fw_ala)
        err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= TOL_REL * scale
        log(f"phase2 fused_force_cl ala5 N=5 chains={CLI_SMALL_CHAINS} t={label}:{t} "
            f"max_abs_err={err:.3e} max_rel_err={err / scale:.3e} tol_rel={TOL_REL} ok={ok}")
        if not ok:
            fail("phase2: fused_force_cl disagrees with its plain version on ala5")
        k1_err = max(k1_err, err)

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
    for name in ("chain35", "chain56"):
        g, w = staged[name]
        fixed = fsc.make_fused_force_kernel(g.model, w, CLI_T, dev)
        x = normal(7, (CLI_SMALL_CHAINS, g.num_atoms, 3), dev)
        ms = cuda_time_ms(lambda: fixed(x), 20)
        plain_ms = cuda_time_ms(lambda: fsc.fused_force_reference(x, CLI_T, fixed.folded),
                                PLAIN_REPS)
        f = fixed.folded
        flops = fused_force_flops(f, CLI_SMALL_CHAINS)
        bound_ms, bound_by = bound(flops, 4 * (2 * x.numel() + f.flat.numel()))
        k4_timing[f"{name}_{CLI_SMALL_CHAINS}"] = dict(ms=ms, plain_ms=plain_ms,
                                                       bound_ms=bound_ms, bound_by=bound_by,
                                                       flops=flops)
        log(f"phase2 timing fused_force {name} N={f.n} C={f.c} chains={CLI_SMALL_CHAINS} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
            f"bound_by={bound_by} gflop={flops / 1e9:.3f} "
            f"achieved_tflops={flops / ms / 1e9:.3f}")
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

    # ---------------------------------------------------------- phase 9
    cli_rates, cli_outputs = cli_phase(reset_counts, add_counts, sps[1000])
    mark("phase9")

    # ---------------------------------------------------------- phase 10
    training, k1_trained_err = training_phase(reset_counts, add_counts, dev)
    k1_err = max(k1_err, k1_trained_err)
    mark("phase10")

    # ---------------------------------------------------------- phase 11
    control = positive_control_phase(reset_counts, add_counts, counts, dev)
    mark("phase11")

    # ---------------------------------------------------------- phase 12
    mesh_numbers, rank_launches = mesh_phase(reset_counts, add_counts, dev, sps[1000])
    for name, count in zip(("k1", "fwd", "bwd", "k4"), rank_launches):
        launches[name] += count
    mark("phase12")

    # ---------------------------------------------------------- phase 13
    bf16_numbers = bf16_phase(reset_counts, add_counts, dev,
                              training["chain10_step"]["steps_per_s"])
    mark("phase13")

    # ---------------------------------------------------------- phase 14
    installed, installed_launches = installed_phase(cli_outputs, cli_rates)
    for name, count in zip(("k1", "fwd", "bwd", "k4"), installed_launches):
        launches[name] += count
    mark("phase14")

    # ---------------------------------------------------------- phase 15
    workflows = workflow_phase(reset_counts, add_counts, dev, sps[100])
    mark("phase15")

    # ---------------------------------------------------------- phase 16
    graph_numbers = graph_phase(reset_counts, add_counts, dev)
    mark("phase16")

    # ---------------------------------------------------------- phase 17
    train_graph_numbers = train_graph_phase(reset_counts, add_counts, dev)
    mark("phase17")
    log("steps_per_s " + json.dumps({
        **{f"chignolin_chains_{c}": sps[c] for c in CHAINS},
        **{f"{name}_chains_{TRP_CHAINS}_{mode}": rate
           for (name, mode), rate in protein_sps.items()},
        **{f"chignolin_chains_{c}_always": k4_sps[c] for c in CHAINS},
    }))
    log("samples_per_s " + json.dumps(samples_per_s))
    log("cli " + json.dumps(cli_rates))
    log("training " + json.dumps(training))
    log("positive_control " + json.dumps(control))
    log("mesh " + json.dumps(mesh_numbers))
    log("bf16 " + json.dumps(bf16_numbers))
    log("installed " + json.dumps(installed))
    log("workflows " + json.dumps(workflows))
    log("graphs " + json.dumps(graph_numbers))
    log("training_graphs " + json.dumps(train_graph_numbers))
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
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of phase 12 (b), started by main()
        sys.exit(mesh_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--installed-run"]:  # phase 14's process, started by main()
        sys.exit(installed_run_main(sys.argv[2]))
    sys.exit(main())
