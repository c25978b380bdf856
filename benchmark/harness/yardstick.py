"""The benchmark's yardstick: the card's published peaks and the operations
and bytes of the port's work, counted from shapes.

The counts are copies of ``chip_smoke.py``'s (``fused_force_flops``,
``core_work``, ``bound``): operations are the products of a call
(elementwise work is a few percent and left out), bytes are each input read
once and each output written once, whatever a kernel reads again.
"""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor cores
# and HBM3 bandwidth. Every kernel of the port computes a float32 function in
# float32 on the CUDA cores (TF32 off), so the operation bound is taken at
# the FP32 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
HEADS = 8
DIM_HEAD = 64


def bound_s(flops: float, nbytes: float) -> float:
    """Least time the card could take, in seconds: the larger of the two
    bounds."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def fused_force_flops(n: int, c: int, layers: int, chains: int) -> float:
    """Operations of one force evaluation (forward and input-gradient
    backward) of ``chains`` chains of ``n`` beads at width ``c``, on the
    production edges (coordinate differences): per chain per layer
    16 N C I + 8 N C F + 12 H N^2 dh + 18 N I (I = H dh = 512, F = 4 C)."""
    i, f, h, dh = HEADS * DIM_HEAD, 4 * c, HEADS, DIM_HEAD
    per_layer = 16 * n * c * i + 8 * n * c * f + 12 * h * n * n * dh + 18 * n * i
    return float(chains * layers * per_layer)


def train_step_flops(n: int, c: int, layers: int, batch: int) -> float:
    """Operations of one training step: the force evaluation (forward and
    input-gradient backward) and the loss's backward through both, whose
    products are twice the force's: three force evaluations' worth."""
    return 3.0 * fused_force_flops(n, c, layers, batch)


def weight_bytes(n: int, c: int, layers: int) -> float:
    """Bytes of the network's float32 weights (production edges)."""
    i = HEADS * DIM_HEAD
    per_layer = 4 * c + (c * i + i) + (c * 2 * i + 2 * i) + (c * i + i) + (i * c + c) \
        + 2 * 3 * c + (c * 4 * c + 4 * c) + (4 * c * c + c)
    return 4.0 * ((n + 1) * c + c + 3 * c + c + layers * per_layer + c + 1)


def force_call_bytes(n: int, c: int, layers: int, chains: int) -> float:
    """Bytes one whole-force call must move: coordinates in, forces out, the
    weights once."""
    return 2 * 4.0 * chains * n * 3 + weight_bytes(n, c, layers)


def core_work(b: int, n: int, h: int = HEADS, dh: int = DIM_HEAD):
    """(flops, bytes) of the attention core's forward (K2) and backward
    (K3): each input read once, each output written once (x and dx, summed
    over heads, are shared by the heads)."""
    fwd = (b * h * (4 * n * n * dh + 12 * n * n),
           4 * (b * h * (4 * n * dh + 7 * n) + b * 3 * n))
    bwd = (b * h * (10 * n * n * dh + 30 * n * n),
           4 * (b * h * (7 * n * dh + 11 * n) + b * 6 * n))
    return fwd, bwd
