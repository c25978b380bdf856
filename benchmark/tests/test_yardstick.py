"""The yardstick's counts against the hand counts."""

from __future__ import annotations

import pytest

from benchmark.harness import yardstick as y


def test_force_flops_match_the_hand_counts():
    # Per chain per layer 16 N C I + 8 N C F + 12 H N^2 dh + 18 N I, 3 layers.
    assert y.fused_force_flops(10, 64, 3, 1000) == pytest.approx(21.78048e9, rel=1e-12)
    assert y.fused_force_flops(20, 128, 3, 1000) == pytest.approx(102.2976e9, rel=1e-12)
    assert y.train_step_flops(10, 64, 3, 512) == 3 * y.fused_force_flops(10, 64, 3, 512)


def test_k1_bound_is_the_operation_bound():
    flops = y.fused_force_flops(10, 64, 3, 1000)
    nbytes = y.force_call_bytes(10, 64, 3, 1000)
    assert y.bound_s(flops, nbytes) == flops / y.PEAK_FP32_FLOPS  # 0.3251 ms
    assert y.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.3251, abs=1e-4)


def test_weight_bytes_count_every_parameter():
    import numpy as np

    from benchmark.reference.msgpack_reader import read_checkpoint
    from benchmark.harness import files

    for chain, n, c in (("chain10", 10, 64), ("chain20", 20, 128)):
        path = f"{files.ROOT}/twoforone_tpu/assets/trained/{chain}/model-best.msgpack"
        tree = read_checkpoint(path)

        def size(t):
            return sum(size(v) for v in t.values()) if isinstance(t, dict) else np.asarray(t).nbytes

        assert y.weight_bytes(n, c, 3) == size(tree["ema_params"])


def test_attention_core_bound_matches_chip_smoke():
    # trp-cage, 1000 chains: 0.0503 ms (K2) and 0.0878 ms (K3), both bytes-bound.
    fwd, bwd = y.core_work(1000, 20)
    assert y.bound_s(*fwd) * 1e3 == pytest.approx(0.0503, abs=1e-4)
    assert y.bound_s(*bwd) * 1e3 == pytest.approx(0.0878, abs=1e-4)
