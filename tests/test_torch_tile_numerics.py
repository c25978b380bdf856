"""Numerics of the tile core of the whole-force kernels, emulated on the CPU.

The kernels carry their matrix products on the tensor cores, whose float32
path takes TF32 operands (10 explicit mantissa bits). ``csrc/tile_gemm.cuh``
splits each operand into two TF32 parts and sums three products
(a_lo b_hi + a_hi b_lo + a_hi b_hi) in float32. The first tests repeat that
arithmetic in numpy on the staged chain10 weights for every product shape of
a layer: the split stays within 1e-6 of the float64 product (relative to its
largest entry), and a single TF32 pass misses 1e-4, the bound that
``chip_smoke.py`` holds the kernels to, which is why the split is there.
The last tests hold the kernels' weight layout (the three input projections
stored as one matrix) against the per-layer tensors the plain versions read.
"""

import numpy as np
import pytest

from twoforone_torch.models.graph_transformer import GraphTransformer, init_params
from twoforone_torch.ops import fused_score as fs
from twoforone_torch.ops import fused_score_cl as fcl
from twoforone_torch.utils.artifacts import load_ema_params

ROWS = 80  # the widest tile


def to_tf32(a):
    """Round float32 to TF32, ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    hi = to_tf32(a)
    return hi, to_tf32(a - hi)


def product_three_pass(a, b):
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi  # float32 sums, small terms first


@pytest.fixture(scope="module")
def chain10():
    model = GraphTransformer(10, 64, 3, use_intrinsic_coords=True, use_abs_coords=False,
                             use_distances=False)
    return fcl.augment_params_cl(model, load_ema_params("chain10"), "cpu")


# (name of the product, weight as stored for it): the forward products and the
# backward's, whose weights are the transposes.
def layer_products(d):
    wqkv = np.concatenate([d[k].numpy() for k in ("wq", "wk", "wv")], axis=1)
    mats = {"wqkv": wqkv, "wo": d["wo"].numpy(), "w1": d["w1"].numpy(), "w2": d["w2"].numpy()}
    return {**mats, **{k + "T": np.ascontiguousarray(v.T) for k, v in mats.items()}}


PRODUCTS = ("wqkv", "wo", "w1", "w2", "wqkvT", "woT", "w1T", "w2T")


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("name", PRODUCTS)
def test_three_pass_split_keeps_float32_accuracy(chain10, layer, name):
    w = layer_products(chain10.layers[layer])[name]
    x = np.random.default_rng(100 * layer + PRODUCTS.index(name)).normal(
        size=(ROWS, w.shape[0])).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(exact).max()
    assert np.abs(product_three_pass(x, w) - exact).max() <= 1e-6 * scale
    # The split is exact to 22 bits: hi + lo gives the operand back to ~2^-22.
    hi, lo = split(x)
    assert np.abs((hi.astype(np.float64) + lo) - x).max() <= 2.0**-21 * np.abs(x).max()


@pytest.mark.parametrize("name", PRODUCTS)
def test_single_tf32_pass_misses_the_kernels_bound(chain10, name):
    w = layer_products(chain10.layers[0])[name]
    x = np.random.default_rng(PRODUCTS.index(name)).normal(size=(ROWS, w.shape[0])).astype(
        np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    one_pass = to_tf32(x) @ to_tf32(w)
    assert np.abs(one_pass - exact).max() > 1e-4 * np.abs(exact).max()


def test_to_tf32_keeps_ten_mantissa_bits():
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    r = to_tf32(x)
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.abs(r - x).max() <= 2.0**-11 * np.abs(x).max()
    np.testing.assert_array_equal(to_tf32(r), r)


def check_layout(flat, order, layers, inner):
    """Walks the flat buffer by ``order`` and holds the merged projections
    against the per-layer tensors."""
    off = 0
    for d in layers:
        sizes = {"wqkv": d["wq"].numel() * 3, "bqkv": 3 * inner, "wqkvT": d["wq"].numel() * 3}
        for key in order:
            base = key[:-1] if key.endswith("T") else key
            size = sizes.get(key, d[base].numel() if base in d else None)
            piece = flat[off:off + size]
            if key == "wqkv":
                got = piece.reshape(-1, 3 * inner)
                for i, name in enumerate(("wq", "wk", "wv")):
                    np.testing.assert_array_equal(got[:, i * inner:(i + 1) * inner],
                                                  d[name].numpy())
            elif key == "bqkv":
                np.testing.assert_array_equal(
                    piece, np.concatenate([d[k].numpy() for k in ("bq", "bk", "bv")]))
            elif key == "wqkvT":
                got = piece.reshape(3 * inner, -1)
                for i, name in enumerate(("wq", "wk", "wv")):
                    np.testing.assert_array_equal(got[i * inner:(i + 1) * inner],
                                                  d[name].numpy().T)
            elif key.endswith("T"):
                np.testing.assert_array_equal(piece.reshape(d[base].shape[::-1]),
                                              d[base].numpy().T)
            else:
                np.testing.assert_array_equal(piece, d[key].numpy().ravel())
            off += size
    return off


def test_chain_lane_weight_layout_round_trips(chain10):
    end = check_layout(chain10.flat.numpy(), fcl._LAYER_ORDER, chain10.layers, chain10.inner)
    tail = chain10.flat.numpy()[end:]
    np.testing.assert_array_equal(tail[:640], chain10.glob["h0"].numpy().ravel())
    assert tail.size == 640 + 64 + 64 + 1
    assert end % 4 == 0  # every matrix of the buffer starts 16-byte aligned


@pytest.mark.parametrize("intrinsic,distances,abs_coords",
                         [(True, False, False), (False, True, True), (True, True, False),
                          (False, False, True)])
def test_every_edge_configuration_weight_layout_round_trips(intrinsic, distances, abs_coords):
    model = GraphTransformer(6, 16, 2, heads=2, dim_head=8, use_intrinsic_coords=intrinsic,
                             use_distances=distances, use_abs_coords=abs_coords)
    fw = fs.augment_params(model, init_params(model, 1), "cpu")
    end = check_layout(fw.flat.numpy(), fs.layer_order(intrinsic, distances), fw.layers,
                       fw.inner)
    assert end % 4 == 0
    assert fw.flat.numel() - end == 6 * 16 + 3 * 16 * abs_coords + 2 * 16 + 1
