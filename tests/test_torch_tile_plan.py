"""The tile plan of the whole-force kernels (``ops/tile_plan.py``): how a
batch of chains is cut into tiles, and the scratch and shared memory a launch
needs. The CUDA sources hold the same numbers against their own formulas
(``tests/test_torch_cuda_emulation.py`` compares them through the compiled
sources); here the plan's own promises are checked for every (N, batch) that
``chip_smoke.py`` drives and for the staged widths."""

import os

import pytest

from twoforone_torch.ops import _build
from twoforone_torch.ops import tile_plan as tp

SMS = 132  # an H100's streaming multiprocessors
# name -> (N, C, heads, dh, F, layers): the staged models.
WIDTHS = {"chain10": (10, 64, 8, 64, 256, 3), "chain20": (20, 128, 8, 64, 512, 3),
          "chain28": (28, 96, 8, 64, 384, 3)}
# Chain counts of chip_smoke.py's paths and checks.
BATCHES = (1, 3, 4, 5, 37, 100, 256, 257, 1000, 1024, 4096)
# Clusters of 2 and 4 of K1's blocks (16 rows of chignolin) that an H100
# keeps resident at once, as its occupancy query answered: not the 66 of 4
# that its 264 blocks would give, since its SMs come in groups.
H100_CLUSTERS = {2: 132, 4: 62}


def h100_clusters(plan, size):
    return H100_CLUSTERS[size]


@pytest.mark.parametrize("name", WIDTHS)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("distances", [False, True])
@pytest.mark.parametrize("clusters", [None, h100_clusters], ids=["blocks", "clusters"])
def test_plan_covers_every_chain_once_within_the_cards_limits(name, batch, distances, clusters):
    n, c, heads, dh, ff, layers = WIDTHS[name]
    p = tp.plan_tiles(batch, n, c, heads, dh, ff, layers, SMS, distances=distances,
                      resident_clusters=clusters)
    assert p.rows % 16 == 0 and p.rows == 16 * p.row_blocks <= 16 * tp.MAX_ROW_BLOCKS
    assert p.chains_per_tile * n <= p.rows < p.chains_per_tile * n + 16
    # Every chain in exactly one tile; only the last tile may be ragged.
    sizes = [min(p.chains_per_tile, batch - t * p.chains_per_tile) for t in range(p.tiles)]
    assert sum(sizes) == batch and all(s == p.chains_per_tile for s in sizes[:-1])
    assert 1 <= sizes[-1] <= p.chains_per_tile
    # A tile to a block, or to a cluster of blocks that divides the heads;
    # every cluster resident at once.
    assert p.cluster in (1, 2, 4) and heads % p.cluster == 0 and p.blocks % p.cluster == 0
    assert 1 <= p.groups <= p.tiles and p.blocks <= tp.MAX_BLOCKS_PER_SM * SMS
    if p.cluster > 1:
        assert p.groups == p.tiles <= H100_CLUSTERS[p.cluster]
    if clusters is None:  # a kernel whose blocks do not share tiles (K4)
        assert p.cluster == 1
    assert p.smem_bytes <= tp.BLOCK_SMEM_BYTES
    # Two resident blocks fit an SM, as the kernels are compiled for.
    assert 2 * (p.smem_bytes + tp.BLOCK_RESERVED_BYTES) <= tp.SM_SMEM_BYTES
    assert p.smem_bytes == tp.smem_bytes(p.chains_per_tile, p.rows, n, heads, dh, distances)
    assert p.scratch_floats == tp.scratch_floats(p.chains_per_tile, p.rows, n, c, heads * dh, ff,
                                                 heads, layers, distances)
    assert p.scratch_floats % 4 == 0  # every buffer of the scratch starts 16-byte aligned


def test_tile_size_follows_the_chain_count():
    dims = WIDTHS["chain10"]
    by_batch = {b: tp.plan_tiles(b, *dims, SMS).chains_per_tile for b in BATCHES}
    # Fewer chains than resident blocks: a block for every chain.
    assert by_batch[1] == by_batch[100] == by_batch[257] == 1
    # Many chains: several chains share each pass over the weights, in one wave
    # where that is possible.
    assert by_batch[1000] > 1 and by_batch[4096] >= by_batch[1000]
    p = tp.plan_tiles(1000, *dims, SMS)
    assert p.tiles <= tp.MAX_BLOCKS_PER_SM * SMS
    # The widest tile holds 80 rows.
    assert tp.plan_tiles(4096, *dims, SMS).rows <= 80
    assert tp.plan_tiles(4096, *WIDTHS["chain20"], SMS).chains_per_tile <= 4


def test_cluster_follows_the_chain_count():
    """Few chains: each tile to a cluster, the largest whose clusters the card
    holds at once; many: one block a tile, the launch as without clusters."""
    dims = WIDTHS["chain10"]

    def plan(batch):
        return tp.plan_tiles(batch, *dims, SMS, resident_clusters=h100_clusters)

    assert (plan(100).cluster, plan(100).chains_per_tile, plan(100).blocks) == (2, 1, 200)
    assert plan(50).cluster == 4 and plan(50).blocks == 200
    assert plan(62).cluster == 4 and plan(63).cluster == 2  # 62 clusters of 4 resident
    assert plan(132).cluster == 2 and plan(133).cluster == 1
    for batch in (1000, 4096):
        assert plan(batch) == tp.plan_tiles(batch, *dims, SMS)
        assert plan(batch).cluster == 1
    # The plan asks the card only where a cluster could fit.
    asked = []
    tp.plan_tiles(1000, *dims, SMS, resident_clusters=lambda p, size: asked.append(size) or 0)
    tp.plan_tiles(100, *dims, SMS, resident_clusters=lambda p, size: asked.append(size) or 0)
    assert asked == [2]
    assert tp.plan_tiles(100, *dims, SMS, resident_clusters=lambda p, size: 99).cluster == 1


@pytest.mark.parametrize("heads,want", [(8, 4), (6, 2), (3, 1)])
def test_cluster_divides_the_heads(heads, want):
    """A cluster shares out the heads: its size divides them."""
    n, c, _, dh, ff, layers = WIDTHS["chain10"]
    p = tp.plan_tiles(40, n, c, heads, dh, ff, layers, SMS, resident_clusters=h100_clusters)
    assert p.cluster == want and p.blocks == 40 * want
    with pytest.raises(ValueError, match="divide the"):
        tp.plan_at(1, 40, n, c, 3, dh, ff, layers, SMS, cluster=2)
    with pytest.raises(ValueError, match="divide the"):
        tp.plan_at(1, 40, n, c, heads, dh, ff, layers, SMS, cluster=3)


def test_clustered_plan_keeps_the_tile_and_its_scratch():
    """A cluster shares one tile's scratch: the same tile size, rows, shared
    memory and scratch floats as one block a tile, and one scratch a tile."""
    dims = WIDTHS["chain10"]
    one = tp.plan_at(1, 100, *dims, SMS)
    two = tp.plan_at(1, 100, *dims, SMS, cluster=2)
    assert (two.rows, two.tiles, two.smem_bytes, two.scratch_floats) == (
        one.rows, one.tiles, one.smem_bytes, one.scratch_floats)
    assert (one.groups, two.groups, two.blocks) == (100, 100, 200)
    # More tiles than resident clusters: the clusters walk over the tiles.
    four = tp.plan_at(1, 1000, *dims, SMS, cluster=4)
    assert four.blocks == 264 and four.groups == 66


@pytest.mark.parametrize("per_tile", [1, 2, 7, 8])
def test_tile_size_can_be_fixed(per_tile):
    p = tp.plan_at(per_tile, 37, *WIDTHS["chain10"], SMS)
    assert p.chains_per_tile == per_tile and p.tiles == -(-37 // per_tile)
    assert p.rows == 16 * -(-per_tile * 10 // 16)


def test_plan_refuses_what_a_tile_cannot_hold():
    with pytest.raises(ValueError, match="at least one chain"):
        tp.plan_tiles(0, *WIDTHS["chain10"], SMS)
    with pytest.raises(ValueError, match="at most 80 rows"):
        tp.plan_tiles(4, 81, 64, 8, 64, 256, 3, SMS)
    with pytest.raises(ValueError, match="chains_per_tile must be in 1..8"):
        tp.plan_at(9, 100, *WIDTHS["chain10"], SMS)


def test_ring_constants_match_the_header():
    """tile_plan.py repeats the constants of csrc/tile_gemm.cuh."""
    header = open(os.path.join(os.path.dirname(_build.__file__), "csrc", "tile_gemm.cuh")).read()
    for name, value in (("KC", tp.KC), ("OC", tp.OC), ("STAGES", tp.STAGES),
                        ("MAX_TM", tp.MAX_ROW_BLOCKS)):
        assert f"constexpr int {name} = {value};" in header
    assert "constexpr int XS = KC + 4;" in header and tp.XS == tp.KC + 4
    assert "constexpr int WS = OC + 8;" in header and tp.WS == tp.OC + 8


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """An edited header gives every source that may include it a new library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "shared.cuh"\n')
    (csrc / "b.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "_CSRC", str(csrc))
    before = {name: _build.library_path(name) for name in ("a", "b")}
    assert before == {name: _build.library_path(name) for name in ("a", "b")}
    (csrc / "shared.cuh").write_text("// two\n")
    after = {name: _build.library_path(name) for name in ("a", "b")}
    assert all(before[name] != after[name] for name in before)
    (csrc / "a.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build.library_path("a") != after["a"] and _build.library_path("b") == after["b"]


@pytest.mark.parametrize("known", [True, False])
def test_split_compile_only_where_the_compiler_knows_it(tmp_path, monkeypatch, known):
    """The flag that shortens the build is passed to a compiler whose help
    text lists it, and to no other."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho '--threads'\n"
                    + ("echo '--split-compile <number>'\n" if known else ""))
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    _build._flags.cache_clear()
    try:
        flags = _build._flags()
    finally:
        _build._flags.cache_clear()
    assert flags[:len(_build.NVCC_FLAGS)] == tuple(_build.NVCC_FLAGS)
    assert list(flags[len(_build.NVCC_FLAGS):]) == (_build.SPLIT_COMPILE if known else [])
