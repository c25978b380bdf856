"""How the whole-force kernels cut a batch of chains into tiles.

``csrc/fused_score_cl.cu`` and ``csrc/fused_score.cu`` run a fixed grid of
thread blocks that walk over *tiles* of ``chains_per_tile`` chains; a tile's
``chains_per_tile * N`` rows, padded to a multiple of 16, go through every
projection of the network as one matrix product (``csrc/tile_gemm.cuh``).
:func:`plan_tiles` picks the tile size from the chain count and works out
what a launch needs: rows, tiles, thread blocks, scratch floats per block and
bytes of shared memory. The numbers are passed to the launch as plain
integers; the CUDA sources hold them against their own formulas and refuse a
launch that disagrees, so this module is the one place that decides them and
the CPU tests cover it.
"""

from __future__ import annotations

from dataclasses import dataclass

# Constants of csrc/tile_gemm.cuh (namespace ``tile``).
KC = 32  # depth of a staged chunk
XS = KC + 4  # shared-memory row stride of an activation chunk
OC = 128  # output columns of a staged weight chunk
WS = OC + 8  # shared-memory row stride of a weight chunk
STAGES = 3  # ring of staged chunks
MAX_ROW_BLOCKS = 5  # a tile has at most 16 * 5 = 80 rows
UNIT_CAP_FLOATS = 25600  # largest attention unit (100 KB)

# An H100's shared memory: what one block may use, and what the blocks of one
# SM share (each also reserves 1 KB).
BLOCK_SMEM_BYTES = 227 * 1024
SM_SMEM_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024
# The kernels are compiled for two resident blocks an SM (128 registers a thread).
MAX_BLOCKS_PER_SM = 2
# A tile's time grows with its rows, on top of a fixed part (the passes over
# the weights, the barriers) that is worth about this many rows.
OVERHEAD_ROWS = 16


@dataclass(frozen=True)
class TilePlan:
    chains_per_tile: int
    row_blocks: int  # a tile has 16 * row_blocks rows
    tiles: int
    blocks: int  # thread blocks of the launch, each walks over tiles
    scratch_floats: int  # global scratch of ONE block
    smem_bytes: int  # dynamic shared memory of one block

    @property
    def rows(self) -> int:
        return 16 * self.row_blocks


def _round4(v: int) -> int:
    return (v + 3) & ~3


def gemm_smem_floats(rows: int) -> int:
    """``tile::gemm_smem_floats``: the ring of staged chunks."""
    return STAGES * (rows * XS + KC * WS)


def unit_floats(n: int, group: int, dh: int, mats: int) -> int:
    """``tile::unit_floats``: one chain's rows of ``mats`` slices of ``group``
    heads, and their per-head (N, N) matrices (one set forward, two backward)."""
    return n * (mats * group * dh + 4) + (mats - 2) * _round4(group * n * n)


def head_group(n: int, heads: int, dh: int) -> int:
    """``tile::head_group``: heads of an attention unit, the largest divisor of
    ``heads`` whose backward unit fits shared memory; 0 if one head does not."""
    for g in range(heads, 0, -1):
        if heads % g == 0 and unit_floats(n, g, dh, 4) <= UNIT_CAP_FLOATS:
            return g
    return 0


def work_smem_floats(rows: int, n: int, heads: int, dh: int) -> int:
    """``tile::work_smem_floats``: the products' ring and the attention's
    units share one region."""
    return max(gemm_smem_floats(rows), unit_floats(n, head_group(n, heads, dh), dh, 4))


def heads_floats(chains: int, n: int, heads: int) -> int:
    """One set of per-head (N, N) matrices of a tile."""
    return _round4(chains * heads * n * n)


def scratch_floats(chains: int, rows: int, n: int, c: int, inner: int, ff: int, heads: int,
                   layers: int, distances: bool = False) -> int:
    """``block_scratch_floats`` of both sources: per layer the residuals the
    backward needs, plus one set of working buffers. With squared distances
    two per-head row vectors join the residuals."""
    hf = heads_floats(chains, n, heads)
    resid = 4 * rows * c + 3 * rows * inner + hf + rows * ff + 2 * rows
    if distances:
        resid += 2 * _round4(chains * heads * n)
    work = 3 * rows * c + 5 * rows * inner + rows * ff
    return layers * resid + work


def smem_bytes(chains: int, rows: int, n: int, heads: int, dh: int,
               distances: bool = False) -> int:
    """``smem_floats`` of both sources, in bytes: the working region (ring or
    attention unit), the tile's centred coordinates with their gradient, the
    chains' centres; with squared distances two per-head row vectors."""
    floats = (work_smem_floats(rows, n, heads, dh) + 2 * _round4(3 * chains * n)
              + _round4(3 * chains))
    if distances:
        floats += 2 * _round4(chains * heads * n)
    return 4 * floats


def max_chains_per_tile(n: int) -> int:
    """Chains of ``n`` beads that the widest tile (80 rows) holds."""
    return max(1, 16 * MAX_ROW_BLOCKS // n)


def plan_at(chains_per_tile: int, batch: int, n: int, c: int, heads: int, dh: int, ff: int,
            layers: int, sm_count: int, distances: bool = False) -> TilePlan:
    """What a launch over ``batch`` chains needs at a given tile size.
    :func:`plan_tiles` chooses among these; the tests and the timing scripts
    also ask for a tile size of their own."""
    t = chains_per_tile
    if not 1 <= t <= max_chains_per_tile(n):
        raise ValueError(f"chains_per_tile must be in 1..{max_chains_per_tile(n)}, got {t}")
    row_blocks = -(-t * n // 16)
    rows = 16 * row_blocks
    smem = smem_bytes(t, rows, n, heads, dh, distances)
    if smem > BLOCK_SMEM_BYTES:
        raise ValueError(f"a tile of {t} chains of {n} beads needs {smem} bytes of "
                         "shared memory")
    per_sm = min(MAX_BLOCKS_PER_SM, SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES))
    tiles = -(-batch // t)
    return TilePlan(
        chains_per_tile=t, row_blocks=row_blocks, tiles=tiles,
        blocks=min(tiles, per_sm * sm_count),
        scratch_floats=scratch_floats(t, rows, n, c, heads * dh, ff, heads, layers, distances),
        smem_bytes=smem,
    )


def plan_tiles(batch: int, n: int, c: int, heads: int, dh: int, ff: int, layers: int,
               sm_count: int, distances: bool = False) -> TilePlan:
    """The tiling of a launch over ``batch`` chains of ``n`` beads on a card
    with ``sm_count`` SMs.

    The tile size follows the chain count: among the tile sizes that fit
    80 rows, the one with the least estimated time, waves x (rows +
    ``OVERHEAD_ROWS``), where a wave is one tile on every resident block. Many
    chains give full tiles, so that a pass over the weights serves many rows;
    fewer chains than resident blocks give tiles of one chain, so that every
    chain has a block of its own.
    """
    if batch < 1:
        raise ValueError(f"a launch needs at least one chain, got {batch}")
    if 16 * MAX_ROW_BLOCKS < n:
        raise ValueError(f"a tile holds at most {16 * MAX_ROW_BLOCKS} rows, got N={n}")
    if head_group(n, heads, dh) == 0:
        raise ValueError(f"one head of a chain (N={n}, dh={dh}) does not fit the attention's "
                         "shared memory")

    def cost(p: TilePlan):
        waves = -(-p.tiles // p.blocks)
        return (waves * (p.rows + OVERHEAD_ROWS), -p.chains_per_tile)

    sizes = range(1, min(max_chains_per_tile(n), batch) + 1)
    return min((plan_at(t, batch, n, c, heads, dh, ff, layers, sm_count, distances)
                for t in sizes), key=cost)
