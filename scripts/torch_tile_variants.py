"""Times the chain-lane whole-force kernel (K1) on the card at every tile
size.

    python3 scripts/torch_tile_variants.py [chains ...]

Holds ``fused_force_cl`` against the plain version on chain10 weights and
times it at 100, 1000 and 4096 chains (or the chain counts given) with the
tile size the plan picks and with every other tile size forced, so that the
plan's choice can be read against the rest. It prints ptxas's registers and
spills and the card's name and power limit.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import cuda_time_ms, resource_usage  # noqa: E402
from twoforone_torch.models.graph_transformer import GraphTransformer  # noqa: E402
from twoforone_torch.ops import _build, tile_plan  # noqa: E402
from twoforone_torch.ops import fused_score_cl as fcl  # noqa: E402
from twoforone_torch.utils.artifacts import load_ema_params  # noqa: E402
from twoforone_torch.utils.device import sm_count  # noqa: E402


def main():
    chain_counts = [int(a) for a in sys.argv[1:]] or [100, 1000, 4096]
    dev = torch.device("cuda")
    model = GraphTransformer(10, 64, 3, use_intrinsic_coords=True, use_abs_coords=False,
                             use_distances=False)
    fw = fcl.augment_params_cl(model, load_ema_params("chain10"), dev)
    _build.load("fused_score_cl")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print("gpu:", smi, flush=True)
    print("ptxas " + json.dumps(resource_usage(_build.logs.get("fused_score_cl", ""))), flush=True)
    for chains in chain_counts:
        x = torch.from_numpy(np.random.default_rng(7).normal(size=(chains, 10, 3))
                             .astype(np.float32)).to(dev)
        ref = fcl.fused_force_cl_reference(x, 0.02, fw)
        for forced in (None, *range(1, min(tile_plan.max_chains_per_tile(10), chains) + 1)):
            # The wrapper asks its module's plan_tiles: stand a fixed tile size in its place.
            fcl.plan_tiles = (tile_plan.plan_tiles if forced is None
                              else functools.partial(tile_plan.plan_at, forced))
            plan = fcl.plan_tiles(chains, 10, 64, 8, 64, 256, 3, sm_count(0))
            out = fcl.fused_force_cl(x, 0.02, fw)
            torch.cuda.synchronize()
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            ms = cuda_time_ms(lambda: fcl.fused_force_cl(x, 0.02, fw), 30)
            print(json.dumps({
                "chains": chains, "forced": forced, "chains_per_tile": plan.chains_per_tile,
                "rows": plan.rows, "tiles": plan.tiles, "blocks": plan.blocks,
                "smem_bytes": plan.smem_bytes, "ms": ms, "max_rel_err": err}), flush=True)
    fcl.plan_tiles = tile_plan.plan_tiles
    print("gpu:", smi)


if __name__ == "__main__":
    main()
