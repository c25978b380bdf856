"""Percent of K1's launches whose tiles were shared by the blocks of a
thread-block cluster (``fused_force_cl.clustered`` over
``fused_force_cl.launches``, process-wide, graph replays included), or None
off the card, in another driver kind, or where the program keeps no such
counter. 100: every force evaluation of the run split its chains' work over
clusters; 0: one block a tile, as many chains give."""


def read(run):
    if run.cell.device.type != "cuda" or run.cell.traffic["driver"] != "langevin":
        return None
    from twoforone_torch.ops.fused_score_cl import fused_force_cl

    clustered = getattr(fused_force_cl, "clustered", None)
    if clustered is None or not fused_force_cl.launches:
        return None
    return 100.0 * clustered / fused_force_cl.launches
