"""Percent of the training batches staged through the trainer's pinned ring
that found their slot still being copied from (``StagingRing.waits`` over
``StagingRing.staged``), or None off the card, in another driver kind, or
where the program keeps no such counter. Near 100%: the host ran a whole
ring ahead and the device set the pace; near 0%: the host set it."""


def read(run):
    if run.cell.device.type != "cuda" or run.cell.traffic["driver"] != "train":
        return None
    from twoforone_torch.train import trainer

    ring = getattr(trainer, "StagingRing", None)
    if ring is None or not ring.staged:
        return None
    return 100.0 * ring.waits / ring.staged
