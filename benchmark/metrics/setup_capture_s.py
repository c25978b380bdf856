"""Host seconds of the run's CUDA graph warm-ups and captures
(``StepGraphs.capture_s``), or None off the card or where the program
keeps no such counter."""


def read(run):
    from twoforone_torch.utils.cuda_graph import StepGraphs

    return getattr(StepGraphs, "capture_s", None) if run.cell.device.type == "cuda" else None
