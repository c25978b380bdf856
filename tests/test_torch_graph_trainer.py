"""The trainer's i.i.d. sampling in its graphed form
(``twoforone_torch/train/trainer.py::Trainer.sample``).

On the card ``Trainer.sample`` (the evaluations' and the positive control's
i.i.d. stage) replays one captured ancestral step over all its batches and
all its calls.
Here the stand-in of ``test_torch_graph_capture.py`` takes the CUDA graph's
place, and the samples are held bit for bit against the eager chain.
"""

import numpy as np
import pytest
import torch

from test_torch_graph_capture import StandInGraphs
from test_torch_train import CONFIGS, _chignolin_sets, _trainer


@pytest.mark.parametrize("num_samples", [8, 13])
def test_trainer_sample_graphed_equals_eager(tmp_path, num_samples):
    """13 samples at batch 8 are two full batches (the second replays every
    step of the first's graph), truncated. The trainer keeps its graph: a
    second call, after an EMA update in place, replays it and gives the
    eager chain's samples of the new weights."""
    trainer = _trainer(tmp_path, dict(CONFIGS["default_edges"], mol="chignolin", batch_size=8,
                                      diffusion_steps=30), _chignolin_sets())
    assert trainer._sample_graphs is None  # the CPU runs the eager chain
    eager = trainer.sample(num_samples, torch.Generator().manual_seed(0))
    graphs = trainer._sample_graphs = StandInGraphs()
    graphed = trainer.sample(num_samples, torch.Generator().manual_seed(0))
    assert graphed.shape == (num_samples, 10, 3) and np.array_equal(graphed, eager)
    assert list(graphs.graphs) == [("ancestral", (8, 10, 3))]
    calls = 30 * (num_samples // 8 + (num_samples % 8 > 0))
    assert graphs.graphs[("ancestral", (8, 10, 3))][0].replays == calls - 1

    with torch.no_grad():
        for p in trainer.ema.parameters():
            p.mul_(0.9)
    again = trainer.sample(num_samples, torch.Generator().manual_seed(0))
    trainer._sample_graphs = None
    assert np.array_equal(again, trainer.sample(num_samples, torch.Generator().manual_seed(0)))
    assert not np.array_equal(again, eager)
    assert graphs.warm_ups == 1
    assert graphs.graphs[("ancestral", (8, 10, 3))][0].replays == 2 * calls - 1
