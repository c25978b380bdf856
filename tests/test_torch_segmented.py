"""Port's segment-checkpointed Langevin driving
(``twoforone_torch.dynamics.segmented``), on the CPU. The contracts of the
JAX package's segmented runs, held on the port:

- segmenting is invisible: the output equals ``LangevinDiffusion.sample()``
  bit for bit (one noise draw a step from the simulation's generator, whose
  state is checkpointed with the coordinates),
- a run killed between segments resumes, in a fresh ``LangevinDiffusion``,
  from the persisted state and gives identical frames,
- the ``_segmented_langevin_stage`` wrapper keeps the ``post_{name}.npy``
  cached-stage contract and removes its intermediates.
"""

import os

import numpy as np
import pytest

from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.dynamics.langevin import LangevinDiffusion
from twoforone_torch.dynamics.segmented import cleanup, segmented_sample
from twoforone_torch.models.graph_transformer import GraphTransformer, init_params
from twoforone_torch.train.positive_control import _segmented_langevin_stage


def _ld(**kw):
    model = GraphTransformer(num_beads=5, hidden_nf=16, n_layers=1, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False, conservative=True)
    gd = GaussianDiffusion(model=model, num_atoms=5, timesteps=1000, norm_factor=2.0,
                           loss_weights="ones")
    init = np.random.default_rng(3).normal(size=(4, 5, 3)).astype(np.float32)
    init -= init.mean(axis=1, keepdims=True)
    defaults = dict(n_timesteps=400, save_interval=50, t=8, temp_data=300, temp_sim=300,
                    dt=None, masses=[12.8] * 5, friction=1.0, kb="consistent",
                    random_seed=1, log=False, device="cpu")
    defaults.update(kw)
    return LangevinDiffusion(gd, init_params(model, 0), init, **defaults)


def test_segmented_equals_one_shot(tmp_path):
    one_shot = _ld().sample()
    seg = segmented_sample(_ld(), str(tmp_path), "lang", segment_steps=100)
    assert seg.dtype == one_shot.dtype == np.float32 and seg.shape == (4 * 8, 5, 3)
    assert np.array_equal(one_shot, seg)
    files = sorted(os.listdir(tmp_path))
    assert [f for f in files if f.startswith("lang_seg")] == [
        f"lang_seg{i:04d}.npy" for i in range(4)
    ]
    assert "lang_state.npz" in files
    cleanup(str(tmp_path), "lang")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("friction", [1.0, None])
def test_kill_between_segments_resumes_identically(tmp_path, friction):
    """A half-length run stands for a run killed after two segments; the
    full run, resumed in a fresh LangevinDiffusion against the same folder,
    gives the frames of one uninterrupted run. Overdamped dynamics (no
    velocity) checkpoints ``v`` as an empty placeholder."""
    kw = dict(friction=friction)
    reference = _ld(**kw).sample()
    segmented_sample(_ld(n_timesteps=200, **kw), str(tmp_path), "lang", segment_steps=100)
    state = np.load(tmp_path / "lang_state.npz")
    assert int(state["t"]) == 200 and state["key"].dtype == np.uint8
    assert (state["v"].ndim == 0) == (friction is None)
    resumed = segmented_sample(_ld(**kw), str(tmp_path), "lang", segment_steps=100,
                               resume=True)
    assert np.array_equal(reference, resumed)


def test_segment_steps_must_divide_into_saves(tmp_path):
    with pytest.raises(ValueError):
        segmented_sample(_ld(), str(tmp_path), "lang", segment_steps=75)
    # the default: about ten segments of whole save intervals
    out = segmented_sample(_ld(n_timesteps=1000), str(tmp_path), "lang")
    assert len([f for f in os.listdir(tmp_path) if f.startswith("lang_seg")]) == 10
    assert out.shape == (4 * 20, 5, 3)


def test_stage_wrapper_cached_contract(tmp_path):
    out = _segmented_langevin_stage(_ld(), str(tmp_path), "lang_t8_dt1_s400", resume=False,
                                    segment_steps=100)
    post = tmp_path / "post_lang_t8_dt1_s400.npy"
    assert post.exists()
    assert np.array_equal(np.load(post), out)
    assert sorted(os.listdir(tmp_path)) == [post.name]
    # The resume path loads the product without running the simulation.
    ld = _ld()
    again = _segmented_langevin_stage(ld, str(tmp_path), "lang_t8_dt1_s400", resume=True,
                                      segment_steps=100)
    assert np.array_equal(again, out) and ld.sim._t == 0
