"""Port's diffusion schedules and configuration object against the JAX ones."""

import numpy as np
import pytest

from twoforone_tpu.core import schedules as jsched
from twoforone_torch.core import schedules as tsched


@pytest.mark.parametrize("schedule,weights", [
    ("cosine", "ones"), ("cosine", "higheruntil_100"), ("linear", "score_matching"),
    ("cosine", "lower_bound_5"),
])
def test_buffers_equal_jax(schedule, weights):
    """Same float64 construction frozen to float32: bit-identical buffers."""
    ref = jsched.make_buffers(1000, schedule, weights)
    ours = tsched.make_buffers(1000, schedule, weights)
    assert ours._fields == ref._fields
    for name in ref._fields:
        r = np.asarray(getattr(ref, name))
        o = getattr(ours, name).numpy()
        assert o.dtype == np.float32
        np.testing.assert_array_equal(o, r, err_msg=name)


def test_gaussian_diffusion_config_and_force_scale_read():
    """The Langevin force scale reads sqrt(1 - alpha_bar_t) from the float32
    buffer; the Python float must be the same one JAX reads."""
    from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
    from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
    from twoforone_torch.core.diffusion import GaussianDiffusion
    from twoforone_torch.models.graph_transformer import GraphTransformer

    jgd = JGD(model=JGT(num_beads=10, hidden_nf=16, n_layers=1), num_atoms=10,
              norm_factor=3.11, loss_weights="higheruntil_100")
    gd = GaussianDiffusion(model=GraphTransformer(10, 16, 1), num_atoms=10,
                           norm_factor=3.11, loss_weights="higheruntil_100")
    assert gd.buffers.num_timesteps == 1000
    for t in (0, 20, 500, 999):
        assert float(gd.buffers.sqrt_one_minus_alphas_cumprod[t]) == float(
            jgd.buffers.sqrt_one_minus_alphas_cumprod[t]
        )
        assert float(gd.buffers.alphas_cumprod[t]) == float(jgd.buffers.alphas_cumprod[t])
