from twoforone_torch.core.schedules import (  # noqa: F401
    cosine_beta_schedule,
    linear_beta_schedule,
    DiffusionBuffers,
    make_buffers,
    make_loss_weights,
)
from twoforone_torch.core.diffusion import GaussianDiffusion  # noqa: F401
