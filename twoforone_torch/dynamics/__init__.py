from twoforone_torch.dynamics.integrators import (  # noqa: F401
    LangevinSimulation,
    baoab_step,
    overdamped_step,
)
from twoforone_torch.dynamics.langevin import (  # noqa: F401
    LangevinDiffusion,
    make_diffusion_force_fn,
)
