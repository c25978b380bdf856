"""Training (port of ``twoforone_tpu/train``): the EMA of the weights and
the trainer. The JAX package's ``TrainState`` has no counterpart: the
port's :class:`Trainer` holds its modules, optimizer and step itself."""

from twoforone_torch.train.ema import EMAConfig, ema_update, init_ema  # noqa: F401
from twoforone_torch.train.trainer import Trainer  # noqa: F401
