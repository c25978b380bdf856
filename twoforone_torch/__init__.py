"""PyTorch/CUDA port of ``twoforone_tpu`` for NVIDIA Hopper GPUs.

Module names mirror the JAX package so each module's counterpart is easy to
find (``twoforone_torch/models/graph_transformer.py`` ports
``twoforone_tpu/models/graph_transformer.py``, and so on). The port imports
``torch`` and never JAX, flax or anything of ``twoforone_tpu``; the staged
weight files under ``twoforone_tpu/assets/trained/`` are read by path.

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when CUDA is absent; pass ``device="cpu"`` to run the plain PyTorch
paths on the host.
"""

__version__ = "0.1.0"

from twoforone_torch.core.diffusion import GaussianDiffusion  # noqa: F401
from twoforone_torch.models import get_model  # noqa: F401
