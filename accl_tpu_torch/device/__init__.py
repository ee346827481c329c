"""Device backends: where call descriptors are executed.

  GPUDevice  - virtual ranks on one CUDA device (or on the CPU when asked)
"""

from .base import CCLODevice, CCLOAddr  # noqa: F401
from .gpu_device import GPUDevice  # noqa: F401
