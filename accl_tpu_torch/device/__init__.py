"""Device backends: where call descriptors are executed.

  GPUDevice  - virtual ranks on one CUDA device (or on the CPU when asked)
  EmuRank, EmuWorld - the native multi-rank emulator of native/src, over
               host memory (device/emu_device.py; not imported here)
  DCNDevice  - the multi-host backend over a two-tier (dcn, ici) world,
               in-process on one card or one OS process per host over
               torch.distributed (device/dcn_device.py; not imported here)
"""

from .base import CCLODevice, CCLOAddr  # noqa: F401
from .gpu_device import GPUDevice  # noqa: F401
