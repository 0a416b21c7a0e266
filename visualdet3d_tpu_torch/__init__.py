"""visualdet3d_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of
``visualdet3d_tpu``.

The package mirrors the JAX package's sub-layout module for module, so each
counterpart is easy to find, but imports nothing of it: the JAX package is
the reference the port is tested against, not a dependency. Plain tensor
code is PyTorch; every Pallas kernel of the JAX package becomes a kernel
written by hand for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first
use and bound with ``ctypes`` (see ``ops/kernel_build.py``).

Entry points run on the card (``device='cuda'``) unless the caller passes
``device='cpu'``; without CUDA the default raises instead of quietly
running on the CPU.
"""

__version__ = '0.1.0'

from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.device import resolve_device
from visualdet3d_tpu_torch.registry import BACKBONE_DICT, DETECTOR_DICT

__all__ = ['EasyDict', 'resolve_device', 'BACKBONE_DICT', 'DETECTOR_DICT']
