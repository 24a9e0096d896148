"""Hand-written Hopper (sm_90a) CUDA kernels for the compute hot spots, each
beside its plain PyTorch version:

* ``kmeans``    — MASA streaming K-Means assignment (paper Table 1)
* ``tomo``      — forward/back projectors for GridRec & ML-EM (paper §3.2.2)
* ``attention`` — prefill (flash) and decode attention of the LM serving path,
  and the flash backward of LM training

Each has ``ref.py`` (the plain version) and ``ops.py`` (the wrapper that
takes the plain version for CPU tensors and launches the kernel for CUDA
tensors); the CUDA sources live in ``csrc/`` and are built at first use by
``_build.py``. ``KERNELS`` lists them with their launch counts.
"""
# registers the kernels, in the order of the TPU kernel table
from repro_torch.kernels import kmeans, tomo  # noqa: F401,I001
from repro_torch.kernels import attention  # noqa: F401
from repro_torch.kernels._build import KERNELS, build_all, reset_launches

__all__ = ["KERNELS", "attention", "build_all", "kmeans", "reset_launches", "tomo"]
