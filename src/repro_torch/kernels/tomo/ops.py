"""Reconstruction ops: GridRec + ML-EM over the tomography CUDA kernels.

:func:`backproject_batch` and :func:`project_batch` are the wrappers: CPU
tensors take the plain versions (``ref.py``), CUDA tensors launch
``tomo_backproject`` / ``tomo_project`` (``kernels/csrc/tomo.cu``) or
raise. There is no fallback between the two. Both kernels are
``torch.library`` ops (``repro_torch::tomo_backproject``,
``repro_torch::tomo_project``; ``kernels/_library.py``): the dispatcher
sends CUDA tensors to the launch, CPU tensors to the plain version and fake
tensors to the shapes; each has a FLOP formula, the count of ``PERF.md``
§6's bound (:func:`projector_flops`), and the projection its scratch's
bytes, so a traced GridRec or ML-EM batch counts its cost
(``runtime/cost_analysis.py``, ``launch/dryrun.py``). The batch axis is a grid
dimension of the kernels (in chunks of 8 frames), so the single-frame
forms are a batch of one.
GridRec's ramp filter stays a library FFT (``torch.fft``), as the JAX
package leaves it to XLA.

Kernel note — ``tomo_backproject`` replaces the Pallas TPU kernel
``repro/kernels/tomo/kernel.py`` (``backproject_pallas`` / ``_bp_kernel``)
and ``tomo_project`` replaces ``project_pallas`` / ``_fp_kernel``. The TPU
kernels' one-hot weight matmul is not carried over: both gather, with no
atomics, so the sum order is fixed, and both take s, floor(s) and f from
one device function, so they stay exact adjoints (ML-EM depends on it).

* ``tomo_backproject``: one thread per pixel carries 8 frames and computes
  the geometry once per (pixel, angle) for all of them; a block of 32 x 16
  pixels stages, per chunk of 16 angles, only the window of bins its tile
  can reach (39 bins, zero-filled outside the detector, so no range
  tests) for all its frames into shared memory by double-buffered
  ``cp.async``, and each pixel reads its two bins from there, 4 frames per
  16-byte load. Bound by those shared-memory loads and the per-(pixel,
  angle) geometry, not by device memory.
* ``tomo_project``: one thread per (angle, bin) carries up to 8 frames,
  walks the image line by line and gathers the few pixels of each line
  whose footprint reaches its bin; the geometry is computed once per
  candidate pixel for all frames. Angles that walk columns read a
  transposed copy of the images, made at the start of each call into
  scratch that :func:`project_cuda` allocates, so every gather coalesces.
  Bound by issuing the gathers (a load and a fused multiply-add per kept
  pixel and frame); the candidate tests are under a tenth of its time.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import CudaKernel, CudaLibrary
from repro_torch.kernels._library import define_op, fake_only
from repro_torch.kernels.tomo.ref import (
    backproject_plain,
    project_plain,
    ramp_filter,
    trig,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
TOMO_LIB = CudaLibrary("tomo.cu", {
    "tomo_backproject": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tomo_project": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
})
TOMO_BACKPROJECT = CudaKernel("tomo_backproject", TOMO_LIB, "tomo_backproject")
TOMO_PROJECT = CudaKernel("tomo_project", TOMO_LIB, "tomo_project")


def _check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} needs every tensor on one CUDA device, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes f32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def backproject_cuda(sinos: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Launch ``tomo_backproject``: sinograms (B, A, n_det) f32 -> images
    (B, n, n) f32, on precomputed cos/sin (A,)."""
    _check_cuda_f32("tomo_backproject", sinos, cos_t, sin_t)
    if sinos.ndim != 3 or cos_t.shape != (sinos.shape[1],) or sin_t.shape != cos_t.shape:
        raise ValueError(f"sinos {tuple(sinos.shape)}, cos {tuple(cos_t.shape)}: "
                         f"want (B, A, n_det) and (A,)")
    b, a, n_det = sinos.shape
    out = torch.empty((b, n, n), dtype=torch.float32, device=sinos.device)
    with torch.cuda.device(sinos.device):
        stream = torch.cuda.current_stream(sinos.device).cuda_stream
        TOMO_BACKPROJECT.launch(sinos.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
                                out.data_ptr(), b, a, n_det, n, stream)
    return out


def project_cuda(imgs: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor,
                 n_det: int) -> torch.Tensor:
    """Launch ``tomo_project``: images (B, n, n) f32 -> sinograms
    (B, A, n_det) f32, on precomputed cos/sin (A,). The kernel writes a
    transposed copy of the images into a (B, n, n) scratch tensor first."""
    _check_cuda_f32("tomo_project", imgs, cos_t, sin_t)
    if imgs.ndim != 3 or imgs.shape[1] != imgs.shape[2] or cos_t.ndim != 1 \
            or sin_t.shape != cos_t.shape:
        raise ValueError(f"imgs {tuple(imgs.shape)}, cos {tuple(cos_t.shape)}: "
                         f"want (B, n, n) and (A,)")
    b, n = imgs.shape[0], imgs.shape[-1]
    a = cos_t.shape[0]
    out = torch.empty((b, a, n_det), dtype=torch.float32, device=imgs.device)
    scratch = torch.empty_like(imgs)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        TOMO_PROJECT.launch(imgs.data_ptr(), scratch.data_ptr(), cos_t.data_ptr(),
                            sin_t.data_ptr(), out.data_ptr(), b, a, n_det, n, stream)
    return out


def projector_flops(b: int, a: int, n: int) -> int:
    """Either projector's operations (``PERF.md`` §6's bound) for B frames,
    A angles and an n x n image: 4 a (frame, pixel, angle) for the
    interpolation, 6 a (pixel, angle) for s, floor(s) and the two weights."""
    return 4 * b * n * n * a + 6 * n * n * a


def _backproject_cuda(sinos, cos_t, sin_t, n):
    return backproject_cuda(sinos, cos_t, sin_t, n)


def _backproject_cpu(sinos, cos_t, sin_t, n):
    return backproject_plain(sinos, cos_t, sin_t, n)


def _backproject_fake(sinos, cos_t, sin_t, n):
    fake_only("tomo_backproject", sinos, cos_t, sin_t)
    return sinos.new_empty((sinos.shape[0], n, n), dtype=torch.float32)


def _project_cuda(imgs, cos_t, sin_t, n_det):
    return project_cuda(imgs, cos_t, sin_t, n_det)


def _project_cpu(imgs, cos_t, sin_t, n_det):
    return project_plain(imgs, cos_t, sin_t, n_det)


def _project_fake(imgs, cos_t, sin_t, n_det):
    fake_only("tomo_project", imgs, cos_t, sin_t)
    return imgs.new_empty((imgs.shape[0], cos_t.shape[0], n_det), dtype=torch.float32)


def _project_workspace(imgs, cos_t, sin_t, n_det) -> int:
    return imgs.numel() * imgs.element_size()  # the transposed copy of the images


#: images (B, n, n) f32 of sinograms (B, A, n_det), on cos/sin (A,)
tomo_backproject_op = define_op(
    "tomo_backproject(Tensor sinos, Tensor cos_t, Tensor sin_t, int n) -> Tensor",
    _backproject_cuda, _backproject_cpu, _backproject_fake)
#: sinograms (B, A, n_det) f32 of images (B, n, n), on cos/sin (A,)
tomo_project_op = define_op(
    "tomo_project(Tensor imgs, Tensor cos_t, Tensor sin_t, int n_det) -> Tensor",
    _project_cuda, _project_cpu, _project_fake, workspace=_project_workspace)


@register_flop_formula(torch.ops.repro_torch.tomo_backproject, get_raw=True)
def _backproject_flop(sinos, cos_t, sin_t, n, *args, out_val=None, **kwargs) -> int:
    return projector_flops(sinos.shape[0], cos_t.shape[0], n)


@register_flop_formula(torch.ops.repro_torch.tomo_project, get_raw=True)
def _project_flop(imgs, cos_t, sin_t, n_det, *args, out_val=None, **kwargs) -> int:
    return projector_flops(imgs.shape[0], cos_t.shape[0], imgs.shape[-1])


def backproject_batch(sinos: torch.Tensor, angles: torch.Tensor, n: int) -> torch.Tensor:
    """sinograms (B, A, n_det) -> images (B, n, n), through the
    ``repro_torch::tomo_backproject`` op: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    cos_t, sin_t = trig(angles.to(sinos.device))
    return tomo_backproject_op(sinos, cos_t, sin_t, int(n))


def project_batch(imgs: torch.Tensor, angles: torch.Tensor, n_det: int) -> torch.Tensor:
    """images (B, n, n) -> sinograms (B, A, n_det), through the
    ``repro_torch::tomo_project`` op: the plain version for CPU tensors,
    the kernel for CUDA tensors."""
    cos_t, sin_t = trig(angles.to(imgs.device))
    return tomo_project_op(imgs, cos_t, sin_t, int(n_det))


def backproject(sino: torch.Tensor, angles: torch.Tensor, n: int) -> torch.Tensor:
    """sinogram (A, n_det) -> image (n, n)."""
    return backproject_batch(sino[None], angles, n)[0]


def project(img: torch.Tensor, angles: torch.Tensor, n_det: int) -> torch.Tensor:
    """image (n, n) -> sinogram (A, n_det)."""
    return project_batch(img[None], angles, n_det)[0]


def gridrec_batch(sinos: torch.Tensor, angles: torch.Tensor, n: int, *,
                  window: str = "ramlak") -> torch.Tensor:
    """FFT filtered backprojection (the paper's fast reconstruction) of a
    (B, A, n_det) sinogram micro-batch."""
    filtered = ramp_filter(sinos, window=window)  # filters along axis -1
    return backproject_batch(filtered, angles, n) * (math.pi / (2.0 * angles.shape[0]))


def mlem_batch(sinos: torch.Tensor, angles: torch.Tensor, n: int, *,
               iters: int = 8) -> torch.Tensor:
    """Iterative ML-EM (the paper's high-fidelity reconstruction) of a
    (B, A, n_det) sinogram micro-batch: ``iters`` projections and
    ``iters + 1`` backprojections."""
    b, _, n_det = sinos.shape
    eps = 1e-6
    sinos = sinos.to(torch.float32)
    norm = backproject_batch(torch.ones_like(sinos), angles, n) + eps  # A^T 1
    x = torch.ones((b, n, n), dtype=torch.float32, device=sinos.device)
    for _ in range(iters):
        fp = project_batch(x, angles, n_det)
        ratio = sinos / torch.clamp_min(fp, eps)
        x = x * backproject_batch(ratio, angles, n) / norm
    return x


def gridrec(sino: torch.Tensor, angles: torch.Tensor, n: int, *,
            window: str = "ramlak") -> torch.Tensor:
    """GridRec of one (A, n_det) sinogram."""
    return gridrec_batch(sino[None], angles, n, window=window)[0]


def mlem(sino: torch.Tensor, angles: torch.Tensor, n: int, *, iters: int = 8) -> torch.Tensor:
    """ML-EM of one (A, n_det) sinogram."""
    return mlem_batch(sino[None], angles, n, iters=iters)[0]


def shepp_logan(n: int) -> torch.Tensor:
    """Tiny synthetic phantom (sum of ellipses) for tests and sources, on
    the CPU."""
    y, x = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    cx = cy = (n - 1) / 2.0
    xn, yn = (x - cx) / (n / 2), (y - cy) / (n / 2)
    img = torch.zeros((n, n), dtype=torch.float32)
    for (a, b, x0, y0, val) in [
        (0.69, 0.92, 0.0, 0.0, 1.0),
        (0.66, 0.87, 0.0, -0.02, -0.8),
        (0.11, 0.31, 0.22, 0.0, -0.2),
        (0.16, 0.41, -0.22, 0.0, -0.2),
        (0.21, 0.25, 0.0, 0.35, 0.1),
        (0.046, 0.046, 0.0, 0.1, 0.1),
    ]:
        mask = ((xn - x0) / a) ** 2 + ((yn - y0) / b) ** 2 <= 1.0
        img = img + val * mask
    return torch.clamp_min(img, 0.0)


def angle_grid(n_angles: int) -> np.ndarray:
    """``n_angles`` angles evenly over [0, pi), f32 (computed in f64)."""
    return np.linspace(0.0, np.pi, n_angles, endpoint=False).astype(np.float32)
