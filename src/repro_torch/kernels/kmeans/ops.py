"""K-Means assignment and the streaming update, over the CUDA kernel.

:func:`assign` is the wrapper: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.kmeans.ref.assign_ref`), a CUDA tensor
launches ``kmeans_assign`` (``kernels/csrc/kmeans_assign.cu``) or raises.
There is no fallback between the two.

Kernel note — ``kmeans_assign`` replaces the Pallas TPU kernel
``repro/kernels/kmeans/kernel.py`` (``assign_pallas`` / ``_assign_kernel``).
On the H100 the streaming path's shapes (D = 3, K = 10) are bound by device
memory: each point is read once and its label and distance written once.
One thread per point keeps the point in registers and scans centroids
staged in shared memory (tiled to 48 KB, so any K and D fit), in the
reference's f32 form |p|^2 - 2 p.c + |c|^2, first index winning ties.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, CudaLibrary
from repro_torch.kernels.kmeans.ref import assign_ref, update_scatter

_P, _I = ctypes.c_void_p, ctypes.c_int
KMEANS_LIB = CudaLibrary("kmeans_assign.cu", {
    "kmeans_assign": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
})
KMEANS_ASSIGN = CudaKernel("kmeans_assign", KMEANS_LIB, "kmeans_assign")

#: input dtypes the kernel takes -> its dtype code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def assign_cuda(points: torch.Tensor, centroids: torch.Tensor):
    """Launch ``kmeans_assign`` on CUDA tensors: points (N, D) and
    centroids (K, D), both f32 or both bf16, contiguous, on one device.
    Returns (labels (N,) int32, dist2 (N,) f32)."""
    if points.device.type != "cuda" or centroids.device != points.device:
        raise ValueError(f"kmeans_assign needs both tensors on one CUDA device, "
                         f"got {points.device} and {centroids.device}")
    if points.dtype not in _DTYPE_CODE or centroids.dtype != points.dtype:
        raise TypeError(f"kmeans_assign takes f32 or bf16 (both alike), "
                        f"got {points.dtype} and {centroids.dtype}")
    if points.ndim != 2 or centroids.ndim != 2 or points.shape[1] != centroids.shape[1]:
        raise ValueError(f"shapes {tuple(points.shape)} and {tuple(centroids.shape)}: "
                         f"want (N, D) and (K, D)")
    if not (points.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("kmeans_assign takes contiguous tensors")
    n, d = points.shape
    k = centroids.shape[0]
    labels = torch.empty((n,), dtype=torch.int32, device=points.device)
    dist = torch.empty((n,), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        KMEANS_ASSIGN.launch(points.data_ptr(), centroids.data_ptr(), labels.data_ptr(),
                             dist.data_ptr(), n, k, d, _DTYPE_CODE[points.dtype], stream)
    return labels, dist


def assign(points: torch.Tensor, centroids: torch.Tensor):
    """K-Means assignment: (labels (N,) int32, dist2 (N,) f32). The plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if points.device != centroids.device:
        raise ValueError(f"points on {points.device}, centroids on {centroids.device}")
    if points.device.type == "cpu":
        return assign_ref(points, centroids)
    if points.device.type == "cuda":
        return assign_cuda(points, centroids)
    raise ValueError(f"no K-Means assignment for device {points.device}")


def minibatch_update(points: torch.Tensor, centroids: torch.Tensor, *, decay: float = 0.9):
    """One streaming K-Means step: assign + decayed centroid update
    (paper §3.2.1 "averaging using a decay factor"). Returns
    (new centroids, labels, inertia)."""
    k = centroids.shape[0]
    labels, dist = assign(points, centroids)
    sums, counts = update_scatter(points, labels, k)
    batch_means = sums / torch.clamp_min(counts[:, None], 1.0)
    seen = (counts > 0)[:, None]
    new_centroids = torch.where(seen, decay * centroids + (1.0 - decay) * batch_means, centroids)
    return new_centroids.to(centroids.dtype), labels, dist.sum()


def minibatch_update_masked(points: torch.Tensor, centroids: torch.Tensor, n_valid: int,
                            *, decay: float = 0.9):
    """:func:`minibatch_update` over a batch whose rows ``>= n_valid`` are
    padding: they contribute nothing to the update or the inertia and get
    label ``-1``. The port's apps do not pad (PyTorch does not recompile
    per batch size); this form is kept for callers that stack
    fixed-size buffers."""
    k = centroids.shape[0]
    labels, dist = assign(points, centroids)
    mask = torch.arange(points.shape[0], device=points.device) < n_valid
    sums, counts = update_scatter(points, labels, k, mask=mask)
    batch_means = sums / torch.clamp_min(counts[:, None], 1.0)
    seen = (counts > 0)[:, None]
    new_centroids = torch.where(seen, decay * centroids + (1.0 - decay) * batch_means, centroids)
    inertia = torch.where(mask, dist, torch.zeros_like(dist)).sum()
    labels = torch.where(mask, labels, torch.full_like(labels, -1))
    return new_centroids.to(centroids.dtype), labels, inertia
