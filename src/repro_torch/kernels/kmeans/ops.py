"""K-Means assignment and the streaming update, over the CUDA kernel.

:func:`assign` is the wrapper: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.kmeans.ref.assign_ref`), a CUDA tensor
launches ``kmeans_assign`` (``kernels/csrc/kmeans_assign.cu``) or raises.
There is no fallback between the two.

Kernel note — ``kmeans_assign`` replaces the Pallas TPU kernel
``repro/kernels/kmeans/kernel.py`` (``assign_pallas`` / ``_assign_kernel``).
Every regime computes the reference's f32 form |p|^2 - 2 p.c + |c|^2, the
first index winning ties. :func:`assign_plan` chooses one of three regimes
from (D, K, dtype) and hands it, with its tile sizes, to the entry point:

* ``narrow`` (D <= 16, K*D <= 1024: the K-Means stream's 3 x 10). Bound by
  memory latency: a pair of lanes puts its 4 consecutive points in flight
  (16- or 8-byte loads into registers) before the block stages the
  centroids behind one barrier; each lane scans every other centroid, the
  pair merges by a shuffle and stores 16 bytes of labels and of distances;
  a grid of a few blocks per SM walks the points. The first port's
  arithmetic, bit for bit.
* ``wide`` (D >= 8, K >= 16, K*D >= 2048: 128 x 1024). Bound by
  operations: a fused distance GEMM + argmin on the tensor cores
  (``mma.sync``; bf16 in one pass, f32 as 3xTF32: hi/lo splits, three
  products, f32 accumulation), 128 points per block against centroid
  tiles of 128, the running (min, index) kept on the accumulator
  fragments.
* ``generic`` (everything else): the first port's one-thread-per-point
  kernel over centroid tiles in 48 KB of shared memory; it refuses a
  centroid that does not fit (D = 20 000).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels._build import CudaKernel, CudaLibrary
from repro_torch.kernels.kmeans.ref import assign_ref, update_scatter

_P, _I = ctypes.c_void_p, ctypes.c_int
KMEANS_LIB = CudaLibrary("kmeans_assign.cu", {
    "kmeans_assign": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
})
KMEANS_ASSIGN = CudaKernel("kmeans_assign", KMEANS_LIB, "kmeans_assign")

#: input dtypes the kernel takes -> its dtype code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: regime -> its code at the C entry point
REGIME_CODE = {"generic": 0, "narrow": 1, "wide": 2}

# the regime thresholds, set by tools/tile_sweep.py assign (PERF.md): narrow
# beat generic and wide at every shape it takes; wide beat generic from
# K*D = 2048 with D >= 8 and K >= 16 (lost at 32 x 32, 4 x 1024)
NARROW_MAX_D, NARROW_MAX_CD = 16, 1024
WIDE_MIN_D, WIDE_MIN_K, WIDE_MIN_CD = 8, 16, 2048
# tile sizes, as kmeans_assign.cu is built by default
NARROW_THREADS, NARROW_POINTS_PER_THREAD, NARROW_K_SPLIT = 128, 4, 2
WIDE_THREADS, WIDE_POINTS, WIDE_CENTROIDS, WIDE_CHUNK_BYTES = 256, 128, 128, 128
GENERIC_THREADS, GENERIC_SMEM_BYTES = 256, 48 * 1024


@dataclass(frozen=True)
class AssignPlan:
    """How ``kmeans_assign`` runs one (D, K, dtype): its regime, the points
    a block takes at a time (``tile_n``), the centroids it stages at once
    (``tile_k``; generic: 0 when not one centroid fits, which the kernel
    refuses), its threads, the dimensions per staged chunk (``chunk_d``:
    wide 128 bytes of a row; otherwise all D), and, narrow, the consecutive
    points a group of ``k_split`` lanes takes, each lane every
    ``k_split``-th centroid."""

    regime: str
    threads: int
    tile_n: int
    tile_k: int
    chunk_d: int
    points_per_thread: int = 1
    k_split: int = 1


def assign_plan(d: int, k: int, dtype: torch.dtype) -> AssignPlan:
    """The regime and tile sizes of ``kmeans_assign`` for D dimensions, K
    centroids and the inputs' dtype (f32 or bf16)."""
    if d <= NARROW_MAX_D and k * d <= NARROW_MAX_CD:
        return AssignPlan("narrow", NARROW_THREADS,
                          NARROW_THREADS // NARROW_K_SPLIT * NARROW_POINTS_PER_THREAD, k, d,
                          NARROW_POINTS_PER_THREAD, NARROW_K_SPLIT)
    if d >= WIDE_MIN_D and k >= WIDE_MIN_K and k * d >= WIDE_MIN_CD:
        elem = torch.empty((), dtype=dtype).element_size()
        return AssignPlan("wide", WIDE_THREADS, WIDE_POINTS, WIDE_CENTROIDS,
                          WIDE_CHUNK_BYTES // elem)
    return AssignPlan("generic", GENERIC_THREADS, GENERIC_THREADS,
                      min(k, GENERIC_SMEM_BYTES // ((d + 1) * 4)), d)


def assign_cuda(points: torch.Tensor, centroids: torch.Tensor, plan: AssignPlan | None = None):
    """Launch ``kmeans_assign`` on CUDA tensors: points (N, D) and
    centroids (K, D), both f32 or both bf16, contiguous, on one device, in
    the regime of ``plan`` (default :func:`assign_plan`; the entry point
    refuses a plan its build does not take). Returns (labels (N,) int32,
    dist2 (N,) f32)."""
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
    plan = plan or assign_plan(d, k, points.dtype)
    labels = torch.empty((n,), dtype=torch.int32, device=points.device)
    dist = torch.empty((n,), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        KMEANS_ASSIGN.launch(points.data_ptr(), centroids.data_ptr(), labels.data_ptr(),
                             dist.data_ptr(), n, k, d, _DTYPE_CODE[points.dtype],
                             REGIME_CODE[plan.regime], plan.tile_n, plan.tile_k, stream)
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
