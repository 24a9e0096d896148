"""K-Means assignment and the streaming update, over the CUDA kernel.

:func:`assign` is the wrapper: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.kmeans.ref.assign_ref`), a CUDA tensor
launches ``kmeans_assign`` (``kernels/csrc/kmeans_assign.cu``) or raises.
There is no fallback between the two.

Both kernels are ``torch.library`` ops (``repro_torch::kmeans_assign``,
``repro_torch::kmeans_update``; ``kernels/_library.py``), so a dispatch
mode sees them: the dispatcher sends CUDA tensors to the launch
(:func:`assign_cuda`, :func:`update_cuda`, in the regime :func:`assign_plan`
or :func:`update_plan` chooses), CPU tensors to the plain version, fake
tensors to the shapes. Each has a FLOP formula, the counts of ``PERF.md``
§6's bounds (:func:`assign_flops`, :func:`update_flops`), and the update
its workspace's bytes, so a traced K-Means batch counts its cost
(``runtime/cost_analysis.py``, ``launch/dryrun.py``).

Kernel note — ``kmeans_assign`` replaces the Pallas TPU kernel
``repro/kernels/kmeans/kernel.py`` (``assign_pallas`` / ``_assign_kernel``).
Every regime computes the reference's f32 form |p|^2 - 2 p.c + |c|^2, the
first index winning ties. :func:`assign_plan` chooses one of four regimes
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
* ``generic`` (everything else that fits): the first port's
  one-thread-per-point kernel over centroid tiles in 48 KB of shared memory.
* ``chunked`` (a centroid row does not fit 48 KB: D >= 12 288 below wide's
  K = 16, e.g. 20 000 x 2): a warp per 4 points, its lanes striding over D,
  tiles of up to 16 centroids staged in chunks of D; each lane's running
  sums are added over the warp by a fixed butterfly. So every (D, K) the
  reference's ``assign`` takes has a regime.

:func:`update_scatter` is the update's wrapper: a CPU tensor takes
``index_add_`` (:func:`~repro_torch.kernels.kmeans.ref.update_scatter_ref`,
row order as the reference), a CUDA tensor launches ``kmeans_update``
(``kernels/csrc/kmeans_update.cu``), whose sums have a fixed order, so an
update repeats bit for bit; it replaces no TPU kernel. :func:`update_plan`
chooses one of its two regimes from (D, K, dtype):

* ``partials`` (K*D <= ``PARTIALS_MAX_KD``: the K-Means streams' 3 x 10).
  No sort: blocks of consecutive rows, each thread one (label, column)
  pair of one row group, Kahan sums added by compensated trees into a
  partial a block, then the partials in block order. Two launches.
* ``sorted`` (larger K*D: the wide stream's 128 x 1024). A counting sort of
  the labels (per-block histograms, a scan, a stable scatter), then sums
  over segments of the sorted rows and a merge of the runs that cross
  segments, in the first port's order. Five launches.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import CudaKernel, CudaLibrary
from repro_torch.kernels._library import define_op, fake_only
from repro_torch.kernels.kmeans.ref import assign_ref, update_scatter_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KMEANS_LIB = CudaLibrary("kmeans_assign.cu", {
    "kmeans_assign": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
})
KMEANS_ASSIGN = CudaKernel("kmeans_assign", KMEANS_LIB, "kmeans_assign")
KMEANS_UPDATE_LIB = CudaLibrary("kmeans_update.cu", {
    "kmeans_update": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
})
KMEANS_UPDATE = CudaKernel("kmeans_update", KMEANS_UPDATE_LIB, "kmeans_update")

#: input dtypes the kernel takes -> its dtype code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: regime -> its code at the C entry point
REGIME_CODE = {"generic": 0, "narrow": 1, "wide": 2, "chunked": 3}

# the regime thresholds, set by tools/tile_sweep.py assign (PERF.md): narrow
# beat generic and wide at every shape it takes; wide beat generic from
# K*D = 2048 with D >= 8 and K >= 16 (lost at 32 x 32, 4 x 1024)
NARROW_MAX_D, NARROW_MAX_CD = 16, 1024
WIDE_MIN_D, WIDE_MIN_K, WIDE_MIN_CD = 8, 16, 2048
# tile sizes, as kmeans_assign.cu is built by default
NARROW_THREADS, NARROW_POINTS_PER_THREAD, NARROW_K_SPLIT = 128, 4, 2
WIDE_THREADS, WIDE_POINTS, WIDE_CENTROIDS, WIDE_CHUNK_BYTES = 256, 128, 128, 128
GENERIC_THREADS, GENERIC_SMEM_BYTES = 256, 48 * 1024
CHUNKED_THREADS, CHUNKED_POINTS, CHUNKED_MAX_K = 256, 32, 16
# kmeans_update: threads per block; the partials regime up to K*D =
# PARTIALS_MAX_KD (its threads: one (label, column) pair each), each block
# at least PARTIALS_MIN_ROWS rows and at most PARTIALS_MAX_BLOCKS blocks
# (set by tools/tile_sweep.py update), staged PARTIALS_TILE_BYTES of labels
# and points at a time; the sorted regime's rows per thread and segment,
# and rows per counting-sort block (as built)
UPDATE_THREADS = 256
PARTIALS_MAX_KD, PARTIALS_MIN_ROWS, PARTIALS_MAX_BLOCKS = 256, 256, 256
PARTIALS_TILE_BYTES = 16 * 1024
UPDATE_ROWS_PER_THREAD, SORT_ROWS = 8, 2048
#: update regime -> its code at the C entry point
UPDATE_REGIME_CODE = {"partials": 0, "sorted": 1}
#: each update regime's kernels in launch order (``update_launch(stop_after=i)`` runs the first i)
UPDATE_LAUNCHES = {"partials": ("partial_sums", "merge_partials"),
                   "sorted": ("sort_count", "sort_columns", "sort_scatter", "segment_sums",
                              "merge_runs")}


@dataclass(frozen=True)
class AssignPlan:
    """How ``kmeans_assign`` runs one (D, K, dtype): its regime, the points
    a block takes at a time (``tile_n``), the centroids it stages at once
    (``tile_k``), its threads, the dimensions per staged chunk (``chunk_d``:
    wide 128 bytes of a row; chunked as many as a tile of ``tile_k``
    centroids fits in 48 KB, whole warps of lanes; otherwise all D), and,
    narrow, the consecutive
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
    if (d + 1) * 4 <= GENERIC_SMEM_BYTES:
        return AssignPlan("generic", GENERIC_THREADS, GENERIC_THREADS,
                          min(k, GENERIC_SMEM_BYTES // ((d + 1) * 4)), d)
    tile_k = min(k, CHUNKED_MAX_K)
    return AssignPlan("chunked", CHUNKED_THREADS, CHUNKED_POINTS, tile_k,
                      GENERIC_SMEM_BYTES // 4 // tile_k // 32 * 32)


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
                             REGIME_CODE[plan.regime], plan.tile_n, plan.tile_k, plan.chunk_d,
                             stream)
    return labels, dist


def assign(points: torch.Tensor, centroids: torch.Tensor):
    """K-Means assignment: (labels (N,) int32, dist2 (N,) f32), through the
    ``repro_torch::kmeans_assign`` op: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    if points.device != centroids.device:
        raise ValueError(f"points on {points.device}, centroids on {centroids.device}")
    return kmeans_assign_op(points, centroids)


@dataclass(frozen=True)
class UpdatePlan:
    """How ``kmeans_update`` runs one (D, K, dtype).

    ``partials``: a block takes :meth:`block_rows` consecutive rows (at
    least ``min_rows``, a multiple of 8, so that at most ``max_blocks``
    blocks cover N), staged ``tile_rows`` at a time; ``groups`` threads
    share each (label, column) pair, one a row group.
    ``sorted``: a block of segment sums takes ``cols`` column lanes (the
    least power of two >= D, at most 32) and ``UPDATE_THREADS / cols`` rows
    in flight, over segments of ``seg_rows`` sorted rows; the counting sort
    takes ``sort_rows`` rows a block. Every size is a function of (D, K,
    dtype) and N alone, and so is the order of every sum."""

    regime: str
    groups: int = 0
    tile_rows: int = 0
    min_rows: int = 0
    max_blocks: int = 0
    cols: int = 0
    seg_rows: int = 0
    sort_rows: int = 0

    def block_rows(self, n: int) -> int:
        """Rows a ``partials`` block takes for N rows."""
        return max(self.min_rows, (-(-n // self.max_blocks) + 7) // 8 * 8)

    def sizes(self, n: int) -> tuple[int, int, int]:
        """The entry point's three size arguments for N rows."""
        if self.regime == "partials":
            return self.block_rows(n), self.tile_rows, self.groups
        return self.seg_rows, self.cols, self.sort_rows


@functools.lru_cache(maxsize=None)
def update_plan(d: int, k: int, dtype: torch.dtype, regime: str | None = None) -> UpdatePlan:
    """The regime and sizes of ``kmeans_update`` for D dimensions, K labels
    and the points' dtype (f32 or bf16): ``partials`` up to K*D =
    ``PARTIALS_MAX_KD``, else ``sorted``; ``regime`` names one instead
    (``partials`` takes K*D <= ``UPDATE_THREADS`` alone)."""
    regime = regime or ("partials" if k * d <= PARTIALS_MAX_KD else "sorted")
    if regime == "partials":
        if k * d > UPDATE_THREADS:
            raise ValueError(f"the partials regime takes K*D <= {UPDATE_THREADS}, got {k * d}")
        elem = torch.empty((), dtype=dtype).element_size()
        tile_rows = max(8, PARTIALS_TILE_BYTES // (4 + d * elem) // 8 * 8)
        return UpdatePlan("partials", groups=UPDATE_THREADS // (k * d), tile_rows=tile_rows,
                          min_rows=PARTIALS_MIN_ROWS, max_blocks=PARTIALS_MAX_BLOCKS)
    if regime != "sorted":
        raise ValueError(f"no kmeans_update regime {regime!r}")
    cols = 1
    while cols < d and cols < 32:
        cols *= 2
    return UpdatePlan("sorted", cols=cols,
                      seg_rows=UPDATE_ROWS_PER_THREAD * (UPDATE_THREADS // cols),
                      sort_rows=SORT_ROWS)


def _workspace_sizes(plan: UpdatePlan, n: int, d: int, k: int) -> tuple[int, int]:
    """The int32 and f32 elements of :func:`update_workspace`."""
    if plan.regime == "partials":
        blocks = -(-n // plan.block_rows(n))
        ints, floats = blocks * k, 2 * blocks * k * d
    else:
        units = max(-(-n // plan.sort_rows), 1)
        spill = units * 8 * k if 8 * k * 4 > 48 * 1024 else 0
        ints, floats = k + 1 + n + 2 * units * k + k + spill, 2 * -(-n // plan.seg_rows) * d
    return max(ints, 1), max(floats, 1)


def update_workspace(plan: UpdatePlan, n: int, d: int, k: int, device) -> tuple:
    """The int32 and f32 workspace of ``kmeans_update`` for N rows.
    ``partials``: per-block counts (blocks x K) and sums and compensations
    (2 x blocks x K*D). ``sorted``: ``starts`` (K + 1) then ``order`` (N,
    the first ``starts[K]`` filled) then the counting sort's per-block
    counts, the counts of the blocks before each (2 x blocks x K), the
    labels' totals (K; and per-warp counts where 8 K ints pass 48 KB), and
    the segments' head and tail partials (2 x segments x D)."""
    ints, floats = _workspace_sizes(plan, n, d, k)
    return (torch.empty((ints,), dtype=torch.int32, device=device),
            torch.empty((floats,), dtype=torch.float32, device=device))


def update_launch(points: torch.Tensor, labels: torch.Tensor, k: int,
                  mask: torch.Tensor | None = None, *, plan: UpdatePlan | None = None,
                  work: tuple | None = None, stop_after: int = 0):
    """:func:`update_cuda` in the regime of ``plan`` (default
    :func:`update_plan`), into ``work`` (default a new
    :func:`update_workspace`); ``stop_after`` > 0 launches only the
    regime's first that many kernels (to time its phases). Returns (sums,
    counts)."""
    if points.device.type != "cuda" or labels.device != points.device or (
            mask is not None and mask.device != points.device):
        raise ValueError(f"kmeans_update needs its tensors on one CUDA device, got points on "
                         f"{points.device}, labels on {labels.device}")
    if points.dtype not in _DTYPE_CODE:
        raise TypeError(f"kmeans_update takes f32 or bf16 points, got {points.dtype}")
    if points.ndim != 2 or labels.shape != (points.shape[0],) or (
            mask is not None and mask.shape != labels.shape):
        raise ValueError(f"points {tuple(points.shape)}, labels {tuple(labels.shape)}: "
                         f"want (N, D) and (N,)")
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"kmeans_update takes a bool mask, got {mask.dtype}")
    if not points.is_contiguous():
        raise ValueError("kmeans_update takes contiguous points")
    n, d = points.shape
    plan = plan or update_plan(d, k, points.dtype)
    iwork, fwork = work or update_workspace(plan, n, d, k, points.device)
    labels = labels.to(torch.int32).contiguous()
    mask = None if mask is None else mask.contiguous()
    sums = torch.empty((k, d), dtype=torch.float32, device=points.device)
    counts = torch.empty((k,), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        KMEANS_UPDATE.launch(points.data_ptr(), labels.data_ptr(),
                             0 if mask is None else mask.data_ptr(), iwork.data_ptr(),
                             fwork.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, k, d,
                             _DTYPE_CODE[points.dtype], UPDATE_REGIME_CODE[plan.regime],
                             *plan.sizes(n), stop_after, stream)
    return sums, counts


def update_cuda(points: torch.Tensor, labels: torch.Tensor, k: int,
                mask: torch.Tensor | None = None):
    """Launch ``kmeans_update`` on CUDA tensors: points (N, D) f32 or bf16,
    contiguous; labels (N,) int; ``mask`` (N,) bool gives rows weight 0,
    and rows whose label lies outside [0, K) add nothing. In the regime
    :func:`update_plan` chooses. Returns (sums (K, D) f32, counts (K,) f32),
    bitwise the same on every call with the same inputs."""
    return update_launch(points, labels, k, mask)


def update_scatter(points: torch.Tensor, labels: torch.Tensor, k: int,
                   mask: torch.Tensor | None = None):
    """Centroid sums (K, D) f32 and counts (K,) f32 over the labels; ``mask``
    gives rows weight 0. Through the ``repro_torch::kmeans_update`` op:
    ``index_add_`` in row order for CPU tensors (the reference's order),
    the fixed-order CUDA kernel for CUDA tensors."""
    return kmeans_update_op(points, labels, int(k), mask)


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


# ---------------------------------------------------------------------------
# the torch.library ops (``kernels/_library.py``): CUDA -> the kernel, CPU ->
# the plain version, fake tensors -> the shapes
# ---------------------------------------------------------------------------


def assign_flops(n: int, d: int, k: int) -> int:
    """The assignment's operations (``PERF.md`` §6's bound): 2NKD for the
    products, 3NK to form and compare each d^2, 2ND for |p|^2."""
    return 2 * n * k * d + 3 * n * k + 2 * n * d


def update_flops(n: int, d: int) -> int:
    """The update's adds: D into the sums and one into the counts a row."""
    return n * (d + 1)


def _assign_cuda(points, centroids):
    return assign_cuda(points, centroids)


def _assign_cpu(points, centroids):
    return assign_ref(points, centroids)


def _assign_fake(points, centroids):
    fake_only("kmeans_assign", points, centroids)
    n = points.shape[0]
    return (points.new_empty((n,), dtype=torch.int32),
            points.new_empty((n,), dtype=torch.float32))


def _update_cuda(points, labels, k, mask):
    return update_cuda(points, labels, k, mask)


def _update_cpu(points, labels, k, mask):
    return update_scatter_ref(points, labels, k, mask)


def _update_fake(points, labels, k, mask):
    fake_only("kmeans_update", points, labels, *([] if mask is None else [mask]))
    return (points.new_empty((k, points.shape[1]), dtype=torch.float32),
            points.new_empty((k,), dtype=torch.float32))


def _update_workspace(points, labels, k, mask) -> int:
    n, d = points.shape
    ints, floats = _workspace_sizes(update_plan(d, k, points.dtype), n, d, k)
    return 4 * (ints + floats)


#: (labels (N,) int32, d^2 (N,) f32) of points (N, D) against centroids (K, D)
kmeans_assign_op = define_op(
    "kmeans_assign(Tensor points, Tensor centroids) -> (Tensor, Tensor)",
    _assign_cuda, _assign_cpu, _assign_fake)
#: (sums (K, D) f32, counts (K,) f32) of points (N, D) over labels (N,);
#: ``mask`` (N,) bool gives rows weight 0
kmeans_update_op = define_op(
    "kmeans_update(Tensor points, Tensor labels, int k, Tensor? mask) -> (Tensor, Tensor)",
    _update_cuda, _update_cpu, _update_fake, workspace=_update_workspace)


@register_flop_formula(torch.ops.repro_torch.kmeans_assign, get_raw=True)
def _assign_flop(points, centroids, *args, out_val=None, **kwargs) -> int:
    return assign_flops(points.shape[0], points.shape[1], centroids.shape[0])


@register_flop_formula(torch.ops.repro_torch.kmeans_update, get_raw=True)
def _update_flop(points, labels, k, mask, *args, out_val=None, **kwargs) -> int:
    return update_flops(points.shape[0], points.shape[1])
