"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the edge cases the smoke run's main-path shapes do not reach: tiny and
odd sizes, each regime of ``kmeans_assign`` at its thresholds and tails
(blocks of points, chunks of dimensions, tiles of centroids), unaligned
views, ties and the generic D > 128 path and centroid tiling, angles at exactly 0, 45 and 90 degrees and beyond pi,
non-square detector/image sizes, side streams, and the error paths.

Marked ``cuda``: a CUDA kernel has no CPU mode, so without a card every test
here skips (the ``dev`` fixture decides, at run time). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import kmeans as K
from repro_torch.kernels.kmeans import ops as K_ops
from repro_torch.kernels import tomo as T
from repro_torch.miniapps import ReconstructionApp, StreamingKMeans

pytestmark = pytest.mark.cuda

F32_EPS = 2.0 ** -23


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda", 0)


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _check_assign(p, c, plan=None):
    labels, dist = K.assign_cuda(p, c, plan)
    ref_labels, ref_dist = K.assign_ref(p, c)
    torch.cuda.synchronize()
    pf, cf = p.float(), c.float()
    d = p.shape[1]
    # f32 rounding of |p|^2 - 2 p.c + |c|^2 over D terms in two orders
    tol = 8 * (d + 2) * 2.0 ** -24 * (pf.norm(dim=1) + cf.norm(dim=1).max()) ** 2
    assert labels.dtype == torch.int32 and dist.dtype == torch.float32
    assert bool(((dist - ref_dist).abs() <= tol).all())
    d2 = (pf * pf).sum(1, keepdim=True) - 2 * pf @ cf.T + (cf * cf).sum(1)
    if c.shape[0] > 1:
        two = d2.topk(2, dim=1, largest=False).values
        clear = two[:, 1] - two[:, 0] > 2 * tol
        assert not bool(((labels != ref_labels) & clear).any())
    else:
        assert bool((labels == 0).all())
    return labels


@pytest.mark.parametrize("n,d,k", [
    (1, 1, 1), (255, 3, 10), (257, 5, 7), (1000, 17, 33), (2048, 128, 97),
    (513, 129, 40), (300, 300, 5), (4096, 64, 2000),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_assign_matches_plain(dev, n, d, k, dtype):
    """Register widths up to 128, the generic path above it, and several
    tiles of centroids (4096 x 64 x 2000: 16 wide tiles)."""
    g = _gen(dev, n + d + k)
    p = torch.randn((n, d), generator=g, device=dev).to(dtype)
    c = torch.randn((k, d), generator=g, device=dev).to(dtype)
    _check_assign(p, c)


def test_kmeans_assign_first_index_wins_ties(dev):
    g = _gen(dev, 1)
    c = torch.randn((8, 3), generator=g, device=dev)
    c[5] = c[1]  # an exact duplicate can never win over its first copy
    p = torch.randn((5000, 3), generator=g, device=dev)
    labels = _check_assign(p, c)
    assert not bool((labels == 5).any())
    assert bool((labels == K.assign_ref(p, c)[0]).all())


def test_kmeans_assign_counts_launches_and_uses_the_current_stream(dev):
    g = _gen(dev, 2)
    p = torch.randn((10_000, 3), generator=g, device=dev)
    c = torch.randn((10, 3), generator=g, device=dev)
    before = K.KMEANS_ASSIGN.launches
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        labels, dist = K.assign(p, c)
    side.synchronize()
    assert K.KMEANS_ASSIGN.launches == before + 1
    ref_labels, ref_dist = K.assign_ref(p, c)
    assert bool((labels == ref_labels).all())
    torch.testing.assert_close(dist, ref_dist, rtol=0, atol=1e-3)


def test_kmeans_assign_rejects_what_it_cannot_take(dev):
    p, c = torch.zeros((4, 3), device=dev), torch.zeros((2, 3), device=dev)
    with pytest.raises(TypeError):
        K.assign(p.double(), c.double())
    with pytest.raises(TypeError):
        K.assign(p.bfloat16(), c)
    with pytest.raises(ValueError):
        K.assign(torch.zeros((3, 4), device=dev).T, c)
    with pytest.raises(ValueError):
        K.assign(p, torch.zeros((2, 4), device=dev))
    # 20 000 dims: no centroid fits 48 KB, so the chunked regime computes it
    g = _gen(dev, 12)
    labels = _check_assign(torch.randn((4, 20_000), generator=g, device=dev),
                           torch.randn((2, 20_000), generator=g, device=dev))
    assert labels.shape == (4,)


# (n, d, k): each regime at its thresholds and tails
REGIME_CASES = {
    "narrow": [(1, 3, 10), (511, 3, 10), (512, 3, 10), (513, 3, 10), (80_000, 3, 10),
               (600_007, 3, 10), (1000, 4, 16), (1000, 4, 17), (999, 2, 1), (1000, 1, 1024),
               (1000, 16, 64), (777, 5, 7), (300, 8, 1)],
    "wide": [(127, 128, 1024), (128, 128, 1024), (129, 128, 1024), (1000, 32, 64), (1000, 36, 100),
             (1000, 100, 130), (700, 33, 64), (700, 129, 257), (300, 520, 64), (1000, 8, 256),
             (1000, 128, 16)],
    "generic": [(300, 300, 5), (1000, 17, 33), (1000, 31, 64), (1000, 32, 63), (500, 16, 65),
                (1000, 8, 255), (1000, 7, 512), (1000, 128, 15), (1000, 4, 1024),
                (97, 12_287, 2)],
    "chunked": [(4096, 20_000, 2), (4096, 20_000, 15), (33, 12_288, 1), (31, 12_289, 3),
                (100, 30_001, 7)],
}


@pytest.mark.parametrize("regime,n,d,k", [(r, *c) for r, cases in REGIME_CASES.items()
                                          for c in cases])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_assign_regimes_at_their_edges(dev, regime, n, d, k, dtype):
    """N below, at and just above a block (narrow 512 points, wide 128),
    past the narrow grid's stride; K = 16 and 17 at D = 4, where the narrow
    centroids leave registers for shared memory; D not a multiple of a chunk or of 16
    bytes (36 and 33: plain loads instead of cp.async for some dtypes); K
    not a multiple of the 128-centroid tile; D = 8, K = 16 and K*D = 2048
    at the wide thresholds and just below them, K*D = 1024 at the narrow
    limit; one centroid row of 48 KB, the generic limit, and past it the
    chunked regime (D = 20 000 with K = 2 and 15; N not a multiple of a
    block's 32 points; D not a multiple of a chunk or of a warp's 32
    lanes)."""
    assert K.assign_plan(d, k, dtype).regime == regime
    g = _gen(dev, n * 7 + d * 3 + k)
    _check_assign(torch.randn((n, d), generator=g, device=dev).to(dtype),
                  torch.randn((k, d), generator=g, device=dev).to(dtype))


@pytest.mark.parametrize("n,d,k", [(65_536, 128, 1024), (80_000, 3, 10), (4096, 16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_assign_large_norm_clusters(dev, n, d, k, dtype):
    """The cluster source's data at large norms: centres in [-1000, 1000],
    spread 5, centroids at the centres, where |p|^2 and -2 p.c nearly
    cancel."""
    g = _gen(dev, 11 + d)
    centres = torch.rand((k, d), generator=g, device=dev) * 2000 - 1000
    idx = torch.randint(0, k, (n,), generator=g, device=dev)
    p = centres[idx] + 5 * torch.randn((n, d), generator=g, device=dev)
    _check_assign(p.to(dtype), centres.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime,d,k", [("narrow", 3, 10), ("narrow", 4, 10), ("wide", 128, 256)])
@pytest.mark.parametrize("offset_bytes", [4, 8])
def test_kmeans_assign_takes_unaligned_views(dev, dtype, regime, d, k, offset_bytes):
    """A contiguous view 4 or 8 bytes into its storage: its base is not 16
    bytes aligned, so the points are loaded by narrower or plain loads (bf16
    at D = 3 and an 8-byte offset: 8-byte loads)."""
    g = _gen(dev, 3)
    n = 5000
    skip = offset_bytes // torch.empty((), dtype=dtype).element_size()
    buf = torch.randn((n * d + skip,), generator=g, device=dev).to(dtype)
    p = buf[skip:].view(n, d)
    assert p.is_contiguous() and p.data_ptr() % 16 == offset_bytes
    assert K.assign_plan(d, k, dtype).regime == regime
    _check_assign(p, torch.randn((k, d), generator=g, device=dev).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_assign_wide_first_index_wins_ties(dev, dtype):
    """An exact duplicate in another centroid tile, another warp and another
    lane of the fragment: its d^2 equals its first copy's bit for bit, and
    the merges (lanes, warps) keep the first index."""
    g = _gen(dev, 4)
    c = torch.randn((1024, 128), generator=g, device=dev).to(dtype)
    c[700] = c[3]
    p = torch.randn((4096, 128), generator=g, device=dev)
    p[::64] = c[3].float() + 0.1 * torch.randn((64, 128), generator=g, device=dev)  # both nearest
    labels = _check_assign(p.to(dtype), c)
    assert not bool((labels == 700).any())
    assert bool((labels == 3).any())


def test_kmeans_assign_wide_f32_is_three_pass(dev):
    """Coordinates 0.45 of a TF32 step above TF32 values: one-pass TF32
    rounds every product the same way and breaks the tolerance 2.5-fold
    (tests/test_torch_kmeans.py emulates it); 3xTF32 stays far inside."""
    g = _gen(dev, 6)
    grid = torch.rand((256, 128), generator=g, device=dev) + 1
    grid = ((grid.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    c = grid * (1 + 0.45 * 2.0 ** -10)
    p = c[torch.randint(0, 256, (512,), generator=g, device=dev)].contiguous()
    labels, dist = K.assign_cuda(p, c)
    ref_labels, ref_dist = K.assign_ref(p, c)
    tol = 8 * 130 * 2.0 ** -24 * (p.norm(dim=1) + c.norm(dim=1).max()) ** 2
    assert float(((dist - ref_dist).abs() / tol).max()) < 0.1
    assert bool((labels == ref_labels).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k", [(3000, 8, 100), (1000, 3, 10), (2000, 16, 64)])
def test_kmeans_assign_every_regime_agrees(dev, dtype, n, d, k):
    """One input forced through each regime the entry point takes for it
    (the sweep times them so): each holds the plain version's rule."""
    g = _gen(dev, 8)
    p = torch.randn((n, d), generator=g, device=dev).to(dtype)
    c = torch.randn((k, d), generator=g, device=dev).to(dtype)
    plans = [K.AssignPlan("narrow", K_ops.NARROW_THREADS,
                          K_ops.NARROW_THREADS // K_ops.NARROW_K_SPLIT * K_ops.NARROW_POINTS_PER_THREAD,
                          k, d, K_ops.NARROW_POINTS_PER_THREAD, K_ops.NARROW_K_SPLIT),
             K.AssignPlan("wide", K_ops.WIDE_THREADS, K_ops.WIDE_POINTS, K_ops.WIDE_CENTROIDS,
                          K_ops.WIDE_CHUNK_BYTES // p.element_size()),
             K.AssignPlan("generic", K_ops.GENERIC_THREADS, K_ops.GENERIC_THREADS, min(k, 100), d),
             # chunked, forced: tiles of 16 centroids over K, three chunks over D
             K.AssignPlan("chunked", K_ops.CHUNKED_THREADS, K_ops.CHUNKED_POINTS,
                          min(k, K_ops.CHUNKED_MAX_K), max(1, d // 2 - 1))]
    for plan in plans:
        _check_assign(p, c, plan)


def test_kmeans_assign_refuses_a_plan_its_build_does_not_take(dev):
    """Tiles other than the build's, a narrow tile that is not all of K, or
    K*D past the narrow stage: refused by the entry point, nothing runs."""
    p, c = torch.zeros((4, 3), device=dev), torch.zeros((2, 3), device=dev)
    before = K.KMEANS_ASSIGN.launches
    good = K.assign_plan(3, 2, torch.float32)
    for bad in (K.AssignPlan("wide", 256, 64, 128, 32),
                K.AssignPlan("narrow", 128, good.tile_n, 3, 3, 4, good.k_split),
                K.AssignPlan("narrow", 128, good.tile_n // 2, 2, 3, 4, good.k_split),
                K.AssignPlan("generic", 256, 256, 3, 3),
                K.AssignPlan("chunked", 256, 32, 2, 4),       # a chunk wider than D
                K.AssignPlan("chunked", 256, 64, 2, 2)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            K.assign_cuda(p, c, bad)
    wide_d = torch.zeros((4, 1100), device=dev), torch.zeros((2, 1100), device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        K.assign_cuda(*wide_d, K.AssignPlan("narrow", 128, good.tile_n, 2, 1100, 4, good.k_split))
    assert K.KMEANS_ASSIGN.launches == before
    K.assign_cuda(p, c)
    assert K.KMEANS_ASSIGN.launches == before + 1


def _update_checked(p, labels, k, mask=None):
    """``kmeans_update`` against a float64 sum: each entry within 2^-20 of
    the sum of |x| over its rows, the counts exact; three calls bitwise
    equal."""
    sums, counts = K.update_cuda(p, labels, k, mask)
    again = [K.update_cuda(p, labels, k, mask) for _ in range(2)]
    w = torch.ones(p.shape[0], dtype=torch.float64, device=p.device) if mask is None \
        else mask.double()
    idx = torch.where(w > 0, labels.long(), 0)
    x = p.double() * w[:, None]
    ref = torch.zeros((k, p.shape[1]), dtype=torch.float64, device=p.device).index_add_(0, idx, x)
    mag = torch.zeros_like(ref).index_add_(0, idx, x.abs())
    ref_counts = torch.zeros(k, dtype=torch.float64, device=p.device).index_add_(0, idx, w)
    torch.cuda.synchronize()
    assert all(torch.equal(sums, a) and torch.equal(counts, b) for a, b in again)
    assert bool(((sums.double() - ref).abs() <= 2.0 ** -20 * mag).all())
    assert torch.equal(counts.double(), ref_counts)
    return sums, counts


@pytest.mark.parametrize("n,d,k", [(65_536, 128, 1024), (80_000, 3, 10), (1, 1, 1), (1000, 33, 7),
                                   (777, 20_000, 2), (5000, 64, 3000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_update_is_fixed_order_and_close_to_f64(dev, n, d, k, dtype):
    """The wide and narrow streams' shapes, D not a power of two, D = 20 000,
    and more labels than rows (empty runs write zeros)."""
    g = _gen(dev, n + d + k)
    p = (torch.randn((n, d), generator=g, device=dev) * 10 + 3).to(dtype)
    labels = torch.randint(0, k, (n,), generator=g, device=dev, dtype=torch.int32)
    before = K.KMEANS_UPDATE.launches
    _update_checked(p, labels, k)
    assert K.KMEANS_UPDATE.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_update_all_rows_on_one_label(dev, dtype):
    """The worst case for one block: 65 536 rows of 128 on one of 1024
    labels, every value positive (the sums grow without cancelling)."""
    g = _gen(dev, 21)
    p = (torch.rand((65_536, 128), generator=g, device=dev) * 20 + 1).to(dtype)
    labels = torch.full((65_536,), 517, dtype=torch.int32, device=dev)
    sums, counts = _update_checked(p, labels, 1024)
    assert float(counts[517]) == 65_536 and float(counts.sum()) == 65_536


@pytest.mark.parametrize("n,d,k,labelling", [
    (80_000, 3, 10, "one"), (80_000, 3, 10, "skewed"), (512, 3, 2, "one"), (513, 3, 2, "one"),
    (1024, 3, 2, "halves"), (100_000, 1, 3, "skewed"), (65_536, 128, 1024, "skewed"),
    (3000, 40, 5, "sorted")])
def test_kmeans_update_runs_across_segments(dev, n, d, k, labelling):
    """Runs that cross the kernel's row segments: every row on one label,
    nine in ten rows on one label, runs ending exactly on a segment's edge
    (512 sorted rows per segment at D = 3) or one row past it, D = 1 (the
    tallest tree), and labels already in order."""
    g = _gen(dev, n + d + k + 1)
    p = torch.randn((n, d), generator=g, device=dev) * 10 + 3
    if labelling == "one":
        labels = torch.full((n,), k - 1, dtype=torch.int32, device=dev)
    elif labelling == "skewed":
        labels = torch.randint(0, k, (n,), generator=g, device=dev, dtype=torch.int32)
        labels[torch.rand(n, generator=g, device=dev) < 0.9] = k // 2
    elif labelling == "halves":
        labels = (torch.arange(n, device=dev) >= n // 2).to(torch.int32)
    else:
        labels = torch.sort(torch.randint(0, k, (n,), generator=g, device=dev,
                                          dtype=torch.int32)).values
    _update_checked(p, labels, k)
    mask = torch.rand(n, generator=g, device=dev) < 0.5
    _update_checked(p, labels, k, mask)


def test_kmeans_update_masked_rows_weigh_nothing(dev):
    """``mask=``: rows weighted 0 (their labels set to 0 first, as the
    reference does); the counts are the masked sums of ones."""
    g = _gen(dev, 22)
    p = torch.randn((65_536, 128), generator=g, device=dev)
    labels = torch.randint(0, 1024, (65_536,), generator=g, device=dev, dtype=torch.int32)
    mask = torch.rand(65_536, generator=g, device=dev) < 0.7
    _update_checked(p, labels, 1024, mask)
    _update_checked(p, labels, 1024, torch.arange(65_536, device=dev) < 40_000)
    one = torch.zeros_like(labels)
    _update_checked(p, one, 1024, mask)


def test_kmeans_update_wrapper_routes_and_refuses(dev):
    """``update_scatter`` launches the kernel for CUDA tensors; the plain
    version (``index_add_``) agrees within the f64 rule; what the kernel does
    not take is refused before it runs."""
    g = _gen(dev, 23)
    p = torch.randn((4096, 16), generator=g, device=dev)
    labels = torch.randint(0, 50, (4096,), generator=g, device=dev, dtype=torch.int32)
    before = K.KMEANS_UPDATE.launches
    sums, counts = K.update_scatter(p, labels, 50)
    assert K.KMEANS_UPDATE.launches == before + 1
    ref_sums, ref_counts = K.update_scatter_ref(p, labels, 50)
    torch.testing.assert_close(sums, ref_sums, rtol=1e-5, atol=1e-4)
    assert torch.equal(counts, ref_counts)
    with pytest.raises(TypeError):
        K.update_cuda(p.double(), labels, 50)
    with pytest.raises(ValueError):
        K.update_cuda(p.T, labels[:16], 50)
    with pytest.raises(ValueError):
        K.update_cuda(p, labels.cpu(), 50)
    assert K.KMEANS_UPDATE.launches == before + 1


def _angles(kind, a, dev):
    if kind == "grid":
        ang = T.angle_grid(a)
    else:  # arbitrary angles over the full circle
        ang = np.random.default_rng(a).uniform(0, 2 * np.pi, a).astype(np.float32)
    return torch.from_numpy(ang).to(dev)


@pytest.mark.parametrize("b,a,n_det,n,kind", [
    (1, 1, 8, 8, "grid"), (1, 4, 9, 9, "grid"), (2, 7, 33, 20, "grid"),
    (3, 16, 24, 40, "grid"), (1, 180, 64, 64, "grid"), (2, 45, 100, 71, "random"),
    (1, 1100, 16, 16, "grid"),
])
def test_projectors_match_plain(dev, b, a, n_det, n, kind):
    """Non-negative inputs, so max|ref| bounds each sum's terms: a sum of m
    f32 terms in two orders differs by at most ~m eps_f32 of it. The
    1100-angle case stages 69 chunks of 16 angles, the last partly empty."""
    g = _gen(dev, b * a + n)
    angles = _angles(kind, a, dev)
    cos_t, sin_t = T.trig(angles)
    sinos = torch.rand((b, a, n_det), generator=g, device=dev)
    imgs = torch.rand((b, n, n), generator=g, device=dev)
    bp, bp_ref = T.backproject_batch(sinos, angles, n), T.backproject_plain(sinos, cos_t, sin_t, n)
    fp, fp_ref = T.project_batch(imgs, angles, n_det), T.project_plain(imgs, cos_t, sin_t, n_det)
    torch.cuda.synchronize()
    assert bp.shape == (b, n, n) and fp.shape == (b, a, n_det)
    assert float((bp - bp_ref).abs().max()) <= a * F32_EPS * float(bp_ref.abs().max()) + 1e-6
    assert float((fp - fp_ref).abs().max()) <= 4 * n * F32_EPS * float(fp_ref.abs().max()) + 1e-6
    lhs = float((fp.double() * sinos.double()).sum())
    rhs = float((imgs.double() * bp.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.parametrize("b", [1, 3, 8, 9])
def test_project_frame_chunks_both_walks_and_sparse_images(dev, b):
    """``tomo_project`` carries 8 frames per thread: 1, 3, 8 and 9 frames
    (a full chunk and one more). Angles just below, at and just above 45
    and 135 degrees walk rows on one side and columns (the transposed copy)
    on the other. Dense images under the sum rule; sparse images (a few
    unit pixels: corners, centre, seeded ones), where a window that drops a
    pixel would show as an error of its weight, under (lit pixels) eps_f32
    max|ref|; the projectors adjoint to 1e-4."""
    n, n_det = 96, 110
    deg = np.array([0, 30, 44.9, 45, 45.1, 60, 90, 134.9, 135, 135.1, 170, 200])
    angles = torch.from_numpy(np.deg2rad(deg).astype(np.float32)).to(dev)
    cos_t, sin_t = T.trig(angles)
    g = _gen(dev, 40 + b)
    dense = torch.rand((b, n, n), generator=g, device=dev)
    sparse = torch.zeros((b, n, n), device=dev)
    for f in range(b):
        sparse[f].view(-1)[torch.randint(0, n * n, (16,), generator=g, device=dev)] = 1.0
    sparse[:, [0, 0, n - 1, n - 1, n // 2], [0, n - 1, 0, n - 1, n // 2]] = 1.0
    lit = int((sparse > 0).flatten(1).sum(1).max())
    for imgs, terms, slack in ((dense, 4 * n, 1e-6), (sparse, lit, 0.0)):
        fp, ref = T.project_batch(imgs, angles, n_det), T.project_plain(imgs, cos_t, sin_t, n_det)
        torch.cuda.synchronize()
        assert fp.shape == (b, len(deg), n_det)
        assert float((fp - ref).abs().max()) <= terms * F32_EPS * float(ref.abs().max()) + slack
    sinos = torch.rand((b, len(deg), n_det), generator=g, device=dev)
    lhs = float((T.project_batch(dense, angles, n_det).double() * sinos.double()).sum())
    rhs = float((dense.double() * T.backproject_batch(sinos, angles, n).double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


def test_project_takes_directions_of_any_length(dev):
    """``project_cuda`` takes cos/sin as given: scaled to |(cos, sin)| = 0.6,
    a line holds up to 5 kept pixels for a bin (2 / |slope| > 3), which the
    kernel gathers on its general path; it must still equal the plain
    version and stay adjoint to the backprojection."""
    n, n_det = 64, 90
    cos_t, sin_t = (0.6 * t for t in T.trig(_angles("grid", 24, dev)))
    g = _gen(dev, 77)
    imgs = torch.rand((3, n, n), generator=g, device=dev)
    sinos = torch.rand((3, 24, n_det), generator=g, device=dev)
    fp, ref = T.project_cuda(imgs, cos_t, sin_t, n_det), T.project_plain(imgs, cos_t, sin_t, n_det)
    bp = T.backproject_cuda(sinos, cos_t, sin_t, n)
    torch.cuda.synchronize()
    assert float((fp - ref).abs().max()) <= 4 * n * F32_EPS * float(ref.abs().max()) + 1e-6
    lhs = float((fp.double() * sinos.double()).sum())
    rhs = float((imgs.double() * bp.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


def test_projectors_use_the_current_stream_and_count_launches(dev):
    g = _gen(dev, 3)
    angles = _angles("grid", 30, dev)
    sinos = torch.rand((2, 30, 40), generator=g, device=dev)
    before = (T.TOMO_BACKPROJECT.launches, T.TOMO_PROJECT.launches)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        img = T.backproject_batch(sinos, angles, 32)
        sino = T.project_batch(img, angles, 40)
    side.synchronize()
    assert (T.TOMO_BACKPROJECT.launches, T.TOMO_PROJECT.launches) == (before[0] + 1, before[1] + 1)
    cos_t, sin_t = T.trig(angles)
    ref = T.project_plain(T.backproject_plain(sinos, cos_t, sin_t, 32), cos_t, sin_t, 40)
    torch.testing.assert_close(sino, ref, rtol=1e-4, atol=1e-3)


def test_projectors_reject_what_they_cannot_take(dev):
    cos_t, sin_t = T.trig(_angles("grid", 4, dev))
    with pytest.raises(TypeError):
        T.backproject_cuda(torch.zeros((1, 4, 6), device=dev, dtype=torch.float64), cos_t, sin_t, 5)
    with pytest.raises(ValueError):
        T.project_cuda(torch.zeros((1, 5, 5), device=dev), cos_t[:3], sin_t, 6)
    with pytest.raises(ValueError):
        T.backproject_cuda(torch.zeros((1, 6, 4), device=dev).transpose(1, 2), cos_t, sin_t, 5)
    many = torch.zeros(70_000, device=dev)  # more angles than a grid dimension holds
    with pytest.raises(RuntimeError, match="CUDA error"):
        T.project_cuda(torch.zeros((1, 4, 4), device=dev), many, many, 6)


def test_apps_on_the_card_match_the_cpu(dev):
    """The apps' whole batch on CUDA against the same batch on the CPU:
    1e-4 for the centroids (``kmeans_update`` sums each label's rows in
    another order than the CPU's one pass in row order), 1e-3 of the peak
    for ML-EM."""
    rng = np.random.default_rng(0)
    msgs = [type("Msg", (), {"value": rng.normal(size=(5000, 3)) + 5 * i})() for i in range(3)]
    on_card = StreamingKMeans(10, 3, seed=1, device=dev)
    on_cpu = StreamingKMeans(10, 3, seed=1, device="cpu")
    s_card = on_card.process(None, msgs)
    s_cpu = on_cpu.process(None, msgs)
    on_card.sync()
    torch.testing.assert_close(s_card.cpu(), s_cpu, rtol=1e-4, atol=1e-4)

    img = T.shepp_logan(48)
    angles = torch.from_numpy(T.angle_grid(60))
    frame = type("Msg", (), {"value": T.project(img, angles, 64).numpy()})()
    rec_card = ReconstructionApp("mlem", n=48, mlem_iters=3, device=dev).process(None, [frame] * 3)
    rec_cpu = ReconstructionApp("mlem", n=48, mlem_iters=3, device="cpu").process(None, [frame] * 3)
    peak = float(rec_cpu.abs().max())
    assert float((rec_card.cpu() - rec_cpu).abs().max()) <= 1e-3 * peak
    assert math.isfinite(peak)


def _backproject_checked(sinos, cos_t, sin_t, n, terms):
    """``tomo_backproject`` against the plain version under the sum rule
    (``terms`` f32 terms per pixel in two orders), twice, bitwise equal."""
    out = T.backproject_cuda(sinos, cos_t, sin_t, n)
    again = T.backproject_cuda(sinos, cos_t, sin_t, n)
    ref = T.backproject_plain(sinos, cos_t, sin_t, n)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert torch.equal(out, again)
    err = float((out - ref).abs().max())
    assert err <= terms * F32_EPS * float(ref.abs().max()) + 1e-6, err
    return out, ref


@pytest.mark.parametrize("b", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("n,n_det,a", [(37, 50, 7), (100, 90, 360)])
def test_backproject_frame_chunks(dev, b, n, n_det, a):
    """The backprojector carries 8 frames per thread: 1, 3, 8, 9 and 17
    frames (chunks that are not a multiple of 8), on dense sinograms."""
    g = _gen(dev, 500 + b * n + a)
    cos_t, sin_t = T.trig(_angles("grid", a, dev))
    _backproject_checked(torch.rand((b, a, n_det), generator=g, device=dev), cos_t, sin_t, n,
                         2 * a)


@pytest.mark.parametrize("n,n_det", [(37, 30), (37, 50), (100, 90), (100, 130), (1448, 1400),
                                     (1448, 1500)])
@pytest.mark.parametrize("a", [1, 7, 360])
def test_backproject_sizes_and_angle_counts(dev, n, n_det, a):
    """Images of 37, 100 and 1448 pixels (tiles cut by the image's edge),
    detectors narrower and wider than the image, 1, 7 and 360 angles (a
    staged chunk of 16 angles partly empty, and many chunks), 9 frames."""
    g = _gen(dev, n * 7 + n_det + a)
    cos_t, sin_t = T.trig(_angles("grid", a, dev))
    _backproject_checked(torch.rand((9, a, n_det), generator=g, device=dev), cos_t, sin_t, n,
                         2 * a)


def _sparse_sinograms(b, a, n_det, dev, g):
    """Zero but for unit bins at 0, 1, n_det - 2, n_det - 1, every 13th bin
    (some at the edge of every tile's window) and 8 seeded bins per row."""
    sinos = torch.zeros((b, a, n_det), device=dev)
    sinos[..., [0, 1, n_det - 2, n_det - 1]] = 1.0
    sinos[..., ::13] = 1.0
    idx = torch.randint(0, n_det, (b, a, 8), generator=g, device=dev)
    sinos.scatter_(2, idx, 1.0)
    return sinos


@pytest.mark.parametrize("b", [1, 9])
@pytest.mark.parametrize("n,n_det", [(100, 110), (64, 40), (150, 150)])
def test_backproject_exact_angles_and_sparse_sinograms(dev, b, n, n_det):
    """Angles at exactly 0, 45, 90, 135 and 180 degrees and just beside
    them; sparse sinograms, where a bin dropped from a tile's window, or
    staged at the wrong offset or frame, shows as an error of its weight
    against a tolerance of (2 A) eps_f32 max|ref| over A = 13 angles; dense
    ones under the sum rule; adjoint to the projector within 1e-4."""
    deg = np.array([0, 0.1, 30, 44.9, 45, 45.1, 90, 120, 134.9, 135, 135.1, 179.9, 180])
    angles = torch.from_numpy(np.deg2rad(deg).astype(np.float32)).to(dev)
    cos_t, sin_t = T.trig(angles)
    g = _gen(dev, 900 + b + n)
    a = len(deg)
    _backproject_checked(_sparse_sinograms(b, a, n_det, dev, g), cos_t, sin_t, n, 2 * a)
    dense = torch.rand((b, a, n_det), generator=g, device=dev)
    bp, _ = _backproject_checked(dense, cos_t, sin_t, n, 2 * a)
    imgs = torch.rand((b, n, n), generator=g, device=dev)
    lhs = float((T.project_cuda(imgs, cos_t, sin_t, n_det).double() * dense.double()).sum())
    rhs = float((imgs.double() * bp.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


def test_backproject_at_the_path_shape_on_sparse_sinograms(dev):
    """8 x 360 x 1448 -> 8 x 1448^2, as the light-source path runs it, on
    sparse sinograms (the smoke run's ``check tomo_backproject sparse``)."""
    g = _gen(dev, 1448)
    cos_t, sin_t = T.trig(_angles("grid", 360, dev))
    _backproject_checked(_sparse_sinograms(8, 360, 1448, dev, g), cos_t, sin_t, 1448, 720)


def test_backproject_takes_directions_longer_than_unit(dev):
    """cos/sin scaled to length 1.7: a tile then reaches more bins than its
    staged window holds, and those angles read the sinograms directly; the
    result must still equal the plain version."""
    n, n_det, a = 70, 160, 24
    cos_t, sin_t = (1.7 * t for t in T.trig(_angles("grid", a, dev)))
    g = _gen(dev, 17)
    _backproject_checked(torch.rand((9, a, n_det), generator=g, device=dev), cos_t, sin_t, n,
                         2 * a)
