"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the edge cases the smoke run's main-path shapes do not reach: tiny and
odd sizes, the generic D > 128 path and centroid tiling of
``kmeans_assign``, angles at exactly 0, 45 and 90 degrees and beyond pi,
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


def _check_assign(p, c):
    labels, dist = K.assign(p, c)
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
    shared-memory tiles of centroids (4096 x 64 x 2000: 11 tiles)."""
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
    with pytest.raises(RuntimeError, match="CUDA error"):  # 20000 dims: no centroid fits 48 KB
        K.assign(torch.zeros((4, 20_000), device=dev), torch.zeros((2, 20_000), device=dev))


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
    1100-angle case crosses the backprojection's 1024-angle smem chunk."""
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
    1e-4 for the centroids (CUDA's index_add_ sums with atomics, in another
    order), 1e-3 of the peak for ML-EM."""
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
