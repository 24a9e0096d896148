"""The port's tomography ops against the JAX package, on the same numpy
inputs and the same numpy f32 angles (CPU: the port's wrappers take their
plain versions here; the CUDA kernels are held against those versions on
the card by chip_smoke.py)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tomo import ops as J
from repro.kernels.tomo import ref as JR
from repro_torch.kernels import tomo as T

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def _angles(a):
    ang = np.linspace(0, np.pi, a, endpoint=False).astype(np.float32)
    return jnp.asarray(ang), torch.from_numpy(ang)


@pytest.mark.parametrize("n,n_det,a", [(16, 24, 8), (32, 48, 16), (32, 32, 24)])
def test_projectors_match_jax_kernels(n, n_det, a):
    """atol 1e-4 (projection) / 1e-3 (backprojection), the JAX kernel
    test's tolerances: the same weights summed in another order, and cos/sin
    that may differ in the last bit between the two libraries."""
    ja, ta = _angles(a)
    img = np.array(J.shepp_logan(n))
    p_j = J.project(jnp.asarray(img), ja, n_det, use_kernel=True, interpret=True)
    p_t = T.project(torch.from_numpy(img), ta, n_det)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-4)
    sino = np.array(JR.project_ref(jnp.asarray(img), ja, n_det))
    b_j = J.backproject(jnp.asarray(sino), ja, n, use_kernel=True, interpret=True)
    b_t = T.backproject(torch.from_numpy(sino), ta, n)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-3)


@pytest.mark.parametrize("n,n_det,a", [(16, 24, 8), (24, 40, 12)])
def test_projectors_match_jax_reference_on_random_data(n, n_det, a):
    """Against the dense one-hot reference, on signed random data: rtol
    1e-5 / atol 1e-4 (f32 sums in another order)."""
    rng = np.random.default_rng(n + a)
    ja, ta = _angles(a)
    img = rng.normal(size=(n, n)).astype(np.float32)
    sino = rng.normal(size=(a, n_det)).astype(np.float32)
    np.testing.assert_allclose(T.project_ref(torch.from_numpy(img), ta, n_det).numpy(),
                               np.asarray(JR.project_ref(jnp.asarray(img), ja, n_det)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(T.backproject_ref(torch.from_numpy(sino), ta, n).numpy(),
                               np.asarray(JR.backproject_ref(jnp.asarray(sino), ja, n)),
                               rtol=1e-5, atol=1e-4)


def test_batched_projectors_match_jax_batched_reference():
    rng = np.random.default_rng(3)
    n, n_det, a, b = 20, 28, 10, 3
    ja, ta = _angles(a)
    imgs = rng.random((b, n, n)).astype(np.float32)
    sinos = rng.random((b, a, n_det)).astype(np.float32)
    np.testing.assert_allclose(
        T.project_batch(torch.from_numpy(imgs), ta, n_det).numpy(),
        np.asarray(JR.project_ref_batch(jnp.asarray(imgs), ja, n_det)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        T.backproject_batch(torch.from_numpy(sinos), ta, n).numpy(),
        np.asarray(JR.backproject_ref_batch(jnp.asarray(sinos), ja, n)), rtol=1e-5, atol=1e-4)


def test_projectors_are_adjoint():
    """<P x, y> = <x, B y> at rtol 1e-4, as the JAX test."""
    n, n_det, a = 24, 32, 12
    rng = np.random.default_rng(0)
    _, ta = _angles(a)
    x = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(a, n_det)).astype(np.float32))
    lhs = float((T.project(x, ta, n_det).double() * y.double()).sum())
    rhs = float((x.double() * T.backproject(y, ta, n).double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)


def test_plain_projection_chunking_does_not_change_results(monkeypatch):
    """The plain versions loop over chunks of angles; one angle per chunk
    gives the same numbers as all angles at once."""
    from repro_torch.kernels.tomo import ref as R

    rng = np.random.default_rng(7)
    _, ta = _angles(9)
    img = torch.from_numpy(rng.random((2, 16, 16)).astype(np.float32))
    sino = torch.from_numpy(rng.random((2, 9, 20)).astype(np.float32))
    whole_p, whole_b = T.project_batch(img, ta, 20), T.backproject_batch(sino, ta, 16)
    monkeypatch.setattr(R, "_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(T.project_batch(img, ta, 20).numpy(), whole_p.numpy())
    np.testing.assert_allclose(T.backproject_batch(sino, ta, 16).numpy(), whole_b.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", ["ramlak", "shepp"])
def test_ramp_filter_matches_jax(window):
    rng = np.random.default_rng(1)
    sino = rng.normal(size=(6, 33)).astype(np.float32)
    np.testing.assert_allclose(
        T.ramp_filter(torch.from_numpy(sino), window=window).numpy(),
        np.asarray(JR.ramp_filter(jnp.asarray(sino), window=window)), rtol=1e-5, atol=1e-5)


def test_shepp_logan_matches_jax():
    for n in (16, 48, 128):
        np.testing.assert_array_equal(T.shepp_logan(n).numpy(), np.asarray(J.shepp_logan(n)))


@pytest.mark.parametrize("algorithm", ["gridrec", "mlem"])
def test_reconstruction_matches_jax(algorithm):
    """gridrec / mlem and their batch forms against the JAX package: atol
    1e-4 for GridRec (FFT + one backprojection), 1e-3 for ML-EM (two
    iterations of ratio updates), as the JAX app tests."""
    n, a, nd = 24, 16, 32
    ja, ta = _angles(a)
    sino = np.array(JR.project_ref(J.shepp_logan(n), ja, nd))
    stack = np.stack([sino, sino * 2.0, sino * 0.1])
    if algorithm == "gridrec":
        one_j, many_j = J.gridrec(jnp.asarray(sino), ja, n), J.gridrec_batch(jnp.asarray(stack), ja, n)
        one_t, many_t = T.gridrec(torch.from_numpy(sino), ta, n), T.gridrec_batch(torch.from_numpy(stack), ta, n)
        atol = 1e-4
    else:
        one_j = J.mlem(jnp.asarray(sino), ja, n, iters=2)
        many_j = J.mlem_batch(jnp.asarray(stack), ja, n, iters=2)
        one_t = T.mlem(torch.from_numpy(sino), ta, n, iters=2)
        many_t = T.mlem_batch(torch.from_numpy(stack), ta, n, iters=2)
        atol = 1e-3
    np.testing.assert_allclose(one_t.numpy(), np.asarray(one_j), atol=atol)
    np.testing.assert_allclose(many_t.numpy(), np.asarray(many_j), atol=atol)
    np.testing.assert_allclose(many_t[0].numpy(), one_t.numpy(), rtol=1e-5, atol=1e-5)


def test_reconstruction_quality_ordering():
    """Paper §6.4 (the JAX package's test, through the port): ML-EM
    reconstructs with better fidelity than GridRec."""
    n, a = 48, 60
    img = T.shepp_logan(n)
    _, ta = _angles(a)
    sino = T.project(img, ta, n + 16)

    def err(rec):
        return float(((rec - img) ** 2).mean().sqrt())

    e_grid = err(T.gridrec(sino, ta, n))
    e_mlem = err(T.mlem(sino, ta, n, iters=16))
    assert e_mlem < e_grid
    assert e_mlem < 0.5 * float((img ** 2).mean().sqrt())


def test_wrappers_count_no_launch_on_cpu():
    _, ta = _angles(4)
    before = (T.TOMO_PROJECT.launches, T.TOMO_BACKPROJECT.launches)
    T.backproject(T.project(T.shepp_logan(8), ta, 10), ta, 8)
    assert (T.TOMO_PROJECT.launches, T.TOMO_BACKPROJECT.launches) == before


# tomo.cu's backprojection tile (TOMO_BP_TILE_X x TOMO_BP_TILE_Y) and the
# bins its staged window holds, ceil(hypot(X - 1, Y - 1)) + 4
BP_TILE_X, BP_TILE_Y = 32, 16
BP_WINDOW = math.ceil(math.hypot(BP_TILE_X - 1, BP_TILE_Y - 1)) + 4


def _window_misses(n, n_det, cos_t, sin_t):
    """The backprojector's window rule with its f32 roundings
    (``detector_coords``): per tile (cut by the image's edge) and angle the
    window starts one bin below the least floor(s) of the tile's four
    corners and holds BP_WINDOW bins. Returns the (angle, tile) pairs whose
    corners span too many bins for it, and those with a pixel whose bins
    s0 or s0 + 1 fall outside the window."""
    from repro_torch.kernels.tomo.ref import detector_coords

    r0 = torch.arange(0, n, BP_TILE_Y)
    c0 = torch.arange(0, n, BP_TILE_X)
    r1 = (r0 + BP_TILE_Y - 1).clamp(max=n - 1)
    c1 = (c0 + BP_TILE_X - 1).clamp(max=n - 1)
    pool = torch.nn.functional.max_pool2d
    tile = (BP_TILE_Y, BP_TILE_X)
    too_wide = outside = 0
    for a0 in range(0, cos_t.shape[0], 8):
        s0 = detector_coords(n, n_det, cos_t[a0:a0 + 8], sin_t[a0:a0 + 8])[0]
        s0 = s0.reshape(-1, 1, n, n).to(torch.float32)  # exact: |s0| < 2^24
        # every pixel's least and largest s0 per tile
        px_hi = pool(s0, tile, tile, ceil_mode=True)[:, 0]
        px_lo = -pool(-s0, tile, tile, ceil_mode=True)[:, 0]
        s0 = s0[:, 0]
        corners = torch.stack([s0[:, r][:, :, c] for r in (r0, r1) for c in (c0, c1)])
        lo, hi = corners.amin(0), corners.amax(0)
        too_wide += int((hi - lo > BP_WINDOW - 4).sum())
        first = lo - 1
        outside += int(((px_lo < first) | (px_hi + 1 > first + BP_WINDOW - 1)).sum())
    return too_wide, outside


@pytest.mark.parametrize("n,n_det,a", [(1448, 1448, 360), (37, 30, 7), (37, 50, 7),
                                       (100, 90, 13), (100, 130, 13)])
def test_backprojection_windows_hold_every_pixels_bins(n, n_det, a):
    """Every pixel's bins s0 and s0 + 1 lie in its tile's staged window at
    the light-source path's shape (n = n_det = 1448, ``angle_grid(360)``)
    and at small sizes with odd angles, so the kernel never leaves its
    shared-memory path for unit directions."""
    ang = torch.from_numpy(T.angle_grid(a))
    if a == 13:  # exact and near-exact multiples of 45 degrees
        ang = torch.from_numpy(np.deg2rad(np.array(
            [0, 0.1, 30, 44.9, 45, 45.1, 90, 120, 134.9, 135, 135.1, 179.9, 180])).astype(np.float32))
    cos_t, sin_t = T.trig(ang)
    assert _window_misses(n, n_det, cos_t, sin_t) == (0, 0)
