"""The port's K-Means assignment and streaming update against the JAX
package, on the same numpy inputs (CPU: the port's wrapper takes its plain
version here; the CUDA kernel is held against that version on the card by
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kmeans import assign as jax_assign
from repro.kernels.kmeans import assign_ref as jax_assign_ref
from repro.kernels.kmeans import minibatch_update as jax_minibatch_update
from repro.kernels.kmeans import minibatch_update_masked as jax_minibatch_update_masked
from repro_torch.kernels import kmeans as K
from repro_torch.kernels.kmeans import ops as K_ops

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(k, d)).astype(np.float32))


@pytest.mark.parametrize("n,d,k", [(64, 4, 3), (300, 7, 5), (128, 128, 16), (97, 3, 10)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_assign_matches_jax_kernel_and_ref(n, d, k, dtype):
    """Labels equal; distances within rtol/atol 2e-2 in bf16 (the JAX kernel
    test's tolerance: both sides round the inputs to bf16 alike, the f32
    sums differ in order) and 1e-5 relative / 1e-4 absolute in f32 (f32
    rounding of |p|^2 - 2p.c + |c|^2 summed over D in another order)."""
    pts, cen = _inputs(n, d, k, n + d + k)
    jdt, tdt = DTYPES[dtype]
    jp, jc = jnp.asarray(pts).astype(jdt), jnp.asarray(cen).astype(jdt)
    tp, tc = torch.from_numpy(pts).to(tdt), torch.from_numpy(cen).to(tdt)
    l_k, d_k = jax_assign(jp, jc, use_kernel=True, block_n=64, interpret=True)
    l_r, d_r = jax_assign_ref(jp, jc)
    l_t, d_t = K.assign(tp, tc)
    assert l_t.dtype == torch.int32 and d_t.dtype == torch.float32
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_k))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_r))
    tol = 2e-2 if dtype == "bf16" else 1e-5
    atol = 2e-2 if dtype == "bf16" else 1e-4
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_k), rtol=tol, atol=atol)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_r), rtol=tol, atol=atol)


def test_assign_ties_go_to_first_index():
    """Equidistant centroids: the first index wins, as jnp.argmin."""
    pts = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
    cen = np.array([[2.0, 0.0], [-2.0, 0.0], [0.0, 2.0], [2.0, 0.0]], np.float32)
    l_j, _ = jax_assign_ref(jnp.asarray(pts), jnp.asarray(cen))
    l_t, _ = K.assign(torch.from_numpy(pts), torch.from_numpy(cen))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    assert l_t.tolist() == [0, 0]


@pytest.mark.parametrize("n,k,decay", [(97, 4, 0.8), (1000, 10, 0.9)])
def test_minibatch_update_matches_jax(n, k, decay):
    """Centroids within 1e-5 (f32 sums in another order), labels equal,
    inertia within 1e-5 relative."""
    pts, cen = _inputs(n, 3, k, n)
    c_j, l_j, i_j = jax_minibatch_update(jnp.asarray(pts), jnp.asarray(cen), decay=decay)
    c_t, l_t, i_t = K.minibatch_update(torch.from_numpy(pts), torch.from_numpy(cen), decay=decay)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(i_t), float(i_j), rtol=1e-5)


@pytest.mark.parametrize("n,bucket", [(97, 128), (513, 1024)])
def test_minibatch_update_masked_matches_jax(n, bucket):
    """Padding rows (>= n_valid) weigh nothing and get label -1 in both
    packages; and the masked update equals the unpadded one in the port."""
    pts, cen = _inputs(n, 3, 10, n)
    padded = np.zeros((bucket, 3), np.float32)
    padded[:n] = pts
    c_j, l_j, i_j = jax_minibatch_update_masked(jnp.asarray(padded), jnp.asarray(cen), n, decay=0.8)
    c_t, l_t, i_t = K.minibatch_update_masked(torch.from_numpy(padded), torch.from_numpy(cen),
                                              n, decay=0.8)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    assert (l_t[n:] == -1).all()
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(i_t), float(i_j), rtol=1e-5)
    c_u, l_u, i_u = K.minibatch_update(torch.from_numpy(pts), torch.from_numpy(cen), decay=0.8)
    np.testing.assert_array_equal(c_t.numpy(), c_u.numpy())  # CPU adds in row order
    np.testing.assert_array_equal(l_t[:n].numpy(), l_u.numpy())


def test_update_scatter_counts_and_sums():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 4)).astype(np.float32)
    labels = rng.integers(0, 7, 300)
    sums, counts = K.update_scatter(torch.from_numpy(pts), torch.from_numpy(labels), 7)
    onehot = np.eye(7, dtype=np.float32)[labels]
    np.testing.assert_allclose(sums.numpy(), onehot.T @ pts, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(counts.numpy(), onehot.sum(0))


def test_minibatch_update_converges():
    """The convergence test of the JAX package (tests/test_kernels.py),
    through the port: inertia halves and ends near the true variance."""
    rng = np.random.default_rng(0)
    centers = np.array([[-5.0, 0.0], [5.0, 0.0], [0.0, 5.0]])

    def batch():
        return torch.as_tensor(
            centers[rng.integers(0, 3, 256)] + rng.normal(0, 0.3, (256, 2)), dtype=torch.float32)

    pts0 = batch().numpy()
    seeds = [pts0[0]]
    for _ in range(2):
        d = np.min([np.sum((pts0 - s) ** 2, axis=1) for s in seeds], axis=0)
        seeds.append(pts0[int(np.argmax(d))])
    cen = torch.as_tensor(np.stack(seeds), dtype=torch.float32)
    inertia_hist = []
    for _ in range(20):
        cen, _, inertia = K.minibatch_update(batch(), cen, decay=0.6)
        inertia_hist.append(float(inertia) / 256)
    assert inertia_hist[-1] < inertia_hist[0] / 2
    assert inertia_hist[-1] < 2.0


def test_assign_wrapper_counts_no_launch_on_cpu():
    pts, cen = _inputs(50, 3, 4, 1)
    before = K.KMEANS_ASSIGN.launches
    K.assign(torch.from_numpy(pts), torch.from_numpy(cen))
    assert K.KMEANS_ASSIGN.launches == before


def test_assign_rejects_mixed_devices_and_other_devices():
    pts, cen = _inputs(8, 3, 2, 2)
    with pytest.raises(ValueError):
        K.assign(torch.from_numpy(pts).to("meta"), torch.from_numpy(cen))
    with pytest.raises(ValueError):
        K.assign(torch.from_numpy(pts).to("meta"), torch.from_numpy(cen).to("meta"))


# ---------------------------------------------------------------------------
# the kernel's regimes, chosen on the host, and the wide regime's arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,k,dtype,regime", [
    (3, 10, torch.float32, "narrow"),        # the K-Means stream
    (3, 10, torch.bfloat16, "narrow"),
    (128, 1024, torch.float32, "wide"),      # the wide check and stream
    (128, 1024, torch.bfloat16, "wide"),
    (20_000, 2, torch.float32, "generic"),   # no centroid fits: the kernel refuses it
    (300, 5, torch.float32, "generic"),
    (16, 64, torch.float32, "narrow"),       # K*D = 1024, the narrow limit
    (16, 65, torch.float32, "generic"),
    (17, 10, torch.float32, "generic"),
    (32, 64, torch.float32, "wide"),         # K*D = 2048, the wide limit
    (31, 64, torch.float32, "generic"),
    (32, 63, torch.bfloat16, "generic"),
    (8, 256, torch.float32, "wide"),         # D = 8, the least wide D
    (7, 512, torch.float32, "generic"),
    (128, 16, torch.bfloat16, "wide"),       # K = 16, the least wide K
    (128, 15, torch.float32, "generic"),
    (4, 1024, torch.float32, "generic"),     # past narrow, too thin for wide
])
def test_assign_plan_regimes(d, k, dtype, regime):
    assert K.assign_plan(d, k, dtype).regime == regime


@pytest.mark.parametrize("d,k", [(3, 10), (16, 64), (1, 1024), (128, 1024), (33, 100), (300, 5),
                                 (20_000, 2), (64, 2000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_assign_plan_tiles_divide(d, k, dtype):
    """The tile sizes the entry point checks: a narrow block is whole warps
    of lanes in groups (within a warp) that take 4 points each (16 bytes of
    labels, of distances), and stages all K*D centroid words; a wide block is 2 x 4 warps of 64 x 32
    outputs, each chunk 128 bytes of a row, whole k-steps of the mma (8 f32
    or 16 bf16 dimensions); a generic tile fits 48 KB or is 0 (refused)."""
    plan = K.assign_plan(d, k, dtype)
    assert plan.threads % 32 == 0
    if plan.regime == "narrow":
        assert plan.tile_n * plan.k_split == plan.threads * plan.points_per_thread
        assert 32 % plan.k_split == 0 and plan.points_per_thread * 4 % 16 == 0
        assert plan.tile_k == k and k * d <= K_ops.NARROW_MAX_CD
    elif plan.regime == "wide":
        elem = torch.empty((), dtype=dtype).element_size()
        assert plan.threads == 8 * 32
        assert plan.tile_n % (2 * 64) == 0 and plan.tile_k % (4 * 32) == 0
        assert plan.chunk_d * elem == 128 and plan.chunk_d % (32 // elem) == 0
    else:
        assert plan.tile_n == plan.threads
        fits = (d + 1) * 4 <= K_ops.GENERIC_SMEM_BYTES
        assert (1 <= plan.tile_k <= k) if fits else plan.tile_k == 0
        assert plan.tile_k * (d + 1) * 4 <= K_ops.GENERIC_SMEM_BYTES


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude, then clear them."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_assign(points, centroids, passes: int):
    """The wide f32 regime's arithmetic: cross = a_lo b_hi + a_hi b_lo +
    a_hi b_hi over hi = tf32(x), lo = tf32(x - hi), summed in f32
    (``passes=1``: a_hi b_hi alone, one-pass TF32); |p|^2, |c|^2 and d^2 in
    f32, the first index winning ties."""
    ph, ch = _tf32(points), _tf32(centroids)
    cross = ph @ ch.T
    if passes == 3:
        pl, cl = _tf32(points - ph), _tf32(centroids - ch)
        cross = pl @ ch.T + ph @ cl.T + cross
    d2 = (points * points).sum(1, keepdim=True) - 2.0 * cross + (centroids * centroids).sum(1)
    dist = d2.min(1).values
    idx = torch.arange(d2.shape[1]).expand_as(d2)
    return torch.where(d2 == dist[:, None], idx, d2.shape[1]).min(1).values.to(torch.int32), dist


def _worst_over_tol(points, centroids, labels, dist, ref_labels, ref_dist):
    """``chip_smoke.check_assign``'s rule, unchanged: |dist - ref| within
    8 (D + 2) 2^-24 (|p| + max|c|)^2 per point, labels equal wherever the
    two smallest d^2 differ by more than twice that. Returns the worst
    err/tol and the count of clear-gap labels that differ."""
    d = points.shape[1]
    tol = 8 * (d + 2) * 2.0 ** -24 * (points.norm(dim=1) + centroids.norm(dim=1).max()) ** 2
    d2 = (points * points).sum(1, keepdim=True) - 2 * points @ centroids.T \
        + (centroids * centroids).sum(1)
    two = d2.topk(2, dim=1, largest=False).values
    clear = two[:, 1] - two[:, 0] > 2 * tol
    return float(((dist - ref_dist).abs() / tol).max()), int(((labels != ref_labels) & clear).sum())


def _wide_inputs(kind: str, n=512, d=128, k=256, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "randn":
        return (rng.normal(size=(n, d)).astype(np.float32),
                rng.normal(size=(k, d)).astype(np.float32))
    if kind == "clustered":  # the cluster source's data: centres in [-10, 10], spread 0.5
        centres = rng.uniform(-10, 10, (k, d))
        pts = centres[rng.integers(0, k, n)] + rng.normal(0, 0.5, (n, d))
        return pts.astype(np.float32), centres.astype(np.float32)
    # every coordinate 0.45 of a TF32 step above a TF32 value in [1, 2): one
    # pass rounds every product the same way, so its errors add up
    grid = _tf32(torch.from_numpy(rng.uniform(1, 2, (k, d)).astype(np.float32)))
    cen = (grid * (1 + 0.45 * 2.0 ** -10)).numpy()
    return cen[rng.integers(0, k, n)].copy(), cen


@pytest.mark.parametrize("kind", ["randn", "clustered", "coherent"])
def test_wide_3xtf32_arithmetic_holds_the_check(kind):
    """The 3xTF32 product, emulated, against the port's and the JAX
    package's plain versions on the same numpy inputs (512 x 128 x 256):
    within the chip check's tolerance and its clear-gap label rule."""
    pts, cen = _wide_inputs(kind)
    p, c = torch.from_numpy(pts), torch.from_numpy(cen)
    labels, dist = _tf32_assign(p, c, passes=3)
    for ref_labels, ref_dist in (K.assign_ref(p, c),
                                 tuple(torch.from_numpy(np.array(x))
                                       for x in jax_assign_ref(jnp.asarray(pts), jnp.asarray(cen)))):
        worst, bad = _worst_over_tol(p, c, labels, dist, ref_labels, ref_dist)
        assert worst < 0.05 and bad == 0, (worst, bad)


def test_one_pass_tf32_fails_the_check():
    """Dropping the lo terms (one-pass TF32) breaks the chip check's
    tolerance where every product rounds the same way, so a check on such
    data catches a kernel that drops them. (On randn and clustered data it
    lands at 0.8-1.04 of the tolerance, depending on the draw: too close to
    tell.)"""
    pts, cen = _wide_inputs("coherent")
    p, c = torch.from_numpy(pts), torch.from_numpy(cen)
    labels, dist = _tf32_assign(p, c, passes=1)
    worst, _ = _worst_over_tol(p, c, labels, dist, *K.assign_ref(p, c))
    assert worst > 1.0, worst
