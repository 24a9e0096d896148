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
from repro.kernels.kmeans.ref import update_scatter as jax_update_scatter
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


def _kahan_rows(x: np.ndarray, rows: int) -> np.ndarray:
    """``kmeans_update``'s sums of the rows of ``x`` (m, w) in f32: thread
    row r takes rows r, r + R, ... with Kahan addition, then a halving tree
    over the R thread rows."""
    m, w = x.shape
    x = np.concatenate([x, np.zeros((-m % rows, w), np.float32)]).reshape(-1, rows, w)
    acc, comp = np.zeros((rows, w), np.float32), np.zeros((rows, w), np.float32)
    for step in x:
        y = step - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    s = rows // 2
    while s > 0:
        acc[:s] += acc[s:2 * s]
        s //= 2
    return acc[0]


def _segmented_update(points: np.ndarray, labels: np.ndarray, k: int, mask=None):
    """``kmeans_update.cu``'s decomposition on the CPU: run starts over the
    stable-sorted labels, segments of ``update_segment_rows(D)`` sorted rows
    whose pieces are written whole or kept as a head or tail partial, and
    each crossing run merged in segment order."""
    n, d = points.shape
    w = np.ones(n, np.float32) if mask is None else mask.astype(np.float32)
    if mask is not None:
        labels = np.where(mask, labels, 0)
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    x = np.concatenate([points[order] * w[order, None], w[order, None]], axis=1)  # count last
    cols = 1
    while cols < d and cols < 32:
        cols *= 2
    rows, seg = 256 // cols, K_ops.update_segment_rows(d)
    starts = np.searchsorted(sorted_labels, np.arange(k + 1), side="left")
    sums, part = np.full((k, d + 1), np.nan, np.float32), {}
    for s0 in range(0, n, seg):
        s1, start = min(s0 + seg, n), s0
        while start < s1:
            lab = sorted_labels[start]
            lo, hi = starts[lab], starts[lab + 1]
            end = min(hi, s1)
            piece = _kahan_rows(x[start:end], rows)
            if lo >= s0 and hi <= s1:
                sums[lab] = piece
            else:
                part[(s0 // seg, "head" if lo < s0 else "tail")] = piece
            start = end
    for lab in range(k):
        lo, hi = starts[lab], starts[lab + 1]
        if hi == lo:
            sums[lab] = 0
        elif lo // seg != (hi - 1) // seg:
            first, last = lo // seg, (hi - 1) // seg
            heads = np.stack([part[(s, "head")] for s in range(first + 1, last + 1)])
            sums[lab] = part[(first, "tail")] + _kahan_rows(heads, rows)
    counts = sums[:, d] if mask is not None else (starts[1:] - starts[:-1]).astype(np.float32)
    return sums[:, :d], counts


@pytest.mark.parametrize("n,d,k,labelling", [
    (5000, 3, 10, "clustered"),     # the K-Means stream's shape, cut down
    (3000, 128, 64, "one"),         # every row on one label: one run over every segment
    (200, 33, 300, "uniform"),      # more labels than rows: empty runs
    (2049, 1, 4, "uniform"),        # D = 1: the tallest tree
    (4096, 16, 50, "masked"),       # weights: the counts summed like a column
])
def test_update_segments_cover_each_row_once(n, d, k, labelling):
    """The fixed-order update's decomposition, emulated in f32: each entry
    within 2^-20 of the sum of |x| over its rows against a float64 sum (the
    chip check's rule) and the JAX package's scatter, the counts exact."""
    rng = np.random.default_rng(n + d + k)
    pts = (rng.normal(size=(n, d)) * 10 + 3).astype(np.float32)
    labels = {"clustered": rng.integers(0, k, n), "one": np.full(n, k // 3),
              "uniform": rng.integers(0, k, n), "masked": rng.integers(0, k, n)}[labelling]
    mask = rng.random(n) < 0.7 if labelling == "masked" else None
    sums, counts = _segmented_update(pts, labels, k, mask)
    w = np.ones(n) if mask is None else mask.astype(np.float64)
    idx = np.where(w > 0, labels, 0)
    ref, mag, ref_counts = np.zeros((k, d)), np.zeros((k, d)), np.zeros(k)
    np.add.at(ref, idx, pts * w[:, None])
    np.add.at(mag, idx, np.abs(pts) * w[:, None])
    np.add.at(ref_counts, idx, w)
    assert np.all(np.abs(sums - ref) <= 2.0 ** -20 * mag)
    np.testing.assert_array_equal(counts, ref_counts)
    jax_sums, jax_counts = jax_update_scatter(jnp.asarray(pts), jnp.asarray(labels), k,
                                              None if mask is None else jnp.asarray(mask))
    # the reference adds in row order: m - 1 roundings for a label of m rows
    jax_tol = (2.0 ** -20 + ref_counts[:, None] * 2.0 ** -24) * mag
    assert np.all(np.abs(sums - np.asarray(jax_sums)) <= jax_tol)
    np.testing.assert_array_equal(counts, np.asarray(jax_counts))


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
    (20_000, 2, torch.float32, "chunked"),   # no centroid fits 48 KB: staged in chunks of D
    (20_000, 15, torch.bfloat16, "chunked"),
    (12_287, 2, torch.float32, "generic"),   # one centroid row of 48 KB, the generic limit
    (12_288, 2, torch.float32, "chunked"),
    (20_000, 16, torch.float32, "wide"),     # K = 16: wide chunks D itself
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
                                 (20_000, 2), (20_000, 15), (12_288, 1), (64, 2000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_assign_plan_tiles_divide(d, k, dtype):
    """The tile sizes the entry point checks: a narrow block is whole warps
    of lanes in groups (within a warp) that take 4 points each (16 bytes of
    labels, of distances), and stages all K*D centroid words; a wide block is 2 x 4 warps of 64 x 32
    outputs, each chunk 128 bytes of a row, whole k-steps of the mma (8 f32
    or 16 bf16 dimensions); a generic tile of whole centroid rows fits 48 KB;
    a chunked block is 8 warps of 4 points, its tile at most 16 centroids
    whose chunks of whole warps of dimensions fit 48 KB. No tile is empty:
    every (D, K) has a regime that computes it."""
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
    elif plan.regime == "chunked":
        assert (d + 1) * 4 > K_ops.GENERIC_SMEM_BYTES
        assert plan.threads == 8 * 32 and plan.tile_n == 8 * 4
        assert 1 <= plan.tile_k <= min(k, K_ops.CHUNKED_MAX_K)
        assert plan.chunk_d % 32 == 0 and 1 <= plan.chunk_d <= d
        assert plan.tile_k * plan.chunk_d * 4 <= K_ops.GENERIC_SMEM_BYTES
    else:
        assert plan.tile_n == plan.threads and plan.chunk_d == d
        assert 1 <= plan.tile_k <= k
        assert plan.tile_k * (d + 1) * 4 <= K_ops.GENERIC_SMEM_BYTES


def _butterfly(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last dimension (32 lanes) as a warp's xor butterfly
    adds it: 16, 8, 4, 2, 1 lanes apart."""
    lanes = torch.arange(32)
    for s in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ s]
    return x[..., 0]


def _chunked_assign(points, centroids):
    """The chunked regime's arithmetic: lane l of a warp sums dimensions l,
    l + 32, l + 64, ... of |p|^2, |c|^2 and p.c in f32; the warp adds the 32
    partials by a butterfly; d^2 = |p|^2 - 2 p.c + |c|^2, the first index
    winning ties."""
    pad = (-points.shape[1]) % 32
    p = torch.nn.functional.pad(points, (0, pad)).view(points.shape[0], -1, 32)
    c = torch.nn.functional.pad(centroids, (0, pad)).view(centroids.shape[0], -1, 32)
    p2 = _butterfly((p * p).sum(1))
    c2 = _butterfly((c * c).sum(1))
    cross = _butterfly(torch.einsum("nml,kml->nkl", p, c))
    d2 = p2[:, None] - 2.0 * cross + c2[None, :]
    dist = d2.min(1).values
    idx = torch.arange(d2.shape[1]).expand_as(d2)
    return torch.where(d2 == dist[:, None], idx, d2.shape[1]).min(1).values.to(torch.int32), dist


@pytest.mark.parametrize("k", [2, 15])
@pytest.mark.parametrize("clustered", [False, True])
def test_chunked_arithmetic_holds_the_check(k, clustered):
    """The chunked regime's sums, emulated at D = 20 000 (its chip check's
    width), against the port's and the JAX package's plain versions on the
    same numpy inputs: within the chip check's tolerance and its clear-gap
    label rule."""
    rng = np.random.default_rng(k + 10 * clustered)
    n, d = 48, 20_000
    if clustered:
        centres = rng.uniform(-10, 10, (k, d))
        pts = centres[rng.integers(0, k, n)] + rng.normal(0, 0.5, (n, d))
        cen = centres + rng.normal(0, 0.1, (k, d))
    else:
        pts, cen = rng.normal(size=(n, d)), rng.normal(size=(k, d))
    pts, cen = pts.astype(np.float32), cen.astype(np.float32)
    p, c = torch.from_numpy(pts), torch.from_numpy(cen)
    assert K.assign_plan(d, k, torch.float32).regime == "chunked"
    labels, dist = _chunked_assign(p, c)
    for ref_labels, ref_dist in (K.assign_ref(p, c),
                                 tuple(torch.from_numpy(np.array(x))
                                       for x in jax_assign_ref(jnp.asarray(pts), jnp.asarray(cen)))):
        worst, bad = _worst_over_tol(p, c, labels, dist, ref_labels, ref_dist)
        assert worst < 0.05 and bad == 0, (worst, bad)


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
