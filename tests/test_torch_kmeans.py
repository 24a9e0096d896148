"""The port's K-Means assignment and streaming update against the JAX
package, on the same numpy inputs (CPU: the port's wrapper takes its plain
version here; the CUDA kernel is held against that version on the card by
chip_smoke.py)."""
import dataclasses

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


def _kahan(s, c, x, where):
    """``kmeans_update``'s Kahan step s + x (compensation c, the pair
    standing for s - c) in f32, applied where ``where`` holds."""
    y = x - c
    t = s + y
    return np.where(where, t, s), np.where(where, (t - s) - y, c)


def _pair_add(s, c, s2, c2):
    """Two (sum, compensation) pairs added by a TwoSum, its rounding error
    carried in the compensation (``pair_add`` of the kernel), in f32."""
    t = s + s2
    bp = t - s
    err = (s - (t - bp)) + (s2 - bp)
    return t, (c + c2) - err


def _halving(s, c, n):
    """The kernel's fixed tree over the first axis: m entries -> ceil(m / 2),
    entry g taking entry g + ceil(m / 2), pairs by :func:`_pair_add`."""
    s, c, n = s.copy(), c.copy(), n.copy()
    m = s.shape[0]
    while m > 1:
        h = (m + 1) // 2
        s[:m - h], c[:m - h] = _pair_add(s[:m - h], c[:m - h], s[h:m], c[h:m])
        n[:m - h] += n[h:m]
        m = h
    return s[0], c[0], n[0]


def _row_labels(labels, k, mask):
    """The label each row adds to, -1 where none: masked or outside [0, K)."""
    lab = np.asarray(labels, np.int64)
    none = (lab < 0) | (lab >= k)
    if mask is not None:
        none |= ~mask
    return np.where(none, -1, lab)


def _partials_update(points, labels, k, mask, plan):
    """The ``partials`` regime's decomposition on the CPU, in f32: blocks of
    ``plan.block_rows(N)`` rows in tiles; thread (g, c) Kahan-adds rows g,
    g + G, ... of each tile where the row's label is c's; the groups by
    :func:`_halving`; then the block partials, warp w taking blocks w, w + 8,
    ... by :func:`_pair_add`, and the 8 warps by :func:`_halving`."""
    n, d = points.shape
    lab = _row_labels(labels, k, mask)
    g_n, br = plan.groups, plan.block_rows(n)
    tr = min(plan.tile_rows, br)
    blocks = -(-n // br)
    x = points.astype(np.float32)
    b = np.arange(blocks)[:, None]
    g = np.arange(g_n)[None, :]
    s = np.zeros((blocks, g_n, k, d), np.float32)
    c = np.zeros_like(s)
    cnt = np.zeros((blocks, g_n, k), np.int64)
    for t0 in range(0, br, tr):  # tile by tile, each thread's rows in order
        for step in range(0, tr, g_n):
            local = t0 + step + g
            row = b * br + local
            ok = (step + g < tr) & (local < br) & (row < n)
            li = np.where(ok, lab[np.minimum(row, n - 1)], -1)
            hit = li[..., None] == np.arange(k)  # (blocks, G, K)
            xi = x[np.minimum(row, n - 1)][:, :, None, :]
            s, c = _kahan(s, c, np.broadcast_to(xi, s.shape), hit[..., None])
            cnt += hit
    part = [_halving(s[i], c[i], cnt[i]) for i in range(blocks)]
    w_s = np.zeros((8, k, d), np.float32)
    w_c = np.zeros_like(w_s)
    w_n = np.zeros((8, k), np.int64)
    for i, (ps, pc, pn) in enumerate(part):
        w_s[i % 8], w_c[i % 8] = _pair_add(w_s[i % 8], w_c[i % 8], ps, pc)
        w_n[i % 8] += pn
    ts, tc, tn = _halving(w_s, w_c, w_n)
    return ts - tc, tn.astype(np.float32)


def _counting_sort(labels, k, mask, sort_rows=K_ops.SORT_ROWS, warps=8):
    """The ``sorted`` regime's counting sort on the CPU: blocks of
    ``sort_rows`` rows, 8 warps of chunks of 32; per-warp counts (a chunk's
    lanes with one label grouped as ``__match_any_sync`` groups them, the
    highest adding their number), per-block counts, the scan in label then
    block order, and each row placed at its warp's next slot for its label
    after the earlier lanes of its chunk with that label. Returns (order of
    the rows that add to a label, starts (K + 1))."""
    lab = _row_labels(labels, k, mask)
    n = lab.shape[0]
    units = -(-n // sort_rows)
    padded = np.full(units * sort_rows, -1)
    padded[:n] = lab
    chunks = padded.reshape(units, warps, sort_rows // warps // 32, 32)
    lanes = np.arange(32)

    def walk(counts, place=None):
        for u in range(units):
            for w in range(warps):
                for chunk_no, chunk in enumerate(chunks[u, w]):
                    same = chunk[:, None] == chunk[None, :]  # match_any: lane x lane
                    for lane in lanes[chunk >= 0]:
                        if place is not None:
                            rank = int(same[lane, :lane].sum())  # popc(same & below)
                            row = (u * warps + w) * chunks.shape[2] * 32 + chunk_no * 32 + lane
                            place[counts[u, w, chunk[lane]] + rank] = row
                    for lane in lanes[chunk >= 0]:
                        if lane == lanes[same[lane]].max():  # the group's highest lane
                            counts[u, w, chunk[lane]] += int(same[lane].sum())

    wh = np.zeros((units, warps, k), np.int64)
    walk(wh)
    hist = wh.sum(1)
    starts = np.concatenate([[0], np.cumsum(hist.sum(0))])
    first = starts[:-1] + np.cumsum(hist, 0) - hist  # block u's first slot of label l
    warp_first = first[:, None, :] + np.cumsum(wh, 1) - wh
    order = np.full(n, -1)
    walk(warp_first, order)
    return order[:starts[k]], starts


def _segmented_update(points, order, starts, k, plan):
    """The ``sorted`` regime's sums on the CPU, in f32: segments of
    ``plan.seg_rows`` sorted rows whose pieces are written whole or kept as a
    head or tail partial, thread row r summing rows r, r + R, ... of a piece
    (R = 256 / cols) by Kahan addition, a halving tree over R, and each
    crossing run merged in segment order (the first port's scheme)."""
    n_sorted, d = order.shape[0], points.shape[1]
    x = points[order].astype(np.float32)
    rows, seg = K_ops.UPDATE_THREADS // plan.cols, plan.seg_rows

    def kahan_rows(v):  # (m, w) -> (w,): thread rows, then the tree
        m, w = v.shape
        v = np.concatenate([v, np.zeros((-m % rows, w), np.float32)]).reshape(-1, rows, w)
        acc, comp = np.zeros((rows, w), np.float32), np.zeros((rows, w), np.float32)
        for step in v:
            acc, comp = _kahan(acc, comp, step, True)
        h = rows // 2
        while h > 0:
            acc[:h] += acc[h:2 * h]
            h //= 2
        return acc[0]

    sums, part = np.full((k, d), np.nan, np.float32), {}
    lab_sorted = np.repeat(np.arange(k), np.diff(starts))
    for s0 in range(0, n_sorted, seg):
        s1, start = min(s0 + seg, n_sorted), s0
        while start < s1:
            lab = lab_sorted[start]
            lo, hi = starts[lab], starts[lab + 1]
            end = min(hi, s1)
            piece = kahan_rows(x[start:end])
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
            sums[lab] = part[(first, "tail")] + kahan_rows(heads)
    return sums, np.diff(starts).astype(np.float32)


def _update_inputs(n, d, k, labelling):
    rng = np.random.default_rng(n + d + k)
    pts = (rng.normal(size=(n, d)) * 10 + 3).astype(np.float32)
    labels = {"clustered": rng.integers(0, k, n), "one": np.full(n, k // 3),
              "uniform": rng.integers(0, k, n), "masked": rng.integers(0, k, n),
              "out_of_range": rng.integers(-2, k + 2, n)}[labelling]
    mask = rng.random(n) < 0.7 if labelling == "masked" else None
    return pts, labels, mask


def _hold_update(pts, labels, k, mask, sums, counts, labelling):
    """The chip check's rule against a float64 sum of the rows that add to a
    label (each entry within 2^-20 of the sum of |x| over its rows), exact
    counts, and the JAX package's scatter within its row-order rounding
    (skipped for labels out of range: the JAX scatter wraps negative
    indices, the kernel leaves such rows out)."""
    k_, d = sums.shape
    lab = _row_labels(labels, k, mask)
    keep = lab >= 0
    ref, mag, ref_counts = np.zeros((k, d)), np.zeros((k, d)), np.zeros(k)
    np.add.at(ref, lab[keep], pts[keep])
    np.add.at(mag, lab[keep], np.abs(pts[keep]))
    np.add.at(ref_counts, lab[keep], 1)
    assert np.all(np.abs(sums - ref) <= 2.0 ** -20 * mag)
    np.testing.assert_array_equal(counts, ref_counts)
    if labelling == "out_of_range":
        return
    jax_sums, jax_counts = jax_update_scatter(jnp.asarray(pts), jnp.asarray(labels), k,
                                              None if mask is None else jnp.asarray(mask))
    # the reference adds in row order: m - 1 roundings for a label of m rows
    jax_tol = (2.0 ** -20 + ref_counts[:, None] * 2.0 ** -24) * mag
    assert np.all(np.abs(sums - np.asarray(jax_sums)) <= jax_tol)
    np.testing.assert_array_equal(counts, np.asarray(jax_counts))


UPDATE_CASES = [
    (5000, 3, 10, "clustered"),     # the K-Means stream's shape, cut down
    (3000, 128, 64, "one"),         # every row on one label: one run over every segment
    (200, 33, 300, "uniform"),      # more labels than rows: empty runs
    (2049, 1, 4, "uniform"),        # D = 1: the tallest tree
    (4096, 16, 50, "masked"),       # rows of weight 0 add nothing
]


@pytest.mark.parametrize("n,d,k,labelling", UPDATE_CASES)
def test_update_segments_cover_each_row_once(n, d, k, labelling):
    """The ``sorted`` regime, emulated in f32: its counting sort's order and
    starts equal a stable argsort's and a searchsorted's, and the segment
    sums hold the chip check's rule against a float64 sum and the JAX
    package's scatter, the counts exact."""
    pts, labels, mask = _update_inputs(n, d, k, labelling)
    plan = K.update_plan(d, 10_000, torch.float32)  # the sorted regime's sizes for D
    assert plan.regime == "sorted"
    order, starts = _counting_sort(labels, k, mask)
    lab = _row_labels(labels, k, mask)
    np.testing.assert_array_equal(order, np.argsort(np.where(lab >= 0, lab, k),
                                                    kind="stable")[:int((lab >= 0).sum())])
    np.testing.assert_array_equal(starts, np.searchsorted(np.sort(lab[lab >= 0]),
                                                          np.arange(k + 1)))
    sums, counts = _segmented_update(pts, order, starts, k, plan)
    _hold_update(pts, labels, k, mask, sums, counts, labelling)


@pytest.mark.parametrize("n,d,k,labelling", [
    (5000, 3, 10, "clustered"),     # the K-Means stream's shape, cut down
    (3000, 4, 16, "one"),           # every row on one label
    (100, 2, 128, "uniform"),       # more labels than rows; K*D = 256, one group
    (2049, 1, 4, "uniform"),        # D = 1: 64 groups
    (4096, 16, 8, "masked"),        # rows of weight 0 add nothing; 2 groups
    (5000, 3, 10, "masked"),
    (4100, 2, 7, "out_of_range"),   # labels below 0 and from K on add nothing
])
@pytest.mark.parametrize("blocks", ["plan", "many"])
def test_update_partials_decomposition(n, d, k, labelling, blocks):
    """The ``partials`` regime (row blocks in tiles, per-thread Kahan sums,
    the compensated trees, the block-order merge), emulated in f32 at the
    plan's sizes and with many small blocks of several tiles, held as the
    sorted regime is."""
    pts, labels, mask = _update_inputs(n, d, k, labelling)
    plan = K.update_plan(d, k, torch.float32)
    assert plan.regime == "partials"
    if blocks == "many":
        plan = dataclasses.replace(plan, tile_rows=16, min_rows=40, max_blocks=64)
    sums, counts = _partials_update(pts, labels, k, mask, plan)
    _hold_update(pts, labels, k, mask, sums, counts, labelling)


@pytest.mark.parametrize("n,k,labelling", [(6000, 1024, "uniform"), (4097, 5, "one"),
                                           (2048, 3, "out_of_range"), (0, 4, "uniform"),
                                           (70, 70, "masked")])
def test_update_counting_sort_is_stable(n, k, labelling):
    """The counting sort alone, over blocks of rows that end mid-chunk and
    mid-block: ``order`` and ``starts`` equal a stable argsort's and a
    searchsorted's over the rows that add to a label."""
    _, labels, mask = _update_inputs(n, 1, k, labelling)
    order, starts = _counting_sort(labels, k, mask)
    lab = _row_labels(labels, k, mask)
    kept = lab >= 0
    np.testing.assert_array_equal(order, np.argsort(np.where(kept, lab, k), kind="stable")[
        :int(kept.sum())])
    np.testing.assert_array_equal(starts, np.searchsorted(np.sort(lab[kept]), np.arange(k + 1)))


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


@pytest.mark.parametrize("d,k,dtype,regime", [
    (3, 10, torch.float32, "partials"),     # the K-Means streams
    (3, 10, torch.bfloat16, "partials"),
    (1, 256, torch.float32, "partials"),    # K*D = 256: one group of 256 threads
    (1, 257, torch.float32, "sorted"),
    (16, 16, torch.bfloat16, "partials"),
    (128, 1024, torch.float32, "sorted"),   # the wide stream
    (128, 1024, torch.bfloat16, "sorted"),
    (128, 2, torch.float32, "partials"),
    (128, 3, torch.float32, "sorted"),
    (20_000, 2, torch.float32, "sorted"),
])
def test_update_plan_regimes(d, k, dtype, regime):
    assert K.update_plan(d, k, dtype).regime == regime


@pytest.mark.parametrize("d,k", [(3, 10), (1, 256), (16, 16), (256, 1), (128, 1024), (3, 100),
                                 (33, 7), (20_000, 2), (1, 100_000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 80_000, 1_000_000])
def test_update_plan_sizes_are_taken(d, k, dtype, n):
    """The sizes the entry point checks: a partials block is at least 8 rows
    in multiples of 8 (16-byte tiles), its tile of labels and points fits
    48 KB beside its tree, and groups x K x D threads fit a block; at most
    PARTIALS_MAX_BLOCKS blocks unless a block is at its least. A sorted
    plan's column lanes are a power of two <= 32 that divides a block, its
    segments whole steps of its rows in flight."""
    plan = K.update_plan(d, k, dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    if plan.regime == "partials":
        rows, tile, groups = plan.sizes(n)
        assert rows >= 8 and rows % 8 == 0 and tile >= 8 and tile % 8 == 0
        assert min(tile, rows) * (4 + d * elem) <= 48 * 1024 - 3 * 256 * 4
        assert groups >= 1 and groups * k * d <= K_ops.UPDATE_THREADS
        assert -(-n // rows) <= plan.max_blocks or rows == plan.min_rows
    else:
        seg_rows, cols, sort_rows = plan.sizes(n)
        assert cols in (1, 2, 4, 8, 16, 32) and cols >= min(d, 32)
        assert seg_rows % (K_ops.UPDATE_THREADS // cols) == 0 and sort_rows == K_ops.SORT_ROWS


def test_update_plan_forces_a_regime_it_takes():
    """``regime=`` names a regime: sorted for any (D, K), partials up to
    K*D = 256 threads, and nothing else."""
    assert K.update_plan(3, 10, torch.float32, "sorted").regime == "sorted"
    assert K.update_plan(3, 10, torch.float32, "sorted") == K.update_plan(3, 1024, torch.float32)
    assert K.update_plan(128, 2, torch.bfloat16, "partials").groups == 1
    with pytest.raises(ValueError, match="K\\*D <= 256"):
        K.update_plan(128, 3, torch.float32, "partials")
    with pytest.raises(ValueError, match="no kmeans_update regime"):
        K.update_plan(3, 10, torch.float32, "scatter")

