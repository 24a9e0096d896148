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
