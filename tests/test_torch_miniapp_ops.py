"""The Mini-App kernels as ``torch.library`` ops (``repro_torch::kmeans_assign``,
``kmeans_update``, ``tomo_project``, ``tomo_backproject``), on the CPU.

* Each op's result equals its plain version bitwise (the op's CPU
  implementation) and the JAX package's at the reference's tolerances
  (``tests/test_kernels.py``): the assignment against ``assign_pallas`` in
  interpret mode (labels equal, d^2 within rtol/atol 2e-2), the projectors
  against ``project_pallas`` / ``backproject_pallas`` in interpret mode
  (atol 1e-4 / 1e-3); the update against the reference's order-preserving
  scatter (``kernels/kmeans/ref.py`` ``update_scatter``; rtol/atol 1e-5,
  f32 sums in another order), masked and not.
* Each fake implementation gives the real outputs' shapes and dtypes under
  ``FakeTensorMode``; a ``meta`` tensor outside fake mode is refused.
* ``FlopCounterMode`` counts each op's formula exactly (``PERF.md`` §6's
  bounds: 2NKD + 3NK + 2ND, N (D + 1) adds, 4 a (frame, pixel, angle) + 6
  a (pixel, angle)), not the plain version's products.
* The main path's functions reach the ops (a dispatch mode sees them), and a
  traced projection's peak holds the kernel's transposed copy of the images.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels.kmeans import assign as jax_assign
from repro.kernels.kmeans.ref import update_scatter as jax_update_scatter
from repro.kernels.tomo import ops as J
from repro_torch.kernels import kmeans as K
from repro_torch.kernels import tomo as T
from repro_torch.kernels._library import WORKSPACES
from repro_torch.runtime.cost_analysis import trace_cost

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

OPS = torch.ops.repro_torch
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _points(n, d, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(k, d)).astype(np.float32))


def _angles(a):
    ang = np.linspace(0, np.pi, a, endpoint=False).astype(np.float32)
    return jnp.asarray(ang), torch.from_numpy(ang)


# -- results ------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,k", [(64, 4, 3), (300, 7, 5), (128, 128, 16), (97, 3, 10)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kmeans_assign_op_matches_the_plain_version_and_the_pallas_kernel(n, d, k, dtype):
    pts, cen = _points(n, d, k, n + d + k)
    jdt, tdt = DTYPES[dtype]
    tp, tc = torch.from_numpy(pts).to(tdt), torch.from_numpy(cen).to(tdt)
    labels, dist = OPS.kmeans_assign(tp, tc)
    ref_labels, ref_dist = K.assign_ref(tp, tc)
    assert labels.dtype == torch.int32 and dist.dtype == torch.float32
    assert torch.equal(labels, ref_labels) and torch.equal(dist, ref_dist)
    l_k, d_k = jax_assign(jnp.asarray(pts).astype(jdt), jnp.asarray(cen).astype(jdt),
                          use_kernel=True, block_n=64, interpret=True)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(l_k))
    np.testing.assert_allclose(dist.numpy(), np.asarray(d_k), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n,d,k", [(300, 3, 10), (257, 16, 7)])
@pytest.mark.parametrize("masked", [False, True])
def test_kmeans_update_op_matches_the_plain_version_and_the_reference(n, d, k, masked):
    pts, _ = _points(n, d, k, n + k)
    labels = np.random.default_rng(n).integers(0, k, n).astype(np.int32)
    mask = np.arange(n) < (2 * n) // 3 if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    sums, counts = OPS.kmeans_update(torch.from_numpy(pts), torch.from_numpy(labels), k, tm)
    ref_sums, ref_counts = K.update_scatter_ref(torch.from_numpy(pts), torch.from_numpy(labels),
                                                k, tm)
    assert torch.equal(sums, ref_sums) and torch.equal(counts, ref_counts)
    again = OPS.kmeans_update(torch.from_numpy(pts), torch.from_numpy(labels), k, tm)
    assert torch.equal(again[0], sums) and torch.equal(again[1], counts)
    j_sums, j_counts = jax_update_scatter(jnp.asarray(pts), jnp.asarray(labels), k,
                                          None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


@pytest.mark.parametrize("n,n_det,a", [(16, 24, 8), (32, 48, 16), (32, 32, 24)])
def test_tomo_ops_match_the_plain_versions_and_the_pallas_kernels(n, n_det, a):
    rng = np.random.default_rng(n + a)
    ja, ta = _angles(a)
    imgs = np.stack([np.array(J.shepp_logan(n)), rng.random((n, n)).astype(np.float32)])
    cos_t, sin_t = T.trig(ta)
    fp = OPS.tomo_project(torch.from_numpy(imgs), cos_t, sin_t, n_det)
    assert torch.equal(fp, T.project_plain(torch.from_numpy(imgs), cos_t, sin_t, n_det))
    fp_j = J._project_batch(jnp.asarray(imgs), ja, n_det, use_kernel=True, interpret=True)
    np.testing.assert_allclose(fp.numpy(), np.asarray(fp_j), atol=1e-4)
    sinos = fp.numpy()
    bp = OPS.tomo_backproject(torch.from_numpy(sinos), cos_t, sin_t, n)
    assert torch.equal(bp, T.backproject_plain(torch.from_numpy(sinos), cos_t, sin_t, n))
    bp_j = J._backproject_batch(jnp.asarray(sinos), ja, n, use_kernel=True, interpret=True)
    np.testing.assert_allclose(bp.numpy(), np.asarray(bp_j), atol=1e-3)


# -- fakes and FLOPs --------------------------------------------------------------------


def _cases():
    """op name -> (the op, its CPU arguments, its formula's FLOPs)."""
    pts, cen = (torch.from_numpy(x) for x in _points(97, 5, 6, 1))
    labels = torch.randint(0, 6, (97,), dtype=torch.int32, generator=torch.Generator().manual_seed(0))
    _, ta = _angles(9)
    cos_t, sin_t = T.trig(ta)
    imgs, sinos = torch.rand(2, 12, 12), torch.rand(3, 9, 14)
    return {
        "kmeans_assign": (OPS.kmeans_assign, (pts, cen), 2 * 97 * 6 * 5 + 3 * 97 * 6 + 2 * 97 * 5),
        "kmeans_assign bf16": (OPS.kmeans_assign, (pts.bfloat16(), cen.bfloat16()),
                               2 * 97 * 6 * 5 + 3 * 97 * 6 + 2 * 97 * 5),
        "kmeans_update": (OPS.kmeans_update, (pts, labels, 6, None), 97 * (5 + 1)),
        "kmeans_update masked": (OPS.kmeans_update, (pts, labels, 6, torch.arange(97) < 50),
                                 97 * (5 + 1)),
        "tomo_project": (OPS.tomo_project, (imgs, cos_t, sin_t, 14),
                         4 * 2 * 12 * 12 * 9 + 6 * 12 * 12 * 9),
        "tomo_backproject": (OPS.tomo_backproject, (sinos, cos_t, sin_t, 12),
                             4 * 3 * 12 * 12 * 9 + 6 * 12 * 12 * 9),
    }


def _fake(mode, x):
    return mode.from_tensor(x) if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("name", list(_cases()))
def test_op_fake_outputs_match_the_real_outputs(name):
    op, args, _ = _cases()[name]
    real = op(*args)
    real = real if isinstance(real, tuple) else (real,)
    with FakeTensorMode() as mode:
        fake = op(*[_fake(mode, a) for a in args])
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype, f.device) for f in fake] \
        == [(r.shape, r.dtype, r.device) for r in real]


@pytest.mark.parametrize("name", list(_cases()))
def test_a_meta_tensor_outside_fake_mode_is_refused(name):
    op, args, _ = _cases()[name]
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no tomo|no kmeans"):
        op(*meta)


@pytest.mark.parametrize("name", list(_cases()))
def test_flop_counter_counts_the_op_formula_exactly(name):
    """On CPU tensors (the plain version runs, its products unseen) and
    under fake tensors alike."""
    op, args, flops = _cases()[name]
    with FlopCounterMode(display=False) as fc:
        op(*args)
    assert fc.get_total_flops() == flops
    with FakeTensorMode() as mode:
        fake = [_fake(mode, a) for a in args]
        with FlopCounterMode(display=False) as fc:
            op(*fake)
    assert fc.get_total_flops() == flops


def test_the_formulas_are_the_kernel_bounds_counts():
    assert K.ops.assign_flops(80_000, 3, 10) == 2 * 80_000 * 10 * 3 + 3 * 80_000 * 10 \
        + 2 * 80_000 * 3
    assert K.ops.update_flops(80_000, 3) == 80_000 * 4
    assert T.ops.projector_flops(8, 360, 1448) == 8 * 1448 * 1448 * 360 * 4 + 1448 * 1448 * 360 * 6


# -- the main path reaches the ops ---------------------------------------------------------


class _Ops(TorchDispatchMode):
    """Counts the ``repro_torch`` ops a call dispatches."""

    def __init__(self):
        super().__init__()
        self.seen: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            name = func._overloadpacket.__name__
            self.seen[name] = self.seen.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_the_main_path_goes_through_the_ops():
    pts, cen = (torch.from_numpy(x) for x in _points(200, 3, 10, 2))
    _, ta = _angles(8)
    sinos = torch.rand(2, 8, 20)
    with _Ops() as kmeans_ops:
        K.minibatch_update(pts, cen)
        K.minibatch_update_masked(pts, cen, 150)
    with _Ops() as grid:
        T.gridrec_batch(sinos, ta, 16)
        T.gridrec(sinos[0], ta, 16)
    with _Ops() as mlem:
        T.mlem_batch(sinos, ta, 16, iters=3)
    assert kmeans_ops.seen == {"kmeans_assign": 2, "kmeans_update": 2}
    assert grid.seen == {"tomo_backproject": 2}
    assert mlem.seen == {"tomo_backproject": 4, "tomo_project": 3}


def test_a_traced_projection_holds_the_kernels_scratch():
    """``tomo_project``'s CUDA launch writes a transposed copy of the images
    into scratch it allocates: the traced peak holds it beside the inputs and
    the output, and both byte models read and write it once."""
    b, n, a, n_det = 2, 16, 9, 20
    _, ta = _angles(a)
    cos_t, sin_t = T.trig(ta)
    imgs = torch.empty((b, n, n), device="meta")
    out, cost = trace_cost(lambda x, c, s: OPS.tomo_project(x, c, s, n_det), imgs, cos_t, sin_t,
                           device="cpu")
    scratch = b * n * n * 4
    assert WORKSPACES["tomo_project"](imgs, cos_t, sin_t, n_det) == scratch
    assert cost.peak_bytes == cost.input_bytes + b * a * n_det * 4 + scratch
    assert cost.bytes_moved_fused == 2 * cost.input_bytes + b * a * n_det * 4 + 2 * scratch


@pytest.mark.parametrize("n,d,k", [(80_000, 3, 10), (65_536, 128, 1024), (100, 4, 3)])
def test_the_update_workspace_is_the_kernels(n, d, k):
    """The bytes registered for ``kmeans_update`` are those its CUDA launch
    allocates (``update_workspace``) in the regime ``update_plan`` chooses."""
    pts = torch.empty((n, d), device="meta")
    ints, floats = K.update_workspace(K.update_plan(d, k, torch.float32), n, d, k, "meta")
    assert WORKSPACES["kmeans_update"](pts, None, k, None) == 4 * (ints.numel() + floats.numel())
