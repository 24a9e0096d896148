"""The port's MASA processors against the JAX package's, fed the same
messages (CPU). The K-Means apps start from the same centroids through
``state_from_jax``."""
from dataclasses import dataclass
from typing import Any

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tomo import project_ref as jax_project_ref
from repro.kernels.tomo import shepp_logan as jax_shepp_logan
from repro.miniapps import ReconstructionApp as JaxReconstructionApp
from repro.miniapps import StreamingKMeans as JaxStreamingKMeans
from repro_torch.elastic.metrics import MetricsBus
from repro_torch.miniapps import ReconstructionApp, StreamingKMeans, state_from_jax

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


@dataclass
class Msg:
    value: Any
    timestamp: float = 0.0


def _kmeans_batches(seed, n_batches=8):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(6, 3))
    out = []
    for _ in range(n_batches):
        msgs = []
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.integers(100, 1500))
            msgs.append(Msg(centers[rng.integers(0, 6, n)] + rng.normal(0, 0.5, (n, 3))))
        out.append(msgs)
    return out


def test_same_seed_gives_same_initial_centroids():
    j = JaxStreamingKMeans(n_clusters=6, dim=3, seed=2)
    t = StreamingKMeans(6, 3, seed=2, device=CPU)
    np.testing.assert_array_equal(t.centroids.numpy(), np.asarray(j.centroids))


def test_streaming_kmeans_matches_jax_app():
    """Centroids within 1e-5 after every batch (f32 sums in another order;
    the JAX app pads to buckets, which its masked update keeps exact),
    inertia within 1e-5 relative."""
    j = JaxStreamingKMeans(n_clusters=6, dim=3, seed=2, decay=0.7)
    t = StreamingKMeans(6, 3, seed=5, decay=0.7, device=CPU)
    t.centroids = state_from_jax({"centroids": np.asarray(j.centroids)}, CPU)["centroids"]
    s_j = s_t = None
    for msgs in _kmeans_batches(1):
        s_j = j.process(s_j, msgs)
        s_t = t.process(s_t, msgs)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-5)
        assert t.inertia == pytest.approx(j.inertia, rel=1e-5)
    j.sync()
    t.sync()
    assert t.stats.messages == j.stats.messages and t.stats.items == j.stats.items
    assert t.stats.batches == j.stats.batches == 8


def test_kmeans_async_window_and_latency_bus():
    bus = MetricsBus()
    app = StreamingKMeans(4, 3, async_depth=2, metrics=bus, device=CPU)
    state = None
    for msgs in _kmeans_batches(2, 5):
        state = app.process(state, msgs)
        assert app.in_flight <= 2
    app.sync()
    assert app.in_flight == 0 and len(app.stats.latency) == 5
    assert bus.value("app.latency_p50", default=-1.0, app="kmeans") >= 0.0
    assert bus.value("app.latency_p99", default=-1.0, app="kmeans") >= 0.0
    assert np.isfinite(app.inertia)


def test_kmeans_on_rescale_moves_state_to_first_device():
    app = StreamingKMeans(4, 3, device=CPU)
    state = app.process(None, _kmeans_batches(3, 1)[0])
    moved = app.on_rescale([torch.device("cpu"), torch.device("cpu")])(state)
    assert moved.device == torch.device("cpu") and app.device == torch.device("cpu")
    assert app.on_rescale([CPU])(None) is None


def _sino_msgs(shapes, n):
    img = jax_shepp_logan(n)
    msgs = []
    for i, (a, nd) in enumerate(shapes):
        angles = jnp.asarray(np.linspace(0, np.pi, a, endpoint=False).astype(np.float32))
        msgs.append(Msg(np.array(jax_project_ref(img, angles, nd)) * (1 + 0.1 * i)))
    return msgs


@pytest.mark.parametrize("algorithm,atol", [("gridrec", 1e-4), ("mlem", 1e-3)])
def test_reconstruction_app_matches_jax_app(algorithm, atol):
    """The same frames through both apps: atol 1e-4 for GridRec and 1e-3 for
    ML-EM (the JAX app test's kernel-vs-reference tolerance); both apps
    make their own angle grids, which may differ in the last bit."""
    n = 24
    msgs = _sino_msgs([(16, 32)] * 3, n)
    j = JaxReconstructionApp(algorithm, n=n, mlem_iters=2)
    t = ReconstructionApp(algorithm, n=n, mlem_iters=2, device=CPU)
    out_j = j.process(None, msgs)
    out_t = t.process(None, msgs)
    j.sync()
    t.sync()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=atol)
    assert t.stats.messages == 3 and t.stats.batches == 1


def test_reconstruction_mixed_shapes_grouped_and_last_message_is_state():
    """Two sinogram shapes in one micro-batch: both groups reconstruct, the
    state is the LAST message's reconstruction, angles are cached per
    shape — and the result matches the JAX app on the same batch."""
    n = 24
    msgs = _sino_msgs([(8, 32), (16, 32), (8, 32)], n)
    app = ReconstructionApp("gridrec", n=n, device=CPU)
    out = app.process(None, msgs)
    app.sync()
    assert out.shape == (n, n)
    assert sorted(app._angles_cache) == [8, 16]
    first = app._angles(8)
    app.process(None, msgs)
    assert app._angles(8) is first
    alone = ReconstructionApp("gridrec", n=n, device=CPU).process(None, [msgs[-1]])
    np.testing.assert_allclose(out.numpy(), alone.numpy(), rtol=1e-5, atol=1e-6)
    j = JaxReconstructionApp("gridrec", n=n)
    np.testing.assert_allclose(out.numpy(), np.asarray(j.process(None, msgs)), atol=1e-4)


def test_reconstruction_app_rejects_unknown_algorithm():
    with pytest.raises(ValueError):
        ReconstructionApp("fbp", device=CPU)


def test_state_from_jax_rejects_unknown_keys():
    with pytest.raises(KeyError):
        state_from_jax({"params": np.zeros(3)}, CPU)
    out = state_from_jax({"centroids": np.ones((2, 3), np.float64)}, CPU)
    assert out["centroids"].dtype == torch.float32 and out["centroids"].shape == (2, 3)
