"""The Mini-App streaming path end to end in both packages, on the CPU:
``kafka`` + ``spark`` pilots, a MASS source, the micro-batch engine and a
MASA processor. One partition, one producer and one message per batch make
the batch sequence deterministic, so the two packages' final states can be
compared."""
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.miniapps as jax_miniapps
import repro_torch.core as torch_core
import repro_torch.miniapps as torch_miniapps

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _run(core, miniapps, devices, make_source, make_app, n_batches, init=None):
    svc = core.PilotComputeService(devices=devices)
    try:
        cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
        ctx = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"}).get_context()
        cluster.create_topic("t", 1)
        source = make_source(miniapps, cluster)
        app = make_app(miniapps, ctx.devices[0])
        if init is not None:
            init(app)
        stream = ctx.stream(cluster, "t", group="g", process_fn=app.process,
                            batch_interval=0.02, max_batch_records=1)
        stream.start()
        source.start()
        try:
            stream.await_batches(n_batches, timeout=120)
        finally:
            stream.stop()
            source.stop()
        assert stream.stats.batches == n_batches == app.stats.batches
        return stream.state, source, app
    finally:
        svc.cancel()


def _kmeans_source(miniapps, cluster):
    cfg = miniapps.SourceConfig("t", total_messages=6, n_producers=1, seed=3)
    return miniapps.KMeansClusterSource(cluster, cfg, n_clusters=4, dim=3, points_per_msg=400)


def test_kmeans_pipeline_matches_jax():
    """Final centroids within 1e-5 (f32 sums in another order over six
    batches), starting from the JAX app's centroids."""
    jax_state, _, jax_app = _run(
        jax_core, jax_miniapps, None, _kmeans_source,
        lambda m, dev: m.StreamingKMeans(4, 3, seed=1, decay=0.8), 6)

    def init(app):
        app.centroids = torch_miniapps.state_from_jax(
            {"centroids": np.asarray(jax_app.centroids)}, CPU)["centroids"]

    torch_state, _, torch_app = _run(
        torch_core, torch_miniapps, [CPU], _kmeans_source,
        lambda m, dev: m.StreamingKMeans(4, 3, seed=7, decay=0.8, device=dev), 6, init)
    assert torch_state.device == CPU
    np.testing.assert_allclose(torch_state.numpy(), np.asarray(jax_state), rtol=1e-5, atol=1e-5)
    assert torch_app.inertia == pytest.approx(jax_app.inertia, rel=1e-4)


@pytest.mark.parametrize("algorithm,atol", [("gridrec", 1e-4), ("mlem", 1e-3)])
def test_lightsource_pipeline_matches_jax(algorithm, atol):
    """The last reconstruction of a light-source stream: atol 1e-4 (GridRec)
    / 1e-3 (ML-EM). Each package makes its own template frame (with its own
    projector and angle grid), and those agree to 1e-4."""
    def source(miniapps, cluster):
        cfg = miniapps.SourceConfig("t", total_messages=3, n_producers=1, seed=0)
        return miniapps.LightsourceTemplateSource(cluster, cfg, n_angles=16, n_det=32)

    jax_state, jax_src, _ = _run(
        jax_core, jax_miniapps, None, source,
        lambda m, dev: m.ReconstructionApp(algorithm, n=24, mlem_iters=2), 3)
    torch_state, torch_src, _ = _run(
        torch_core, torch_miniapps, [CPU], source,
        lambda m, dev: m.ReconstructionApp(algorithm, n=24, mlem_iters=2, device=dev), 3)
    np.testing.assert_allclose(torch_src._payload, jax_src._payload, atol=1e-4)
    assert torch_state.shape == (24, 24)
    np.testing.assert_allclose(torch_state.numpy(), np.asarray(jax_state), atol=atol)


def test_pipeline_rescale_moves_kmeans_state():
    """An extension pilot (paper Listing 4) grows the engine's device list
    and the stream's on_rescale hook moves the live centroids."""
    svc = torch_core.PilotComputeService(devices=[CPU, CPU])
    try:
        cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
        spark = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"})
        ctx = spark.get_context()
        cluster.create_topic("t", 1)
        app = torch_miniapps.StreamingKMeans(4, 3, device=ctx.devices[0])
        stream = ctx.stream(cluster, "t", group="g", process_fn=app.process,
                            batch_interval=0.02, max_batch_records=1)
        in_flight_at_move = []

        def rescale(devices):
            # the stream drained the app before calling the hook; read it
            # here, under the stream's state lock, since the batch loop
            # dispatches new batches as soon as the rescale returns
            in_flight_at_move.append(app.in_flight)
            return app.on_rescale(devices)(stream.state)

        stream.on_rescale = rescale
        assert stream.sync_fn == app.sync
        source = _kmeans_source(torch_miniapps, cluster)
        stream.start()
        source.start()
        stream.await_batches(2, timeout=60)
        svc.submit_pilot(torch_core.PilotComputeDescription(
            number_of_nodes=1, framework="spark", parent=spark))
        assert len(ctx.devices) == 2 and in_flight_at_move == [0]
        stream.await_batches(4, timeout=60)
        stream.stop()
        source.stop()
        assert stream.state.shape == (4, 3) and bool(torch.isfinite(stream.state).all())
    finally:
        svc.cancel()
