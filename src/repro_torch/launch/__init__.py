"""Launchers of the port: the serving launcher (``serve.py``), the
streaming-training launcher (``train.py``), the meshes over
``torch.distributed`` ranks (``mesh.py``), the dry run of the production
meshes (``dryrun.py``: one rank's train, prefill and decode step traced
under fake tensors and a fake process group) and the roofline over its
records (``roofline.py``, against the H100's datasheet peaks)."""
import time


def instrumented(app, bus, label: str):
    """Wrap a MASA app's ``process`` so every serve step publishes its wall
    time and token throughput to the MetricsBus — the signals a demand
    estimator (or a human watching the bus) needs to size the pilot."""

    def process(state, msgs):
        t0 = time.monotonic()
        items0 = app.stats.items
        state = app.process(state, msgs)
        dt = time.monotonic() - t0
        toks = app.stats.items - items0
        bus.publish(f"{label}.step_time", dt, stream=label)
        bus.publish(f"{label}.tokens_per_sec", toks / dt if dt > 0 else 0.0, stream=label)
        return state

    return process
