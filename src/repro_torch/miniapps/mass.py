"""MASS — Mini-App for Stream Source (paper §5).

Pluggable, tunable data producers: message rate, message size, serialization
and compression are all configuration. The two base source types of the
paper — ``cluster`` (random points around centroids, for streaming-ML
workloads) and ``template`` (replays a payload, e.g. an APS-format
light-source frame) — plus a ``tokens`` source for the LM serving path.
Sources are host-side: they make numpy payloads and
publish them to the broker.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.broker.cluster import BrokerCluster
from repro_torch.broker.producer import Producer
from repro_torch.kernels.tomo import angle_grid, project_ref, shepp_logan


@dataclass
class SourceConfig:
    topic: str
    rate_msgs_per_s: float | None = None  # None = as fast as possible
    total_messages: int | None = None
    n_producers: int = 1
    compress: bool = False
    seed: int = 0
    #: keyed=True pins each producer to one partition (ordering per source);
    #: False round-robins across partitions/broker nodes (max throughput)
    keyed: bool = False


class StreamSource:
    """Base: runs ``n_producers`` producer threads against the broker."""

    serializer = "npy"

    def __init__(self, cluster: BrokerCluster, config: SourceConfig):
        self.cluster = cluster
        self.config = config
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self.producers: list[Producer] = []

    def make_message(self, rng: np.random.Generator, i: int) -> Any:
        raise NotImplementedError

    def make_timestamp(self, rng: np.random.Generator, i: int) -> float | None:
        """Event timestamp for message ``i`` (None = broker stamps wall
        clock, the default). Override with a logical clock to make
        event-time windowing reproducible — the continuous engine's fault
        and rescale runs compare window firings bit for bit across runs,
        which wall-clock stamps cannot provide."""
        return None

    def _produce(self, worker: int) -> None:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed + worker)
        rate = cfg.rate_msgs_per_s / cfg.n_producers if cfg.rate_msgs_per_s else None
        prod = Producer(
            self.cluster, cfg.topic, serializer=self.serializer,
            compress=cfg.compress, rate_msgs_per_s=rate,
        )
        self.producers.append(prod)
        quota = None if cfg.total_messages is None else cfg.total_messages // cfg.n_producers
        key = str(worker).encode() if cfg.keyed else None
        i = 0
        while not self._stop.is_set() and (quota is None or i < quota):
            if cfg.rate_msgs_per_s == 0:  # paused, not unthrottled
                self._stop.wait(0.01)
                continue
            prod.send(self.make_message(rng, i), key=key,
                      timestamp=self.make_timestamp(rng, i))
            i += 1

    def start(self) -> "StreamSource":
        for w in range(self.config.n_producers):
            t = threading.Thread(target=self._produce, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def join(self, timeout: float | None = None) -> None:
        for t in self._threads:
            t.join(timeout)

    def stop(self) -> None:
        self._stop.set()
        self.join(1.0)

    @property
    def finished(self) -> bool:
        """True once every producer thread has run to completion (only
        finite sources — ``total_messages`` set — ever finish)."""
        return bool(self._threads) and all(
            not t.is_alive() for t in self._threads
        )

    def set_rate(self, rate_msgs_per_s: float | None) -> None:
        """Change the aggregate production rate at runtime.

        ``None`` = unthrottled, ``0`` = paused (producer threads idle until
        the rate is raised again — NOT unthrottled). Producers read their
        limiter per send, so live threads pick the new rate up on the next
        message — this is what rate-step elasticity scenarios drive.
        """
        self.config.rate_msgs_per_s = rate_msgs_per_s
        per = rate_msgs_per_s / self.config.n_producers if rate_msgs_per_s else None
        for p in self.producers:
            p.rate = per

    @property
    def sent_records(self) -> int:
        return sum(p.sent_records for p in self.producers)

    @property
    def sent_bytes(self) -> int:
        return sum(p.sent_bytes for p in self.producers)


class KMeansClusterSource(StreamSource):
    """Paper's ``cluster`` source: points drawn around ``n_clusters``
    centroids; 5000 x 3-D doubles per message ≈ 0.12 MB (the paper's 0.3 MB
    at string serialization; binary npy here)."""

    def __init__(self, cluster, config, *, n_clusters: int = 10, dim: int = 3,
                 points_per_msg: int = 5000, spread: float = 0.5):
        super().__init__(cluster, config)
        rng = np.random.default_rng(config.seed + 10_000)
        self.centers = rng.uniform(-10, 10, size=(n_clusters, dim))
        self.points_per_msg = points_per_msg
        self.spread = spread

    def make_message(self, rng, i):
        k = rng.integers(0, len(self.centers), size=self.points_per_msg)
        pts = self.centers[k] + rng.normal(0, self.spread, size=(self.points_per_msg, self.centers.shape[1]))
        return pts.astype(np.float64)


class KMeansStaticSource(StreamSource):
    """Paper's ``KMeans-static``: one pre-generated message replayed at the
    configured rate (isolates broker throughput from RNG cost — the paper
    measured 1.6x higher throughput vs KMeans-random)."""

    def __init__(self, cluster, config, *, dim: int = 3, points_per_msg: int = 5000):
        super().__init__(cluster, config)
        rng = np.random.default_rng(config.seed)
        self._payload = rng.normal(size=(points_per_msg, dim)).astype(np.float64)

    def make_message(self, rng, i):
        return self._payload


class LightsourceTemplateSource(StreamSource):
    """Paper's ``template``/light-source source: replays a synthetic
    sinogram frame ("APS data format" analog); ~2 MB per message at the
    paper's sizes (n_angles x n_det f32). The frame is made once, on the
    CPU, with the plain projector."""

    def __init__(self, cluster, config, *, n_angles: int = 360, n_det: int = 1448):
        super().__init__(cluster, config)
        n = min(n_det, 128)  # synthesize at modest resolution, tile up
        img = shepp_logan(n)
        angles = torch.from_numpy(angle_grid(n_angles))
        sino = project_ref(img, angles, n).numpy()
        reps = int(np.ceil(n_det / sino.shape[1]))
        self._payload = np.tile(sino, (1, reps))[:, :n_det].astype(np.float32)

    def make_message(self, rng, i):
        return self._payload


class TokenSource(StreamSource):
    """LM token stream: (seqs_per_msg, seq_len) int32 batches — here the
    serving path's request prompts."""

    def __init__(self, cluster, config, *, vocab_size: int, seq_len: int, seqs_per_msg: int = 8):
        super().__init__(cluster, config)
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seqs_per_msg = seqs_per_msg

    def make_message(self, rng, i):
        # zipfian-ish synthetic text: heavy head, long tail
        z = rng.zipf(1.3, size=(self.seqs_per_msg, self.seq_len))
        return np.minimum(z - 1, self.vocab_size - 1).astype(np.int32)


@dataclass
class RateStep:
    """Hold ``rate_msgs_per_s`` (None = unthrottled, 0 = paused) for
    ``duration`` seconds."""

    duration: float
    rate_msgs_per_s: float | None


class RateStepScenario:
    """Drives a source through a rate schedule — the workload generator for
    dynamic-resourcing experiments (paper Fig. 8: step the producer rate up,
    watch the autoscaler grow the pilot; step it down, watch it shrink).

    ``steps`` accepts :class:`RateStep` or bare ``(duration, rate)`` tuples.
    Transitions are recorded as ``(t_monotonic, rate)`` in ``transitions``
    so tests/benchmarks can line them up against MetricsBus history.
    """

    def __init__(self, source: StreamSource, steps: list, *, loop: bool = False):
        self.source = source
        self.steps = [s if isinstance(s, RateStep) else RateStep(*s) for s in steps]
        self.loop = loop
        self.transitions: list[tuple[float, float | None]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self) -> None:
        while True:
            for step in self.steps:
                if self._stop.is_set():
                    return
                self.source.set_rate(step.rate_msgs_per_s)
                self.transitions.append((time.monotonic(), step.rate_msgs_per_s))
                if self._stop.wait(step.duration):
                    return
            if not self.loop:
                return

    def start(self) -> "RateStepScenario":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def finished(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        self.join(1.0)

    @property
    def total_duration(self) -> float:
        return sum(s.duration for s in self.steps)


SOURCES: dict[str, type[StreamSource]] = {
    "cluster": KMeansClusterSource,
    "static": KMeansStaticSource,
    "lightsource": LightsourceTemplateSource,
    "tokens": TokenSource,
}
