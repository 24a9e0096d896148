"""Detector-simulator source: instrument-scale frame replay (MASS family).

Modeled on pvaPy's ``AdSimServer`` (the EPICS area-detector simulator the
light-source streaming stacks test against): a small cache of frames is
generated — or loaded from an HDF5 dataset — up front, then replayed at a
controlled rate, so the measured ceiling is the *transport*, not the
generator. Frames go out through :meth:`Producer.send_batch` in columnar
batches: on an shm-mounted topic each batch is one ring-slot write plus
slot-handle records, which is what lets the source reach msgs/s numbers
the per-message serde path can't.

HDF5 input is optional and gated on ``h5py`` being importable; without
it (or without a path) frames are synthetic Poisson-ish counts in the
detector's native dtype.
"""
from __future__ import annotations

import numpy as np

from repro_torch.broker.producer import Producer
from repro_torch.miniapps.mass import SOURCES, StreamSource


class DetectorSimSource(StreamSource):
    """Replay cached detector frames in rate-controlled batches."""

    def __init__(self, cluster, config, *, ny: int = 128, nx: int = 128,
                 dtype: str = "uint16", n_cached: int = 16,
                 frames_per_batch: int = 32,
                 hdf5_path: str | None = None, hdf5_dataset: str = "frames"):
        super().__init__(cluster, config)
        self.frames_per_batch = max(int(frames_per_batch), 1)
        if hdf5_path is not None:
            self._cache = self._load_hdf5(hdf5_path, hdf5_dataset, n_cached)
        else:
            rng = np.random.default_rng(config.seed + 40_000)
            dt = np.dtype(dtype)
            hi = min(4096, int(np.iinfo(dt).max)) if dt.kind in "iu" else 4096
            self._cache = [
                rng.integers(0, hi, size=(ny, nx)).astype(dt)
                for _ in range(max(n_cached, 1))
            ]
        self.frame_bytes = self._cache[0].nbytes

    @staticmethod
    def _load_hdf5(path: str, dataset: str, n_cached: int) -> list[np.ndarray]:
        try:
            import h5py
        except ImportError as exc:
            raise RuntimeError(
                "hdf5_path given but h5py is not installed") from exc
        with h5py.File(path, "r") as f:
            ds = f[dataset]
            n = min(n_cached, ds.shape[0])
            return [np.ascontiguousarray(ds[i]) for i in range(n)]

    def make_message(self, rng, i):
        return self._cache[i % len(self._cache)]

    def _produce(self, worker: int) -> None:
        """Batched override of the per-message base loop: one
        ``send_batch`` per ``frames_per_batch`` frames, cycling the cache.
        The producer's rate limiter accounts whole batches, so the
        configured msgs/s still means frames/s."""
        cfg = self.config
        rng = np.random.default_rng(cfg.seed + worker)
        rate = cfg.rate_msgs_per_s / cfg.n_producers if cfg.rate_msgs_per_s else None
        prod = Producer(self.cluster, cfg.topic, serializer=self.serializer,
                        compress=cfg.compress, rate_msgs_per_s=rate)
        self.producers.append(prod)
        quota = None if cfg.total_messages is None else cfg.total_messages // cfg.n_producers
        key = str(worker).encode() if cfg.keyed else None
        i = 0
        while not self._stop.is_set() and (quota is None or i < quota):
            if self.config.rate_msgs_per_s == 0:  # paused, not unthrottled
                self._stop.wait(0.01)
                continue
            n = self.frames_per_batch
            if quota is not None:
                n = min(n, quota - i)
            frames = [self.make_message(rng, i + j) for j in range(n)]
            stamps = [self.make_timestamp(rng, i + j) for j in range(n)]
            prod.send_batch(
                frames, key=key,
                timestamps=None if stamps[0] is None else stamps)
            i += n


SOURCES["detector"] = DetectorSimSource
