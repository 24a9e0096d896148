"""Double-buffered host->device prefetch.

Keeps ``depth`` batches in flight so host-side deserialization/assembly
overlaps device compute — the data-pipeline side of the paper's "balance
production and processing" requirement. Own copy of the JAX package's
``data/prefetch.py``: a thread copies each item to ``device`` with
``.to(device, non_blocking=True)`` (the JAX package's ``device_put``).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import torch

from repro_torch.data.batching import shard_batch


class DevicePrefetcher:
    def __init__(self, it: Iterator[Any], *, device: torch.device | str | None = None,
                 depth: int = 2):
        self._it = it
        self._device = device
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._it:
                if self._device is not None:
                    item = shard_batch(item, self._device, non_blocking=True)
                self._q.put(item)
        except BaseException as e:  # surfaced on next()
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        item = self._q.get()
        if item is self._done:
            if self._error:
                raise self._error
            raise StopIteration
        return item
