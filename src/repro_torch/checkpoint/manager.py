"""Checkpointing: save/restore of a tree of tensors with atomic commits.

Supports the streaming exactly-once contract: a checkpoint stores the state
tree *plus* the consumer offsets in one atomic unit (directory rename), so
recovery = restore state + rewind consumers to the stored offsets.
``restore(device=...)`` places the leaves on another device than the one
that saved them (elastic restart); ``restore(shardings=..., mesh=...)``
keeps each rank's tile of every leaf, onto another mesh than the saver's
(``save`` gathers a rank group's state into full leaves). Async mode
overlaps the file write with compute.

The on-disk format is the JAX package's, byte for byte: ``arrays.npz``
with one ``a{i}`` entry per leaf (bf16 stored as its uint16 bits) and
``manifest.json`` naming each leaf's path, index, dtype (numpy's names:
``"bfloat16"``, ``"float32"``) and shape. A checkpoint written by either
package restores in the other.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten_with_paths, tree_map_with_paths


@contextlib.contextmanager
def atomic_dir(final: str, lock: threading.Lock | None = None) -> Iterator[str]:
    """Write a directory atomically: the body fills a ``.tmp`` sibling, and
    only a clean exit swaps it into place with an ``os.rename`` commit — a
    crash mid-write leaves the previous version (or nothing) behind, never
    a torn directory. ``lock`` (if given) is held only around the swap, so
    slow serialization never serializes against readers.

    Shared by checkpoints and state migrations (repro_torch.state.migrator):
    both need the same "either the old snapshot or the new one, never half"
    guarantee.
    """
    tmp = final + ".tmp"
    if os.path.exists(tmp):  # stale tmp from a crashed writer
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        yield tmp
    except BaseException:
        # failed write (disk full, serde error): monotonically-increasing
        # step/seq names mean this path is never retried, so the tmp would
        # leak forever if left for the entry-time sweep
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with lock if lock is not None else contextlib.nullcontext():
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit


def _dtype_name(x: Any) -> str:
    """numpy's name for a leaf's dtype, as the JAX package writes it."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _to_numpy(x: Any) -> np.ndarray:
    """A host copy of one leaf (taken now, so an async write never sees a
    later in-place update); bf16 as its uint16 bits, the portable encoding."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    t = x.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.to("cpu", copy=True).numpy()
    return arr.view(np.uint16) if x.dtype == torch.bfloat16 else arr


def _from_numpy(arr: np.ndarray, dtype_name: str, device: torch.device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep_last = keep_last
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._lock = threading.Lock()

    # ---- write -----------------------------------------------------------

    def save(self, step: int, state: Any, *, meta: dict | None = None) -> str:
        """Write checkpoint ``step``; returns its path. Atomic via tmp+rename.
        A state held elsewhere, by a rank group (``miniapps/masa.py``
        ``GroupState``), is gathered first (its ``gather()``): the file
        holds full leaves whatever the placement."""
        if callable(getattr(state, "gather", None)):
            state = state.gather()
        flat = tree_flatten_with_paths(state)
        host = [(path, _to_numpy(x), _dtype_name(x)) for path, x in flat]
        if self.async_save:
            self.wait()  # at most one in flight
            t = threading.Thread(target=self._write, args=(step, host, meta or {}), daemon=True)
            t.start()
            self._pending = t
        else:
            self._write(step, host, meta or {})
        return self._path(step)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _write(self, step: int, host: list, meta: dict) -> None:
        with atomic_dir(self._path(step), lock=self._lock) as tmp:
            arrays = {f"a{i}": arr for i, (_, arr, _) in enumerate(host)}
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            manifest = {
                "step": step,
                "time": time.time(),
                "leaves": [
                    {"path": path, "index": i, "dtype": dt, "shape": list(arr.shape)}
                    for i, (path, arr, dt) in enumerate(host)
                ],
                "meta": meta,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
        with self._lock:
            self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ---- read -----------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None, *,
                device: torch.device | str | None = None, shardings: Any = None,
                mesh: Any = None) -> tuple[Any, dict]:
        """Rebuild ``template``-shaped state, each leaf on ``device`` or, by
        default, on the device of the template's leaf at its path.

        ``shardings`` (a tree of ``runtime/sharding.py`` specs parallel to
        ``template``, with the ``mesh`` they refer to): each rank keeps only
        its tile of every saved (full) leaf, so a save from one mesh
        restores onto another (the reference's elastic restart)."""
        if (shardings is None) != (mesh is None):
            raise ValueError("restore takes shardings and mesh together")
        specs = {}
        if shardings is not None:
            from repro_torch.runtime.sharding import flatten_specs, shard_slices

            specs = flatten_specs(shardings)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {leaf["path"]: leaf for leaf in manifest["leaves"]}
        with np.load(os.path.join(path, "arrays.npz")) as data:

            def load(p: str, tmpl: Any) -> torch.Tensor:
                if p not in leaves:
                    raise KeyError(f"checkpoint missing leaf {p!r}")
                leaf = leaves[p]
                dev = torch.device(device) if device is not None else (
                    tmpl.device if isinstance(tmpl, torch.Tensor) else torch.device("cpu"))
                arr = data[f"a{leaf['index']}"]
                if specs:  # the tile (a scalar, the step, stays 0-d)
                    arr = np.array(arr[shard_slices(specs[p], arr.shape, mesh)], order="C")
                return _from_numpy(arr, leaf["dtype"], dev)

            state = tree_map_with_paths(load, template)
        return state, manifest["meta"]
