"""StateMigrator — rescale-safe hand-off of state partitions.

The migration lifecycle the continuous engine drives on every grow/shrink
(the caller quiesces first — ``ContinuousStream.rescale`` holds its state
lock and runs the ``sync_fn`` barrier before calling in):

1. **plan**: diff the store's current partition -> owner assignment against
   the range assignment over the new owner set; only the diff moves.
2. **snapshot**: serialize each moved partition and spool the lot to disk
   in one atomic directory (the checkpoint manager's tmp+rename commit —
   a crash mid-migration leaves the previous spool, never a torn one).
3. **reassign**: install the new assignment.
4. **restore**: read every spooled partition back and deserialize it into
   the store — moved state always takes the full serde round trip a real
   cross-host hand-off would take, which is what lets the property suite
   prove no buffer is lost, duplicated, or reordered.

Gauges (published when a bus is attached): ``state.migrated_partitions``,
``state.migration_ms``, ``state.bytes_moved`` — labeled with the owning
stream so multi-stage pipelines don't mix them.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

from repro_torch.checkpoint.manager import atomic_dir
from repro_torch.state.partition import LOCAL_OWNER, moved_partitions, range_assignment
from repro_torch.state.store import (
    PartitionedStateStore,
    deserialize_partition,
    serialize_partition,
)


@dataclass(frozen=True)
class MigrationReport:
    """What one rescale actually moved."""

    seq: int
    from_owners: tuple
    to_owners: tuple
    moved: tuple[int, ...]  # partition ids that changed owner
    n_partitions: int
    bytes_moved: int
    buffered_records_moved: int
    duration_ms: float
    spool_path: str = ""

    @property
    def moved_fraction(self) -> float:
        return len(self.moved) / self.n_partitions if self.n_partitions else 0.0


@dataclass
class StateMigrator:
    """One migrator per stream; keeps a bounded spool directory and the
    history of reports (newest last)."""

    directory: str | None = None
    bus: Any = None  # repro_torch.elastic.MetricsBus | None
    label: str | None = None
    keep_last: int = 2  # spools retained for post-mortems
    reports: list[MigrationReport] = field(default_factory=list)
    _seq: int = 0

    _owns_dir: bool = False

    def _spool_root(self) -> str:
        if self.directory is None:
            self.directory = tempfile.mkdtemp(prefix="repro-torch-state-migrations-")
            self._owns_dir = True
        else:
            os.makedirs(self.directory, exist_ok=True)
        return self.directory

    def cleanup(self) -> None:
        """Remove the spool directory if this migrator created it (a
        caller-provided ``directory`` is left alone). Safe to call
        repeatedly; a later migrate() just spools afresh."""
        if self._owns_dir and self.directory is not None:
            shutil.rmtree(self.directory, ignore_errors=True)
            self.directory = None
            self._owns_dir = False

    def plan(self, store: PartitionedStateStore,
             new_owners: Sequence[Any]) -> tuple[dict[int, Any], list[int]]:
        """The new assignment and the partitions a migration would move."""
        owners = list(new_owners) or [LOCAL_OWNER]
        new = range_assignment(store.n_partitions, owners)
        return new, moved_partitions(store.assignment, new)

    def migrate(self, store: PartitionedStateStore,
                new_owners: Sequence[Any]) -> MigrationReport:
        """Quiesced-caller contract: the store must not be mutated while
        this runs (ContinuousStream holds its state lock around the call).

        The in-process special case of :meth:`handoff`: fetch serializes
        straight out of the store, install deserializes straight back in.
        """

        def fetch(pids: Sequence[int]) -> dict[int, bytes]:
            return {pid: serialize_partition(store.partitions[pid]) for pid in pids}

        def install(assignment: dict[int, Any],
                    payloads: Mapping[int, bytes]) -> int:
            store.assignment = assignment
            moved_records = 0
            for pid, data in payloads.items():
                part = deserialize_partition(data)
                assert part.pid == pid
                store.partitions[pid] = part
                moved_records += part.buffered_records
            return moved_records

        return self.handoff(store, new_owners, fetch, install)

    def handoff(self, store: PartitionedStateStore, new_owners: Sequence[Any],
                fetch: Callable[[Sequence[int]], dict[int, bytes]],
                install: Callable[[dict[int, Any], Mapping[int, bytes]], int],
                ) -> MigrationReport:
        """The migration lifecycle with pluggable endpoints — what lets the
        same quiesce -> snapshot -> spool -> reassign -> restore path move
        partitions *between worker processes* (the mp executor) as well as
        within the host store.

        ``fetch(pids)`` pulls the serialized bytes of each moved partition
        from wherever it currently lives (and releases it there);
        ``install(assignment, payloads)`` makes the new assignment live and
        delivers the spooled bytes to each partition's new home, returning
        the number of buffered records moved. Moved state always takes the
        full serialize -> spool -> read-back trip, regardless of endpoint.
        """
        t0 = time.perf_counter()
        from_owners = tuple(store.owners)
        new, moved = self.plan(store, new_owners)
        seq = self._seq
        self._seq += 1

        payloads = fetch(moved)
        spool = ""
        if payloads:
            spool = self.write_spool(payloads, f"migration_{seq:06d}")

        # deliver from the spool (not from the in-memory payloads): moved
        # state must survive the full serde + disk round trip
        restored = self.read_spool(spool, moved) if payloads else {}
        moved_records = install(new, restored)

        self._gc_spools("migration_")
        report = MigrationReport(
            seq=seq,
            from_owners=from_owners,
            to_owners=tuple(list(new_owners) or [LOCAL_OWNER]),
            moved=tuple(moved),
            n_partitions=store.n_partitions,
            bytes_moved=sum(len(d) for d in payloads.values()),
            buffered_records_moved=moved_records,
            duration_ms=(time.perf_counter() - t0) * 1e3,
            spool_path=spool,
        )
        self.reports.append(report)
        if self.bus is not None:
            labels = {} if self.label is None else {"stream": self.label}
            self.bus.publish("state.migrated_partitions", len(moved), **labels)
            self.bus.publish("state.migration_ms", report.duration_ms, **labels)
            self.bus.publish("state.bytes_moved", report.bytes_moved, **labels)
        return report

    # -- spool primitives (shared with the worker runtime's checkpoints) -------

    def write_spool(self, payloads: Mapping[int, bytes], name: str,
                    *, meta: bytes | None = None) -> str:
        """Atomically write one ``pid -> serialized partition`` set under
        ``name`` in the spool root; returns the committed path. Used for
        migration spools and for the worker runtime's periodic restart
        checkpoints (``wckpt_*``). ``meta`` rides along as a sidecar blob
        (``meta.bin`` — outside the partition namespace) for stream-global
        state a checkpoint must carry: consumer positions, watermark,
        counters (ContinuousStream's ``sckpt_*`` crash checkpoints)."""
        spool = os.path.join(self._spool_root(), name)
        with atomic_dir(spool) as tmp:
            for pid, data in payloads.items():
                with open(os.path.join(tmp, f"p{pid:05d}.bin"), "wb") as f:
                    f.write(data)
            if meta is not None:
                with open(os.path.join(tmp, "meta.bin"), "wb") as f:
                    f.write(meta)
        return spool

    def read_meta(self, spool: str) -> bytes | None:
        """The sidecar meta blob of a committed spool (None if absent)."""
        path = os.path.join(spool, "meta.bin")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def latest_spool(self, prefix: str) -> str | None:
        """Path of the newest committed spool with ``prefix`` (crash
        recovery entry point: sequence-numbered names sort temporally)."""
        if self.directory is None or not os.path.isdir(self.directory):
            return None
        spools = sorted(
            n for n in os.listdir(self.directory)
            if n.startswith(prefix) and not n.endswith(".tmp")
        )
        if not spools:
            return None
        return os.path.join(self.directory, spools[-1])

    def read_spool(self, spool: str,
                   pids: Sequence[int] | None = None) -> dict[int, bytes]:
        """Read back serialized partitions from a committed spool directory
        (all of them, or just ``pids``)."""
        if pids is None:
            pids = sorted(
                int(n[1:-4]) for n in os.listdir(spool)
                if n.startswith("p") and n.endswith(".bin")
            )
        out: dict[int, bytes] = {}
        for pid in pids:
            path = os.path.join(spool, f"p{pid:05d}.bin")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    out[pid] = f.read()
        return out

    def _gc_spools(self, prefix: str) -> None:
        if self.directory is None or not os.path.isdir(self.directory):
            return
        spools = sorted(
            n for n in os.listdir(self.directory)
            if n.startswith(prefix) and not n.endswith(".tmp")
        )
        for name in spools[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def gc_checkpoints(self) -> None:
        """Bound the worker-checkpoint spools like migration spools."""
        self._gc_spools("wckpt_")
