"""Shared-memory slot ring: the zero-copy payload store.

One ``multiprocessing.shared_memory`` segment per mounted topic, split
into fixed-size slots. The segment is self-describing — a small header
carries the geometry, and a per-slot metadata table (epoch, length)
lives in shared memory — so any process can ``attach()`` by name and
validate a slot handle without talking to the broker host.

Epoch protocol: a slot's epoch starts at 0 (free) and is bumped on every
state change — odd while a frame lives in it, even when reclaimed. A
handle carries the odd epoch it was written under; any later read
compares against the table and raises :class:`SlotReclaimedError` on
mismatch instead of returning silently-recycled bytes.

Allocation, reference counts, and the free list are host-side (the
broker owns the segment; only *reads* cross process boundaries).
``alloc`` stalling on a full ring IS the data-plane backpressure: the
accumulated ``stall_seconds`` feeds ``BrokerCluster.io_stall_seconds``
next to the token buckets, so the broker saturation probe — and with it
broker elasticity — sees ring pressure exactly like NIC pressure.
"""
from __future__ import annotations

import shutil
import struct
import threading
import time
import uuid
import weakref
from collections import deque
from multiprocessing import resource_tracker, shared_memory

import numpy as np

_MAGIC = b"RRG1"
_HEADER = struct.Struct("<4sIQ")  # magic, n_slots, slot_bytes
_META_OFF = 64  # header padded to a cache line
_ALIGN = 64


class SlotReclaimedError(RuntimeError):
    """A slot handle outlived its slot: the epoch in the shared table no
    longer matches the handle's. The view (or copy) must not be trusted."""


class RingTimeout(RuntimeError):
    """``alloc`` stalled past its deadline — the ring stayed full."""


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


#: the tmpfs that holds POSIX shared-memory segments on Linux
SHM_DIR = "/dev/shm"


def check_shm_space(slot_bytes: int, n_slots: int) -> None:
    """Refuse a ring that ``/dev/shm`` cannot hold. Segments live in that
    tmpfs, and a write past its size kills the writer with SIGBUS instead
    of raising — so the space is checked before the segment is made, and
    nothing is shrunk to fit."""
    try:
        free = shutil.disk_usage(SHM_DIR).free
    except OSError:  # no such tmpfs (not Linux): the OS backs segments itself
        return
    need = slot_bytes * n_slots
    if need > free:
        raise RuntimeError(
            f"shared-memory ring of {n_slots} slots x {slot_bytes} B = {need} B "
            f"does not fit in {SHM_DIR}: {free} B free")


#: name -> ring, so consumers in the broker host reuse the creator's
#: object (free-list authority) and forked workers attach once per name
_RINGS: "weakref.WeakValueDictionary[str, SharedMemoryRing]" = weakref.WeakValueDictionary()
_RINGS_LOCK = threading.Lock()


def get_ring(name: str) -> "SharedMemoryRing":
    """Resolve a ring by segment name: the in-process instance when this
    process created (or already attached) it, else a fresh attach."""
    with _RINGS_LOCK:
        ring = _RINGS.get(name)
        if ring is not None:
            return ring
    ring = SharedMemoryRing.attach(name)
    return ring


class SharedMemoryRing:
    """Fixed-slot shared-memory ring with epoch-tagged reclaim."""

    def __init__(self, *, slot_bytes: int = 1 << 20, n_slots: int = 64,
                 name: str | None = None):
        if slot_bytes <= 0 or n_slots <= 0:
            raise ValueError("slot_bytes and n_slots must be positive")
        self.slot_bytes = int(slot_bytes)
        self.n_slots = int(n_slots)
        check_shm_space(self.slot_bytes, self.n_slots)
        self._data_off = _align(_META_OFF + self.n_slots * 16)
        size = self._data_off + self.n_slots * self.slot_bytes
        self.name = name or f"rring-{uuid.uuid4().hex[:12]}"
        self._shm = shared_memory.SharedMemory(self.name, create=True, size=size)
        self._owner = True
        self._shm.buf[:_HEADER.size] = _HEADER.pack(_MAGIC, self.n_slots, self.slot_bytes)
        self._init_views()
        self._meta[:] = 0
        # pre-fault the data region (one write per page): first-touch page
        # allocation costs ~7x bandwidth, and paying it at mount time keeps
        # the first pass over the ring as fast as the steady state
        self._bytes_np[self._data_off::4096] = 0
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._free: deque[int] = deque(range(self.n_slots))
        self._refs: dict[int, int] = {}
        self._pending_release: set[int] = set()
        #: cumulative seconds alloc callers spent blocked on a full ring —
        #: the data-plane backpressure signal (see module docstring)
        self.stall_seconds = 0.0
        self.alloc_count = 0
        self.reclaim_count = 0
        with _RINGS_LOCK:
            _RINGS[self.name] = self

    def _init_views(self) -> None:
        self._meta = np.frombuffer(
            self._shm.buf, dtype=np.uint64, count=self.n_slots * 2, offset=_META_OFF
        ).reshape(self.n_slots, 2)  # columns: epoch, length
        # byte view over the whole segment: numpy bulk assignment copies at
        # memcpy speed, where memoryview slice-assign of cast views doesn't
        self._bytes_np = np.frombuffer(self._shm.buf, dtype=np.uint8)

    # ---- attach (other processes / late joiners) ---------------------------

    @classmethod
    def attach(cls, name: str) -> "SharedMemoryRing":
        shm = shared_memory.SharedMemory(name)
        # the creator's resource tracker owns the segment; unregister this
        # process's handle so a reader exiting doesn't unlink (or warn
        # about) a segment it never owned
        try:  # pragma: no cover - tracker internals vary across versions
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        magic, n_slots, slot_bytes = _HEADER.unpack_from(shm.buf, 0)
        if magic != _MAGIC:
            shm.close()
            raise ValueError(f"{name!r} is not a repro transport ring")
        ring = cls.__new__(cls)
        ring.slot_bytes = slot_bytes
        ring.n_slots = n_slots
        ring._data_off = _align(_META_OFF + n_slots * 16)
        ring.name = name
        ring._shm = shm
        ring._owner = False
        ring._init_views()
        ring._lock = threading.Lock()
        ring._space = threading.Condition(ring._lock)
        ring._free = deque()
        ring._refs = {}
        ring._pending_release = set()
        ring.stall_seconds = 0.0
        ring.alloc_count = 0
        ring.reclaim_count = 0
        with _RINGS_LOCK:
            _RINGS.setdefault(name, ring)
        return ring

    # ---- producer side (owner only) ----------------------------------------

    def alloc(self, *, deadline: float | None = None,
              reclaim_hook=None) -> tuple[int, int]:
        """Claim a free slot, returning ``(slot, epoch)`` with the epoch
        already bumped to its live (odd) value. A full ring stalls —
        accumulating ``stall_seconds`` — until a release or the deadline;
        ``reclaim_hook`` (if given) is invoked once before the first wait so
        the plane can release consumed slots lazily."""
        hooked = False
        with self._space:
            while not self._free:
                if reclaim_hook is not None and not hooked:
                    hooked = True
                    self._lock.release()
                    try:
                        reclaim_hook()
                    finally:
                        self._lock.acquire()
                    continue
                t0 = time.monotonic()
                if deadline is not None and t0 >= deadline:
                    raise RingTimeout(
                        f"ring {self.name}: no free slot before deadline "
                        f"({self.n_slots} slots, all retained)")
                wait = 0.05 if deadline is None else min(0.05, max(deadline - t0, 0.001))
                self._space.wait(timeout=wait)
                self.stall_seconds += time.monotonic() - t0
            slot = self._free.popleft()
            epoch = int(self._meta[slot, 0]) + 1
            if epoch % 2 == 0:  # was mid-bump? never happens, keep odd invariant
                epoch += 1
            self._meta[slot, 0] = epoch
            self._meta[slot, 1] = 0
            self.alloc_count += 1
            return slot, epoch

    def write(self, slot: int, epoch: int, parts) -> int:
        """Copy ``parts`` (buffer-protocol objects) contiguously into the
        slot — the single unavoidable copy into shared memory — and publish
        the total length. Raises ValueError when the frame exceeds the slot
        (callers fall back to the inline copy-out path)."""
        total = sum(len(p) for p in parts)
        if total > self.slot_bytes:
            raise ValueError(
                f"frame of {total}B exceeds slot size {self.slot_bytes}B")
        # raw memoryview slice-assign memcpys contiguous 1-D "B" parts
        # (~3x the throughput of routing each part through numpy)
        buf = self._shm.buf
        off = self._data_off + slot * self.slot_bytes
        for p in parts:
            n = len(p)
            buf[off:off + n] = p
            off += n
        self._meta[slot, 1] = total
        return total

    def release(self, slot: int, epoch: int) -> None:
        """Producer/control-plane release: the slot is reclaimed (epoch
        bumped to even, slot back on the free list) once no reader holds a
        reference; with readers outstanding, reclaim is deferred until the
        last ``release_ref``. Stale epochs are ignored (already recycled)."""
        with self._space:
            self._release_locked(slot, epoch)

    def _release_locked(self, slot: int, epoch: int) -> None:
        if int(self._meta[slot, 0]) != epoch:
            return
        if self._refs.get(slot, 0) > 0:
            self._pending_release.add(slot)
            return
        self._meta[slot, 0] = epoch + 1
        self._pending_release.discard(slot)
        self._free.append(slot)
        self.reclaim_count += 1
        self._space.notify_all()

    # ---- reader side (any process) ------------------------------------------

    def retain(self, slot: int, epoch: int) -> bool:
        """Pin a live slot against reclaim; False if already reclaimed."""
        with self._lock:
            if int(self._meta[slot, 0]) != epoch:
                return False
            self._refs[slot] = self._refs.get(slot, 0) + 1
            return True

    def release_ref(self, slot: int, epoch: int) -> None:
        with self._space:
            refs = self._refs.get(slot, 0)
            if refs <= 1:
                self._refs.pop(slot, None)
                if slot in self._pending_release:
                    self._release_locked(slot, epoch)
            else:
                self._refs[slot] = refs - 1

    def is_valid(self, slot: int, epoch: int) -> bool:
        return 0 <= slot < self.n_slots and int(self._meta[slot, 0]) == epoch

    def view(self, slot: int, epoch: int) -> memoryview:
        """Zero-copy view of the slot's frame bytes. Epoch-checked on
        entry; re-check (``is_valid``) after consuming the view — detection,
        not prevention, is the contract for readers that raced a reclaim."""
        if not self.is_valid(slot, epoch):
            raise SlotReclaimedError(
                f"ring {self.name} slot {slot}: epoch {epoch} reclaimed "
                f"(now {int(self._meta[slot, 0])})")
        length = int(self._meta[slot, 1])
        base = self._data_off + slot * self.slot_bytes
        return self._shm.buf[base:base + length]

    # ---- introspection / lifecycle ------------------------------------------

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_slots(self) -> int:
        return self.n_slots - self.free_slots

    def close(self) -> None:
        """Unmap this process's view. Outstanding zero-copy numpy views pin
        the mapping — close then fails quietly and the OS reclaims at
        process exit (unlink below is what frees the name)."""
        self._meta = None
        self._bytes_np = None
        try:
            self._shm.close()
        except BufferError:  # a consumer still holds a frombuffer view
            pass

    def unlink(self) -> None:
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover - already gone
                pass

    def destroy(self) -> None:
        self.close()
        self.unlink()
