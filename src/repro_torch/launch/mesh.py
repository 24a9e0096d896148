"""Device meshes over ``torch.distributed``: one process per rank.

Own counterpart of the JAX package's ``launch/mesh.py``. JAX's single
controller (one process, ``shard_map`` over a device mesh) becomes torch's
multi-controller model: every rank is a process, the mesh is a row-major
grid of the ranks of one process group, and each axis (and each tuple of
axes a collective reduces over, ``("pod", "data")``) has a subgroup. Rank r
sits at the coordinates of r in the grid, so the ranks of a subgroup in
ascending order are its members in row-major order over its axes: a tiled
all-gather over ``("pod", "data")`` concatenates in the reference's order.

:class:`Mesh` carries ``.shape`` (an ordered dict, axis name -> size: all the
sharding rules read), :meth:`Mesh.axis_index`, the subgroups, ``device`` and
``backend``. The backend is fixed when the mesh is built:

* ``nccl``: device tensors go straight into the collectives (one card a
  rank; NCCL refuses two ranks on one device);
* ``gloo``: collectives run on host tensors, so CUDA tensors are staged
  through host memory for each collective (``staged``) while the compute
  stays on the card; CPU tensors go straight in.

:func:`make_production_mesh` returns the reference's (16, 16) and
(2, 16, 16) shapes as a :class:`MeshShape` for rule arithmetic; it needs no
process group.

:class:`RankGroup` keeps a group of spawned ranks up between commands (the
streaming train app's group, ``miniapps/masa.py``): each rank builds its
mesh once, then runs one command at a time, in order, and answers it;
:class:`MeshSpec` names such a group's shape and one device a rank, and
a :class:`RankPool` keeps the processes for the next group.
"""
from __future__ import annotations

import itertools
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch
import torch.distributed as dist


@dataclass
class MeshShape:
    """Axis sizes only: what :class:`~repro_torch.runtime.sharding.ShardingRules`
    reads (the reference tests' ``FakeMesh``)."""

    shape: dict


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: 16 x 16 ("data", "model"). Multi-pod: 2 x 16 x 16
    ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


@dataclass
class Mesh:
    """A row-major grid of the ranks of the default process group."""

    shape: dict
    rank: int
    device: torch.device
    backend: str
    groups: dict = field(default_factory=dict, repr=False)  # axes -> (group, ranks)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def staged(self) -> bool:
        """True where a collective copies device tensors through host memory."""
        return self.backend == "gloo" and self.device.type != "cpu"

    def coords(self, rank: int | None = None) -> dict:
        r = self.rank if rank is None else rank
        out = {}
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {n: out[n] for n in self.axis_names}

    def axis_index(self, axes: str | Sequence[str]) -> int:
        """This rank's index along ``axes`` (row-major over a tuple)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords()[a]
        return idx

    def axis_size(self, axes: str | Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def group(self, axes: str | Sequence[str]):
        """(process group, its global ranks in row-major order over
        ``axes``) of the subgroup holding this rank."""
        key = self._key(axes)
        if key not in self.groups:
            raise KeyError(f"mesh {self.shape} has no subgroup over {key}")
        return self.groups[key]

    def _key(self, axes) -> tuple[str, ...]:
        a = _axes(axes)
        return tuple(n for n in self.axis_names if n in a)


def _axes(axes: str | Sequence[str]) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _rank_of(shape: dict, coords: dict) -> int:
    r = 0
    for n in shape:
        r = r * shape[n] + coords[n]
    return r


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: torch.device | str) -> Mesh:
    """The mesh of ``shape`` over the default process group, whose world
    size must be the product of ``shape``. Every rank calls this with the
    same arguments (it creates one subgroup per axis tuple, collectively).
    The backend is the process group's."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} differ in length")
    sizes = dict(zip(axes, (int(s) for s in shape)))
    world = dist.get_world_size()
    if math.prod(sizes.values()) != world:
        raise ValueError(f"mesh {sizes} holds {math.prod(sizes.values())} ranks, "
                         f"the process group {world}")
    mesh = Mesh(shape=sizes, rank=dist.get_rank(), device=torch.device(device),
                backend=dist.get_backend())
    names = tuple(sizes)
    # every non-empty tuple of axes, in mesh order; for each, one subgroup
    # per setting of the other axes (all ranks create all of them, in order)
    for n in range(1, len(names) + 1):
        for sub in itertools.combinations(names, n):
            rest = [a for a in names if a not in sub]
            for fixed in itertools.product(*(range(sizes[a]) for a in rest)):
                base = dict(zip(rest, fixed))
                ranks = [_rank_of(sizes, {**base, **dict(zip(sub, c))})
                         for c in itertools.product(*(range(sizes[a]) for a in sub))]
                ranks = sorted(ranks)
                group = dist.new_group(ranks=ranks) if world > 1 else dist.group.WORLD
                if mesh.rank in ranks:
                    mesh.groups[sub] = (group, ranks)
    return mesh


def make_local_mesh(n_model: int = 1, n_data: int | None = None, *,
                    device: torch.device | str) -> Mesh:
    """("data", "model") mesh over the whole process group."""
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_model
    return make_mesh((n_data, n_model), ("data", "model"), device=device)


# ---------------------------------------------------------------------------
# a rank group of spawned processes
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, backend: str, init_method: str, threads: int,
               args: tuple, results) -> None:
    import traceback

    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        try:
            out = fn(rank, *args)
        except BaseException as exc:  # reported before the group goes (the others fail on it)
            results.put((rank, False, f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"))
            return
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException as exc:  # reported to the parent, which raises
        results.put((rank, False, f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"))


def spawn_ranks(fn, world: int, *, init_method: str, backend: str = "gloo", args: tuple = (),
                timeout: float = 120.0, threads: int = 1) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes, each a rank of
    one process group (``init_method``: a ``file://`` path or a
    ``tcp://localhost:port``); return the ranks' results in rank order.
    ``fn`` must be importable by name and its result picklable. Raises if a
    rank raises or the group does not finish within ``timeout`` seconds;
    every process is stopped before it returns."""
    import multiprocessing as mp
    import queue
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, init_method, threads, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"rank group of {world} did not finish in {timeout} s "
                                   f"(done: {sorted(out)})")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}: {val}")
                break
        # the ranks a failed rank's exit disconnects report too: keep every
        # report that comes within a few seconds, so the first cause shows
        settle = time.monotonic() + 5.0
        while errors and len(out) + len(errors) < world and time.monotonic() < settle:
            try:
                rank, ok, val = results.get(timeout=0.5)
            except queue.Empty:
                continue
            if not ok:
                errors.append(f"rank {rank}: {val}")
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# a long-lived rank group: ranks that stay up between commands
# ---------------------------------------------------------------------------


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; an unindexed ``cuda`` is card 0."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


@dataclass(frozen=True)
class MeshSpec:
    """A rank group's ("data", "model") mesh: its ``shape`` (row-major, as
    :func:`make_mesh` lays it out) and one device a rank, in rank order.
    ``LMTrainApp(mesh=...)`` takes it where the reference takes a JAX mesh."""

    shape: tuple
    devices: tuple
    axes = ("data", "model")

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "devices", tuple(_device(d) for d in self.devices))
        if len(self.shape) != len(self.axes):
            raise ValueError(f"a mesh over {self.axes} has {len(self.axes)} dims, not "
                             f"{self.shape}")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh {self.shape} holds {math.prod(self.shape)} ranks; "
                             f"{len(self.devices)} devices given")

    @property
    def backend(self) -> str:
        """``nccl`` where every device is a distinct CUDA card, ``gloo``
        otherwise (repeats of one card, whose collectives are staged
        through host memory: NCCL refuses two ranks on one card; CPU
        tensors as they are)."""
        distinct = len(set(self.devices)) == len(self.devices)
        return "nccl" if distinct and all(d.type == "cuda" for d in self.devices) else "gloo"


def shared_host_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied into shared host memory: a rank it is sent to (through
    a ``multiprocessing`` queue) maps it instead of reading it through a
    pipe."""
    out = torch.empty(x.shape, dtype=x.dtype).share_memory_()
    out.copy_(x)
    return out


#: the answer a rank gives when it has left its group (``RankGroup.stop``)
_LEFT = -1
#: seconds a rank group waits for an answer before it fails
COMMAND_TIMEOUT_S = 120.0


def _rank_worker(device: torch.device, inbox, replies) -> None:
    """A process of a :class:`RankPool`: serve one rank group after another
    (each a ``join`` message from ``inbox``) until ``None`` comes; end where
    a group's command raises. One thread: a rank's work is its device's,
    and CPU ranks side by side would only compete for the cores."""
    torch.set_num_threads(1)
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.forbid_builds()  # the parent built them: a rank only loads
        torch.cuda.set_device(device)
    while (join := inbox.get()) is not None:
        if not _serve(device, join, inbox, replies):
            return


def _serve(device: torch.device, join: tuple, inbox, replies) -> bool:
    """One rank of one group: join its process group, build the mesh and
    the handler ``setup(mesh, *args)``, report ready (command 0), then run
    each command ``(name, args)`` from ``inbox`` as ``handler.name(*args)``
    and put ``(key, rank, seq, ok, result or error)`` on ``replies``, until
    ``None`` (leave: the process group and the handler go, the card's
    cached blocks are freed, ``_LEFT`` answers). False where a step raised."""
    import datetime
    import gc
    import traceback

    key, spec, rank, init_method, timeout, setup, args = join
    seq, handler = 0, None
    try:
        dist.init_process_group(spec.backend, init_method=init_method,
                                world_size=len(spec.devices), rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        handler = setup(make_mesh(spec.shape, spec.axes, device=device), *args)
        replies.put((key, rank, 0, True, None))
        while (msg := inbox.get()) is not None:
            seq += 1
            name, cargs = msg
            replies.put((key, rank, seq, True, getattr(handler, name)(*cargs)))
    except Exception as exc:  # reported to the parent, which fails the group
        replies.put((key, rank, seq, False,
                     f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"))
        return False
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    del handler
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    replies.put((key, rank, _LEFT, True, None))
    return True


@dataclass(eq=False)
class _Worker:
    device: torch.device
    process: Any
    inbox: Any


class RankPool:
    """Spawned rank processes kept between rank groups: a group takes an
    idle process of each of its devices (spawning the missing ones, side
    by side) and, stopped cleanly, gives them back, each having left its
    process group and dropped its state. A process pays ``import torch``
    and its first step's one-time costs once, not at every rescale. A
    process of a failed group is killed, never reused. The processes are
    spawned, never forked (a parent may have initialised CUDA). ``close()``
    ends them all."""

    def __init__(self):
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self.replies = self._ctx.Queue()
        self._idle: list[_Worker] = []
        self._workers: list[_Worker] = []

    def take(self, devices: Sequence) -> tuple[list[_Worker], int]:
        """One process a device, idle ones first: (the processes in the
        order of ``devices``, how many were spawned)."""
        out, spawned = [], 0
        for d in devices:
            w = next((w for w in self._idle if w.device == d and w.process.is_alive()), None)
            if w is None:
                inbox = self._ctx.Queue()
                w = _Worker(d, self._ctx.Process(target=_rank_worker, daemon=True,
                                                 args=(d, inbox, self.replies)), inbox)
                w.process.start()
                self._workers.append(w)
                spawned += 1
            else:
                self._idle.remove(w)
            out.append(w)
        return out, spawned

    def give_back(self, workers: list) -> None:
        self._idle.extend(workers)

    def discard(self, workers: list) -> None:
        """Kill ``workers`` (a failed group's: they may hang in a collective)."""
        for w in workers:
            if w.process.is_alive():
                w.process.kill()
            w.process.join()
            w.inbox.cancel_join_thread()
            w.inbox.close()
            self._workers.remove(w)
            if w in self._idle:
                self._idle.remove(w)

    def close(self) -> None:
        """End every process (idle ones exit, the rest are killed)."""
        import queue
        import time

        for w in self._idle:
            w.inbox.put(None)
        deadline = time.monotonic() + 10.0
        while any(w.process.is_alive() for w in self._idle) and time.monotonic() < deadline:
            try:  # drained: a process exits only once its answers are flushed
                self.replies.get(timeout=0.1)
            except queue.Empty:
                pass
        self.discard(list(self._workers))
        self.replies.cancel_join_thread()
        self.replies.close()


class Reply:
    """The answers of a :class:`RankGroup`'s ranks to one command.
    :meth:`synchronize` waits for them (a reply stands where a CUDA event
    would in ``streaming/dispatch.py``'s window of in-flight work);
    :meth:`result` is the list of answers in rank order."""

    def __init__(self, group: "RankGroup", seq: int, name: str):
        self.seq, self.name = seq, name
        self._group = group
        self._got: dict = {}
        self._values: list | None = None

    def synchronize(self) -> None:
        if self._values is None:
            self._group._collect(self)

    def result(self) -> list:
        self.synchronize()
        return self._values


class RankGroup:
    """A process group over ``spec``'s devices, one rank a device, whose
    ranks stay up between commands.

    The ranks are processes of ``pool``, taken idle where one of the
    device is, else spawned, all side by side. They join a fresh ``file://`` rendezvous in
    a temporary directory of the group's own (a group never reuses a gone
    group's store) and build the mesh and the handler ``setup(mesh,
    *args)`` (``setup`` importable by name, ``args`` picklable). Where a
    device is a CUDA card the parent builds every kernel library first (one
    ``nvcc`` a source, in parallel), and the ranks only load them.

    :meth:`submit` sends one command, ``handler.<name>(*args)`` in every
    rank, and returns its :class:`Reply` at once; the ranks run commands one
    at a time, in order. :meth:`call` waits for the answers. A rank that
    raises or dies fails the group: the wait in progress, or else the next
    command, raises within COMMAND_TIMEOUT_S, naming the rank, its device
    and its error or exit code, and so does every later command: the group
    never goes on with fewer ranks. :meth:`stop` ends the group.
    ``start_seconds``: from taking the processes to every rank ready;
    ``spawned``: the processes spawned for it."""

    def __init__(self, spec: MeshSpec, setup, args: tuple, pool: RankPool):
        import tempfile
        import time

        if any(d.type == "cuda" for d in spec.devices):
            from repro_torch.kernels import build_all

            build_all()
        self.spec, self.timeout = spec, COMMAND_TIMEOUT_S
        self._pool = pool
        self._dir = tempfile.mkdtemp(prefix="rank-group-")
        self._send, self._recv = threading.Lock(), threading.Lock()
        self._waiting: dict[int, Reply] = {}
        self._seq = 0
        self._error: str | None = None
        self._stopped = False
        ready = self._waiting[0] = Reply(self, 0, "start")
        t0 = time.perf_counter()
        self._workers, self.spawned = self._pool.take(spec.devices)
        for rank, w in enumerate(self._workers):
            w.inbox.put((self._dir, spec, rank, f"file://{self._dir}/store", self.timeout,
                         setup, tuple(args)))
        try:
            ready.synchronize()
        except BaseException:
            self.stop()
            raise
        self.start_seconds = time.perf_counter() - t0

    @property
    def size(self) -> int:
        return len(self._workers)

    @property
    def processes(self) -> list:
        return [w.process for w in self._workers]

    @property
    def error(self) -> str | None:
        """What failed the group, or None while it is sound."""
        return self._error

    def submit(self, name: str, *args: Any) -> Reply:
        """Send ``handler.<name>(*args)`` to every rank; its reply, unwaited."""
        with self._send:
            self._check()
            self._seq += 1
            reply = self._waiting[self._seq] = Reply(self, self._seq, name)
            for w in self._workers:
                w.inbox.put((name, args))
        return reply

    def call(self, name: str, *args: Any) -> list:
        """:meth:`submit`, then every rank's answer in rank order."""
        return self.submit(name, *args).result()

    def _check(self) -> None:
        """Raise where the group has stopped or failed, or a rank has exited."""
        if self._stopped:
            raise RuntimeError(f"the rank group {self.spec.shape} has stopped")
        if self._error is None and any(p.exitcode is not None for p in self.processes):
            self._fail({})
        if self._error is not None:
            raise RuntimeError(self._error)

    def _next(self, timeout: float):
        """The next answer to this group within ``timeout`` seconds (another
        group's, a failed one's left in the queue, is dropped), or None."""
        import queue
        import time

        deadline = time.monotonic() + timeout
        while (left := deadline - time.monotonic()) > 0:
            try:
                key, *answer = self._pool.replies.get(timeout=min(left, 0.2))
            except queue.Empty:
                return None
            if key == self._dir:
                return answer
        return None

    def _collect(self, reply: Reply) -> None:
        """Read the ranks' answers, to any command, as they come, until
        ``reply`` has all of its own; raise where the group fails."""
        import time

        deadline = time.monotonic() + self.timeout
        with self._recv:
            while reply._values is None:
                self._check()
                left = deadline - time.monotonic()
                if left <= 0:
                    self._fail({}, f"no answer to command {reply.seq} ({reply.name}) from "
                                   f"ranks {sorted(set(range(self.size)) - set(reply._got))} "
                                   f"within {self.timeout} s")
                answer = self._next(min(left, 0.2))
                if answer is None:
                    continue
                rank, seq, ok, value = answer
                if not ok:
                    self._fail({rank: f"raised in command {seq}: {value}"})
                waiting = self._waiting[seq]
                waiting._got[rank] = value
                if len(waiting._got) == self.size:
                    waiting._values = [waiting._got.pop(r) for r in range(self.size)]
                    del self._waiting[seq]

    def _fail(self, errors: dict, cause: str | None = None) -> None:
        """Fail the group and raise: what the ranks report within a few
        seconds (the others' errors often follow the first cause), and the
        ranks that exited without a report."""
        import time

        settle = time.monotonic() + 2.0
        while (left := settle - time.monotonic()) > 0:
            answer = self._next(left)
            if answer is not None and not answer[2]:
                rank, seq, _, value = answer
                errors.setdefault(rank, f"raised in command {seq}: {value}")
        lines = [cause] if cause else []
        for r, p in enumerate(self.processes):
            device = self.spec.devices[r]
            if r in errors:
                lines.append(f"rank {r} ({device}) {errors[r]}")
            elif p.exitcode is not None:
                lines.append(f"rank {r} ({device}) died (exit code {p.exitcode})")
        self._error = f"rank group {self.spec.shape} ({self.spec.backend}) failed:\n" + "\n".join(
            lines)
        raise RuntimeError(self._error)

    def stop(self) -> None:
        """End the group: where it is sound each rank leaves its process
        group and drops its handler, and goes back to the pool; a failed
        group's, or one that does not leave in time, are killed. Idempotent."""
        import shutil
        import time

        if self._stopped:
            return
        self._stopped = True
        left: set = set()
        if self._error is None:
            for w in self._workers:
                w.inbox.put(None)
            deadline = time.monotonic() + 30.0
            while len(left) < self.size and (wait := deadline - time.monotonic()) > 0:
                answer = self._next(wait)
                if answer is None:
                    if any(p.exitcode is not None for p in self.processes):
                        break
                    continue
                if answer[1] == _LEFT:
                    left.add(answer[0])
        if len(left) == self.size:
            self._pool.give_back(self._workers)
        else:
            self._pool.discard(self._workers)
        shutil.rmtree(self._dir, ignore_errors=True)
