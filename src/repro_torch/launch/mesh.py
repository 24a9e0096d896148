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
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Sequence

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
