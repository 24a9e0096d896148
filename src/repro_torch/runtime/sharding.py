"""Logical-axis -> partition-spec rules (divisibility-checked).

Own copy of the JAX package's ``runtime/sharding.py``; the rule logic is
the reference's, line for line, plain Python over axis sizes:

* tensor-parallel names ("vocab", "mlp", "qkv", "heads", "kv", "experts")
  shard on the "model" axis;
* "batch" shards on ("pod", "data") (greedily trimmed so the dim divides);
* "seq" (train/prefill activations) shards on "model" (sequence
  parallelism);
* "cache_seq" (decode KV caches) shards on "model", and also takes the
  "data" axis when the batch is too small to use it;
* ZeRO: every parameter also shards its largest unmapped dim over
  ("pod", "data") when divisible (optimizer state follows its param).

A spec is the port's :class:`P`, a tuple of entries (None, an axis name or
a tuple of them) that compares entry for entry with the JAX package's
``PartitionSpec``. There is no GSPMD: :func:`shard` cuts a full leaf to a
rank's tile of its spec, :func:`unshard` all-gathers a tile back, and
:func:`constrain` only checks that a local tensor is its spec's share.
"""
from __future__ import annotations

import contextlib
import math
import types
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

TENSOR_AXES = ("vocab", "mlp", "qkv", "heads", "kv", "experts")


class P(tuple):
    """A partition spec: one entry per leading dim (trailing Nones
    dropped), each None, an axis name or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _axis_size(mesh, axes: Sequence[str]) -> int:
    return int(math.prod(mesh.shape[a] for a in axes)) if axes else 1


def _fits(dim: int, mesh, axes: Sequence[str]) -> bool:
    s = _axis_size(mesh, axes)
    return s > 1 and dim % s == 0


def _flat(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass
class ShardingRules:
    """Maps logical axis names to mesh axes for one (mesh, workload shape).
    ``mesh`` is anything with ``.shape`` (axis name -> size)."""

    mesh: Any
    batch_axes: tuple[str, ...] = ()
    zero: bool = True  # FSDP/ZeRO-shard params over the batch axes
    kind: str = "train"  # "train" | "prefill" | "decode"
    #: stacked param leaves of the running step: id(local tensor) -> (the
    #: spec of one layer's slice, its :func:`model_tile` where the slice
    #: stays the rank's "model" tile, else None; ``models/common.py``
    #: ``layer_params``)
    stacked: dict = field(default_factory=dict, repr=False)
    #: a serving step's global K/V cache length (its "cache_seq" tiles)
    cache_len: int | None = None

    @classmethod
    def for_shape(cls, mesh, *, kind: str, global_batch: int, zero: bool = True) -> "ShardingRules":
        dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
        # greedily trim the batch axes until the global batch divides
        batch_axes = dp
        while batch_axes and global_batch % _axis_size(mesh, batch_axes) != 0:
            batch_axes = batch_axes[1:]
        return cls(mesh=mesh, batch_axes=batch_axes, zero=zero, kind=kind)

    @property
    def n_model(self) -> int:
        return self.mesh.shape.get("model", 1)

    def cache_seq_axes(self, length: int) -> tuple[str, ...]:
        """The mesh axes a K/V cache ``length`` long splits its sequence
        over (the "cache_seq" rule), in mesh order; () for none."""
        return _flat(self._map_name("cache_seq", length))

    # -- logical name -> candidate mesh axes --------------------------------

    def _map_name(self, name: str | None, dim: int) -> Any:
        if name is None or name == "layers":
            return None
        if name in TENSOR_AXES:
            return "model" if _fits(dim, self.mesh, ("model",)) else None
        if name == "embed":
            return None  # ZeRO may take it for params
        if name in ("batch", "moe_groups"):
            return self.batch_axes if _fits(dim, self.mesh, self.batch_axes) else None
        if name == "seq":
            return "model" if _fits(dim, self.mesh, ("model",)) else None
        if name == "cache_seq":
            unused = tuple(
                a for a in ("pod", "data") if a in self.mesh.shape and a not in self.batch_axes
            )
            cand = unused + ("model",)
            if _fits(dim, self.mesh, cand):
                return cand
            return "model" if _fits(dim, self.mesh, ("model",)) else None
        raise ValueError(f"unknown logical axis {name!r}")

    def spec(self, axes: Sequence[str | None], shape: Sequence[int], *,
             is_param: bool = False) -> P:
        entries: list[Any] = []
        used: set[str] = set()
        for name, dim in zip(axes, shape):
            m = self._map_name(name, dim)
            if isinstance(m, tuple) and not m:
                m = None
            if m is not None:
                flat = (m,) if isinstance(m, str) else tuple(m)
                if used & set(flat):
                    m = None  # a mesh axis may appear once per spec
                else:
                    used.update(flat)
            entries.append(m)
        if is_param and self.zero:
            entries = self._apply_zero(entries, axes, shape, used)
        while entries and entries[-1] is None:
            entries.pop()
        # 1-tuples mean the same partitioning as their bare axis name
        entries = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries]
        return P(*entries)

    def _apply_zero(self, entries, axes, shape, used) -> list:
        if "vocab" in axes:
            # embedding / lm_head stay vocab-sharded only: the vocab-parallel
            # CE (runtime/losses.py) consumes them directly per-shard
            return entries
        zero_axes = tuple(
            a for a in ("pod", "data") if a in self.mesh.shape and a not in used
        )
        if not zero_axes:
            return entries
        # largest unmapped dim that divides by the full zero-axis group
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if entries[i] is not None or axes[i] == "layers":
                continue
            for cand in (zero_axes, zero_axes[-1:]):
                if _fits(shape[i], self.mesh, cand):
                    entries[i] = cand if len(cand) > 1 else cand[0]
                    return entries
        return entries

    # -- tree-level helpers ---------------------------------------------------

    def shardings(self, axes_tree: Any, struct_tree: Any, *, is_param: bool = False) -> Any:
        """The spec of every leaf: ``axes_tree`` and ``struct_tree`` are
        parallel nested dicts of axis tuples and tensors (``meta`` ones do)."""
        if isinstance(axes_tree, dict):
            return {k: self.shardings(axes_tree[k], struct_tree[k], is_param=is_param)
                    for k in sorted(axes_tree)}
        return self.spec(axes_tree, struct_tree.shape, is_param=is_param)


def param_shardings(model, mesh, *, zero: bool = True) -> Any:
    """Every param's spec (params don't depend on the workload shape)."""
    rules = ShardingRules(mesh=mesh, batch_axes=(), zero=zero)
    return rules.shardings(model.param_axes(), model.param_struct(), is_param=True)


def replicated(mesh, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: replicated(mesh, v) for k, v in tree.items()}
    return P()


# ---------------------------------------------------------------------------
# a rank's tile of a spec
# ---------------------------------------------------------------------------


def shard_slices(spec: P, shape: Sequence[int], mesh) -> tuple[slice, ...]:
    """The slices of a full ``shape`` that ``mesh``'s rank holds under ``spec``."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = _flat(entry)
        if not axes:
            out.append(slice(None))
            continue
        n = _axis_size(mesh, axes)
        if dim % n:
            raise ValueError(f"dim {i} ({dim}) of {tuple(shape)} does not split over {axes} ({n})")
        tile = dim // n
        j = mesh.axis_index(axes)
        out.append(slice(j * tile, (j + 1) * tile))
    return tuple(out)


def shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """``x``'s tile on this rank (a contiguous copy, never a view of ``x``:
    the mesh step updates its tiles in place)."""
    return x[shard_slices(spec, x.shape, mesh)].clone(memory_format=torch.contiguous_format)


def spec_axes(spec: P) -> tuple[str, ...]:
    """Every mesh axis that ``spec`` shards over, in mesh-entry order."""
    return tuple(a for e in spec for a in _flat(e))


def unshard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """All-gather a tile back to the full leaf (differentiable: the
    backward reduce-scatters the gradient to the tile)."""
    return unshard_many([x], [spec], mesh)[0]


#: the most gathered bytes one collective of :func:`unshard_many` returns
#: (a leaf above it gathers alone): its forward and backward each hold a
#: flat buffer that large beside the leaves, so a MoE layer's experts (5 GB
#: in f32 at phi3.5-moe's width) do not double a rank's peak
GATHER_BYTES = 1 << 30


def unshard_many(tiles: list, specs: list, mesh) -> list:
    """The full leaves of ``tiles`` under ``specs``, in one all-gather per
    dtype (per GATHER_BYTES of gathered leaves): the flattened tiles side by
    side, over every mesh axis any of the specs shards (a layer's leaves in
    one collective, or a few, not one per leaf and sharded dim). A leaf not
    sharded over one of those axes takes the tiles of that axis' index 0,
    so in the backward only those ranks receive its gradient, the sum over
    the group, and the others zero: as with one gather per spec, the
    gradient is whole once summed over the axes the leaf is replicated on,
    as the mesh step sums it."""
    from repro_torch.runtime.collectives import all_gather_stack

    out = list(tiles)
    groups: dict = {}
    for i, (t, spec) in enumerate(zip(tiles, specs)):
        if spec_axes(spec):
            full = t.numel() * t.element_size() * _axis_size(mesh, spec_axes(spec))
            chunks = groups.setdefault(t.dtype, [[]])
            if chunks[-1] and sum(b for _, b in chunks[-1]) + full > GATHER_BYTES:
                chunks.append([])
            chunks[-1].append((i, full))
    for idx in ([i for i, _ in chunk] for chunks in groups.values() for chunk in chunks):
        used = {a for i in idx for a in spec_axes(specs[i])}
        axes = tuple(a for a in mesh.axis_names if a in used)  # the group's rank order
        gathered = all_gather_stack(torch.cat([tiles[i].reshape(-1) for i in idx]), mesh, axes)
        sizes = [mesh.shape[a] for a in axes]
        off = 0
        for i in idx:
            t, spec = tiles[i], specs[i]
            piece = gathered[:, off:off + t.numel()].reshape(*sizes, *t.shape)
            off += t.numel()
            mine = spec_axes(spec)
            piece = piece[tuple(slice(None) if a in mine else 0 for a in axes)]
            own = tuple(a for a in axes if a in mine)
            # full dim d: row-major over its entry's axes, then the tile's dim d
            order, shape = [], []
            for d in range(t.ndim):
                entry = _flat(spec[d] if d < len(spec) else None)
                order += [own.index(a) for a in entry]
                order.append(len(own) + d)
                shape.append(t.shape[d] * _axis_size(mesh, entry))
            out[i] = piece.permute(order).reshape(shape)
    return out


def model_tile(spec: P, axes: Sequence[str | None]) -> tuple[P, P] | None:
    """For a leaf whose ``spec`` shards a tensor-axis dim on "model"
    (``axes``: the leaf's logical names): (the spec of what a rank keeps,
    its "model" tile of that dim; the spec it gathers to that tile,
    ``spec`` without that entry: its ZeRO axes). None for every other leaf,
    among them one whose tensor dims "model" does not divide (its spec
    keeps them whole). Which leaves stay such tiles is the step's choice:
    the experts (expert parallelism) and the vocab (the vocab-parallel
    forms) wherever "model" splits them, and in a serving decode step the
    weights of the tensor-parallel products too (``runtime/steps.py``)."""
    i = next((j for j, e in enumerate(spec) if e == "model" and axes[j] in TENSOR_AXES), None)
    if i is None:
        return None
    rest = [None if j == i else e for j, e in enumerate(spec)]
    while rest and rest[-1] is None:
        rest.pop()
    return P(*([None] * i + ["model"])), P(*rest)


def flatten_specs(tree: Any, prefix: str = "") -> dict:
    """{path: leaf} of a nested dict whose leaves are tuples (specs or axis
    names), paths as ``utils/tree.py`` writes them (keys sorted, ``/``)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten_specs(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], specs[k], mesh) for k in tree}
    return shard(tree, specs, mesh)


def unshard_tree(tree: Any, specs: Any, mesh) -> Any:
    if isinstance(tree, dict):
        return {k: unshard_tree(tree[k], specs[k], mesh) for k in tree}
    return unshard(tree, specs, mesh)


# ---------------------------------------------------------------------------
# activation-rules context: the models ask it whether a mesh step runs
# ---------------------------------------------------------------------------

# process-wide, not per thread (the reference's is a threading.local): on
# the card autograd runs a checkpointed layer's recompute on its device
# thread, which must route as the forward did. A mesh step owns its
# process: one rank per process.
_CTX = types.SimpleNamespace(rules=None)


@contextlib.contextmanager
def activation_rules(rules: "ShardingRules | None"):
    prev = _CTX.rules
    _CTX.rules = rules
    try:
        yield
    finally:
        _CTX.rules = prev


def current_rules() -> "ShardingRules | None":
    return _CTX.rules


def model_parallel() -> "ShardingRules | None":
    """The active rules where activations are sequence-sharded on a
    "model" axis of more than one rank (training and prefill; a decode
    step's one token is not), else None."""
    rules = current_rules()
    if rules is not None and rules.n_model > 1 and rules.kind != "decode":
        return rules
    return None


def constrain(x: torch.Tensor, axes: Sequence[str | None], global_shape: Sequence[int]
              ) -> torch.Tensor:
    """No GSPMD to hint: check that the local ``x`` is the share of a
    ``global_shape`` tensor under the active rules' spec of ``axes``;
    return ``x``. Outside an :func:`activation_rules` context, ``x`` as is."""
    rules = current_rules()
    if rules is None:
        return x
    spec = rules.spec(axes, global_shape)
    want = tuple(dim // _axis_size(rules.mesh, _flat(spec[i] if i < len(spec) else None))
                 for i, dim in enumerate(global_shape))
    if tuple(x.shape) != want:
        raise ValueError(f"local shape {tuple(x.shape)} is not the {spec} share {want} "
                         f"of {tuple(global_shape)}")
    return x
