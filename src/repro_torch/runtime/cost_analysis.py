"""Static cost of one call of a step: FLOPs, bytes, collectives and peak memory.

The port's counterpart of the JAX package's ``runtime/hlo_analysis.py``.
The reference compiles a step for a fake device mesh and parses the HLO
text; the port has no compiler and no HLO, so :func:`trace_cost` runs the
step itself, eagerly, once, for one rank, under
``torch._subclasses.fake_tensor.FakeTensorMode`` (tensors with shapes,
dtypes and a device, ``cuda`` by default, and no storage: the card's code
path is traced on any host) and a dispatch mode that sees every operator
below autograd, the backward's included, and every ``c10d`` collective of
the rank's process group (a ``fake`` group stands for the production mesh:
``launch/dryrun.py``). Eager loops run every iteration, so nothing counts a
loop body once and no trip-count correction exists or is needed. The
reference's ``shape_bytes``, ``_trip_count`` and ``cpu_upcast_artifact_bytes``
read HLO text or correct XLA's CPU backend (which upcasts bf16 weight stacks
to f32); they have no counterpart.

Cost model (:class:`StepCost`, the reference's names):

* ``flops``: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``),
  among them the hand-written kernels' own (``kernels/attention/ops.py``,
  ``kernels/kmeans/ops.py``, ``kernels/tomo/ops.py``): a step or a
  Mini-App batch counts the same FLOPs whether a kernel or its plain
  version runs.
* ``bytes_moved``, the reference's every-op model: each operator writes its
  output once and it is read about once downstream, 2 x its output bytes,
  plus the step's inputs read once; views, ``empty`` and metadata are free;
  an in-place scatter (``index_put_``, ``index_copy_``, ``scatter_``)
  writes its values, not the whole buffer it updates.
* ``bytes_moved_fused``, the reference's fused model: the products'
  operands and outputs (matmuls, convolutions, the hand-written kernels), the
  collectives' payloads and outputs, the data-movement operators' outputs
  (gather, index, scatter, cat, copy, clone) and the inputs; elementwise
  chains are taken as fused into their consumers.
* ``collective_bytes`` (each collective's payload: its input) and
  ``collective_counts`` under the reference's names (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``collective-permute``, ``all-to-all``),
  and by name the payloads' and the results' bytes (an all-gather's
  result: the leaves it gathers);
  each payload is also tagged by whether its group lies within one node of
  ``launch/roofline.py`` ``NODE_GPUS`` consecutive ranks:
  ``collective_bytes_in_node`` and ``collective_bytes_across_nodes``.
* ``peak_bytes``: the most bytes of live tensor storage at any point of the
  call, the inputs included and storage updated in place counted once.
  Each storage counts when an operator creates it and stops when it is
  freed (autograd's saved tensors stay until the backward frees them); on
  a ``cuda`` trace each is rounded up to the CUDA caching allocator's
  512-byte blocks, as ``torch.cuda.max_memory_allocated`` counts them.
  A workspace a kernel op allocates inside its launch counts where its op
  registered its bytes (``kernels/_library.py`` ``WORKSPACES``: the
  K-Means update's, the projection's transposed images), live beside the
  op's inputs and outputs and, in both byte models, written and read once;
  the attention kernels' partials are not seen.

The decode kernel's FLOPs depend on the rows' positions, which a fake
tensor does not hold: the trace keeps the values of small integer tensors
(positions and what is computed from them) on the host beside their fakes
(:func:`known_value`), so the formula counts the valid entries of each
cache shard exactly.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.kernels._library import WORKSPACES
from repro_torch.launch.roofline import NODE_GPUS

#: c10d operator -> the reference's collective name; the index of its
#: payload (input) argument
_COLLECTIVES = {
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),  # a ppermute is one send and one receive
}
_RECEIVES = {"recv_", "recv_any_source_"}
#: collectives that return only their work handle: the index of the output
#: argument they write
_WRITES = {"alltoall_base_": 0}

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "convolution", "_convolution",
             "flash_attention", "flash_attention_lse", "flash_attention_bwd", "decode_attention",
             "decode_attention_lse", "kmeans_assign", "kmeans_update", "tomo_project",
             "tomo_backproject"}
_MOVES = {"index", "_unsafe_index", "index_select", "gather", "embedding", "take_along_dim",
          "cat", "copy_", "clone", "slice_scatter", "select_scatter", "as_strided_scatter"}
#: in-place scatters: the bytes of their values (the last tensor argument)
_SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_", "scatter_add_",
             "index_add_", "masked_scatter_"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
         "alias", "lift_fresh", "_local_scalar_dense"}
#: factories whose values follow from their scalar arguments
_FACTORIES = {"arange", "full", "zeros", "ones", "scalar_tensor", "zeros_like", "ones_like",
              "full_like", "lift_fresh_copy"}
#: the most elements a value the trace keeps on the host may have
KNOWN_NUMEL = 1 << 16

_KNOWN: WeakTensorKeyDictionary = WeakTensorKeyDictionary()


def known_value(t: torch.Tensor) -> torch.Tensor | None:
    """The host copy of a fake tensor's values where the running trace
    knows them (small integer or boolean tensors: positions and what
    follows from them), else None."""
    return _KNOWN.get(t)


@dataclass
class StepCost:
    flops: float = 0.0
    bytes_moved: float = 0.0
    bytes_moved_fused: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = field(default_factory=dict)
    #: by collective name: the payloads' bytes, and the bytes each returns
    #: (an all-gather's gathered leaves)
    collective_bytes_by_kind: dict = field(default_factory=dict)
    collective_out_bytes_by_kind: dict = field(default_factory=dict)
    collective_bytes_in_node: float = 0.0
    collective_bytes_across_nodes: float = 0.0
    peak_bytes: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    #: the outputs' bytes that are inputs updated in place (params,
    #: moments, caches)
    alias_bytes: int = 0
    ops: int = 0
    seconds: float = 0.0

    def record(self) -> dict:
        """The dry run's ``hlo`` entry (the reference's keys, and the in-node
        and across-node split of the collective bytes)."""
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_moved,
            "bytes_fused_per_device": self.bytes_moved_fused,
            "collective_bytes_per_device": self.collective_bytes,
            "collective_bytes_in_node_per_device": self.collective_bytes_in_node,
            "collective_bytes_across_nodes_per_device": self.collective_bytes_across_nodes,
            "collectives": dict(self.collective_counts),
            "collective_bytes_by_kind": dict(self.collective_bytes_by_kind),
            "collective_out_bytes_by_kind": dict(self.collective_out_bytes_by_kind),
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _group_ranks(args) -> list | None:
    """The global ranks of the process group among a c10d op's arguments."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue  # a ReduceOp or another script object
            return dist.get_process_group_ranks(pg)
    return None


class CostMode(TorchDispatchMode):
    """Counts bytes, collectives and live storage of every operator it
    sees (FLOPs come from ``FlopCounterMode`` beside it), and keeps the
    host values of small integer tensors (:func:`known_value`)."""

    def __init__(self, *, granule: int = 1):
        super().__init__()
        self.cost = StepCost()
        self.granule = granule
        self._live: dict[int, int] = {}
        self._now = 0
        self.inputs: set[int] = set()

    # -- storage ---------------------------------------------------------------

    def _free(self, key: int) -> None:
        self._now -= self._live.pop(key, 0)

    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it is freed; its new bytes."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = -(-st.nbytes() // self.granule) * self.granule
        self._live[key] = n
        weakref.finalize(st, self._free, key)
        self._now += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._now)
        return n

    def add_inputs(self, tree) -> None:
        for t in _tensors(tree):
            self.inputs.add(t.untyped_storage()._cdata)
            self.track(t)
            n = _nbytes(t)
            self.cost.input_bytes += n
            self.cost.bytes_moved += n
            self.cost.bytes_moved_fused += n

    # -- known values ------------------------------------------------------------

    def _propagate(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        if not outs or any(o.numel() > KNOWN_NUMEL or o.dtype.is_floating_point
                           or o.dtype.is_complex for o in outs):
            return
        name = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        if name not in _FACTORIES and (not ins or any(t not in _KNOWN for t in ins)):
            return
        if name in _FACTORIES and name.endswith("_like"):
            ins = []  # their values follow from the shape only

        def real(x):
            if isinstance(x, torch.Tensor):
                return _KNOWN[x] if x in _KNOWN else torch.empty(x.shape, dtype=x.dtype)
            if isinstance(x, torch.device):
                return torch.device("cpu")
            return x

        with _disable_current_modes(), unset_fake_temporarily():
            r_args, r_kwargs = tree_map(real, (args, kwargs))
            if "device" in r_kwargs:
                r_kwargs["device"] = torch.device("cpu")
            values = [v.detach().clone() for v in _tensors(func(*r_args, **r_kwargs))]
        for o, v in zip(outs, values):
            _KNOWN[o] = v

    # -- the operators -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns == "c10d":
            self._collective(name, args, out)
        elif not (func.is_view or name in _FREE):
            outs = _tensors(out)
            out_b = sum(_nbytes(t) for t in outs)
            if name in _SCATTERS:
                vals = _tensors(args)[-1]
                c.bytes_moved += 2 * _nbytes(vals)
                c.bytes_moved_fused += _nbytes(vals)
            else:
                c.bytes_moved += 2 * out_b
                if name in _PRODUCTS:
                    c.bytes_moved_fused += sum(_nbytes(t) for t in _tensors(args)) + out_b
                elif name in _MOVES:
                    c.bytes_moved_fused += out_b
        for t in _tensors(out):
            self.track(t)
        if ns == "repro_torch" and name in WORKSPACES:
            self._workspace(WORKSPACES[name](*args, **kwargs))
        self._propagate(func, args, kwargs, out)
        return out

    def _workspace(self, n: int) -> None:
        """A kernel's workspace: live beside the op's inputs and outputs
        during its launch, written and read once."""
        c = self.cost
        c.peak_bytes = max(c.peak_bytes, self._now + -(-n // self.granule) * self.granule)
        c.bytes_moved += 2 * n
        c.bytes_moved_fused += 2 * n

    def _collective(self, name: str, args, out) -> None:
        if name in _RECEIVES or name not in _COLLECTIVES:
            return
        kind, i = _COLLECTIVES[name]
        payload = sum(_nbytes(t) for t in _tensors(args[i]))
        result = sum(_nbytes(t) for t in _tensors(args[_WRITES[name]] if name in _WRITES
                                                  else out))
        c = self.cost
        c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
        c.collective_bytes += payload
        c.collective_bytes_by_kind[kind] = c.collective_bytes_by_kind.get(kind, 0) + payload
        c.collective_out_bytes_by_kind[kind] = c.collective_out_bytes_by_kind.get(kind, 0) + result
        c.bytes_moved += 2 * result
        c.bytes_moved_fused += payload + result
        ranks = _group_ranks(args)
        if ranks and len({r // NODE_GPUS for r in ranks}) == 1:
            c.collective_bytes_in_node += payload
        else:
            c.collective_bytes_across_nodes += payload


def _fake_input(x, device: torch.device):
    """A fake tensor on ``device`` for a ``meta`` struct or a real tensor (a
    small integer one keeps its values on the host); others as they are."""
    if not isinstance(x, torch.Tensor):
        return x
    f = torch.empty(x.shape, dtype=x.dtype, device=device)
    if x.device.type != "meta" and x.numel() <= KNOWN_NUMEL \
            and not x.dtype.is_floating_point and not x.dtype.is_complex:
        with unset_fake_temporarily():
            _KNOWN[f] = x.detach().to("cpu").clone()
    return f


def trace_cost(fn: Callable, *args,
               device: torch.device | str = "cuda") -> tuple[Any, StepCost]:
    """Run ``fn(*args)`` once under fake tensors on ``device`` and count its
    cost. ``args`` are pytrees of ``meta`` structs or real tensors (made
    fake on ``device``; a small integer one keeps its values) and other
    values. Returns (``fn``'s fake outputs, :class:`StepCost`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    device = torch.device(device)
    _KNOWN.clear()
    granule = 512 if device.type == "cuda" else 1
    mode = CostMode(granule=granule)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=False):
        fake = tree_map(lambda x: _fake_input(x, device), args)
        mode.add_inputs(fake)
        flops = FlopCounterMode(display=False)
        with mode, flops:
            out = fn(*fake)
        mode.cost.flops = float(flops.get_total_flops())
        outs = _tensors(out)
        mode.cost.output_bytes = sum(_nbytes(t) for t in outs)
        mode.cost.alias_bytes = sum(_nbytes(t) for t in outs
                                    if t.untyped_storage()._cdata in mode.inputs)
    mode.cost.seconds = time.perf_counter() - t0
    _KNOWN.clear()
    return out, mode.cost


def count_flops(fn: Callable, *args) -> int:
    """``FlopCounterMode``'s count of one real call ``fn(*args)`` (on the card,
    the kernels' formulas and the products PyTorch launches)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return int(fc.get_total_flops())


__all__ = ["CostMode", "KNOWN_NUMEL", "StepCost", "count_flops", "known_value", "trace_cost"]
