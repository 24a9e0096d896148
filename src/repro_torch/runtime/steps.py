"""The train step (on one device or on a mesh), and the paged serving
steps (prefill and decode against a KV page pool).

Own copies of the JAX package's ``build_train_step``, ``make_rules``,
``build_paged_prefill_step`` and ``build_paged_decode_step``
(``repro/runtime/steps.py``). ``jit`` and buffer donation have no
counterpart: PyTorch runs eagerly.

On a mesh (``launch/mesh.py``) every rank runs the step on its own tiles,
where the reference's GSPMD partitions one program: each param and its
Adam moments live as the rank's tile of their ``param_shardings`` spec
(tensor axes on "model", ZeRO's largest free dim over the data axes); a
layer's leaves are all-gathered where the layer runs, a few collectives a
layer (``models/common.py`` ``ShardedLayer``; a MoE layer's experts stay
the rank's "model" tile, gathered over the data axes only, and its tokens
move instead: ``models/moe.py``), and their gradients
reduce-scatter back to the tiles; the batch rows split over the data axes and the
sequence over "model", the ops that mix positions taking their shard's
context (sharded attention, vocab-parallel embedding and loss, the
sequence-parallel cores, the RoPE offset, the token shift, the target
shift). Each rank back-propagates the loss every rank holds, divided by the
number of ranks (the collectives' backward are exact transposes:
``runtime/collectives.py``); each gradient tile is then summed over the
axes its param is replicated on, the global grad norm is summed over the
mesh, and the optimizer updates the local tiles. Under remat the gather
runs inside the layer's checkpoint: the full weights are freed after the
layer's forward and gathered again for its backward; without remat
autograd keeps them until the backward. The train step updates the params and
optimizer moments in place; the serving steps update the page pools **in
place** (``index_put_``), returning the same pool tensors so callers read
like the JAX package's. A step's logical
context is still gathered from the pool into a dense per-row cache
(``pages[:, table]``) before ``model.decode`` runs on it. Page 0 is the
scratch page: padding rows and columns write there, possibly more than
once per call (the order of those writes is undefined), and nothing ever
reads it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.service import resolve_device
from repro_torch.data.batching import shard_batch
from repro_torch.launch.mesh import shared_host_copy
from repro_torch.models.base import BaseModel
from repro_torch.models.common import ModelTiles, ShardedLayer, first_argmax, torch_dtype
from repro_torch.runtime.collectives import psum
from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig, TileLayout, _leaf_sqnorm
from repro_torch.runtime.sharding import (
    TENSOR_AXES,
    P,
    ShardingRules,
    activation_rules,
    flatten_specs,
    model_tile,
    param_shardings,
    shard_slices,
    shard_tree,
    spec_axes,
    unshard_tree,
)
from repro_torch.utils.tree import tree_flatten_with_paths, tree_map_with_paths


def make_rules(mesh, shape: ShapeConfig, *, zero: bool = True) -> ShardingRules:
    return ShardingRules.for_shape(mesh, kind=shape.kind, global_batch=shape.global_batch,
                                   zero=zero)


def _shard_tree(rules: ShardingRules, axes_tree, struct_tree):
    return rules.shardings(axes_tree, struct_tree)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def build_train_step(model: BaseModel, shape: ShapeConfig, opt_cfg: OptimizerConfig | None = None,
                     *, grad_accum: int | None = None, device: torch.device | str | None = None,
                     mesh=None) -> Callable:
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)``: one
    step of ``model.loss`` and the optimizer on ``device``, as the JAX
    package's ``build_train_step``.

    ``batch`` is a dict of host arrays or tensors (``{"tokens": (B, S)}``),
    copied to ``device``; ``shape.global_batch`` rows per step, which
    ``grad_accum`` must divide. With ``grad_accum`` > 1 the batch is cut
    into that many microbatches along its rows, in order, each microbatch's
    grad divided by ``grad_accum`` and summed in the param dtype, and the
    loss is the microbatches' mean. The params take ``requires_grad`` for
    the backward only; the update writes them and the moments in place, so
    the returned trees are the ones passed in (the step's ``step`` is new).
    ``metrics``: ``loss``, ``lr``, ``grad_norm`` (and ``ce_loss``,
    ``tokens`` without accumulation) as device scalars.

    With ``mesh`` (instead of ``device``) it is the mesh step of
    :func:`build_mesh_train_step`."""
    if mesh is not None:
        if device is not None:
            raise ValueError("build_train_step takes a device or a mesh, not both")
        return build_mesh_train_step(model, shape, opt_cfg, mesh, grad_accum=grad_accum)
    if device is None:
        raise ValueError("build_train_step needs a device (or a mesh)")
    cfg = model.cfg
    opt = Optimizer(opt_cfg or OptimizerConfig(
        name=cfg.optimizer, moment_dtype=cfg.moment_dtype, first_moment=cfg.first_moment))
    accum = grad_accum if grad_accum is not None else cfg.grad_accum
    if accum > 1 and shape.global_batch % accum:
        raise ValueError(f"grad_accum {accum} does not divide the batch of {shape.global_batch}")
    # grad accumulators in the param dtype, as the JAX package keeps them
    accum_dtype = torch_dtype(cfg.param_dtype)
    dev = resolve_device(device)

    def value_and_grad(leaves: list[torch.Tensor], params: Any, batch: dict):
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params: Any, opt_state: dict, batch: dict):
        batch = shard_batch(batch, dev)
        flat = tree_flatten_with_paths(params)
        leaves = [p for _, p in flat]
        if accum <= 1:
            loss, metrics, grads = value_and_grad(leaves, params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, _, g = value_and_grad(leaves, params, mb)
                for acc, gg in zip(grads, g):
                    acc.add_((gg / accum).to(accum_dtype))
                lsum = lsum + l
            loss = lsum / accum
            metrics = {}
        by_path = dict(zip((path for path, _ in flat), grads))
        grad_tree = tree_map_with_paths(lambda path, _: by_path[path], params)
        params, opt_state, stats = opt.update(grad_tree, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, **stats)

    return train_step


def _state_optimizer(opt_state: dict) -> Optimizer:
    """An optimizer whose state has ``opt_state``'s leaves (their specs
    depend on the name and the first moment only)."""
    name = "adafactor" if "v_row" in opt_state else "adamw" if "v" in opt_state else "sgd"
    return Optimizer(OptimizerConfig(name=name, first_moment="m" in opt_state))


def opt_state_shardings(model: BaseModel, opt: Optimizer, mesh) -> dict:
    """Every optimizer-state leaf's spec, as the reference's ``o_shard``:
    ``Optimizer.state_axes`` through the param rules (ZeRO included), so
    Adam's moments follow their params and Adafactor's ``v_row``/``v_col``
    take the specs of their own shapes; ``step`` whole. Also what
    ``CheckpointManager.restore(shardings=...)`` takes for the state."""
    rules = ShardingRules(mesh=mesh, batch_axes=())
    return rules.shardings(opt.state_axes(model.param_axes()),
                           opt.state_struct(model.param_struct()), is_param=True)


def mesh_train_state(model: BaseModel, params: Any, opt_state: dict, mesh) -> tuple[Any, dict]:
    """Full params and optimizer state -> this rank's tiles of them, as the
    mesh step keeps them (:func:`opt_state_shardings`; ``step`` whole)."""
    specs = opt_state_shardings(model, _state_optimizer(opt_state), mesh)
    params = shard_tree(params, param_shardings(model, mesh), mesh)
    opt_state = {k: (v if k == "step" else shard_tree(v, specs[k], mesh))
                 for k, v in opt_state.items()}
    return params, opt_state


def _tile_layouts(model: BaseModel, opt: Optimizer, mesh, specs: dict) -> dict:
    """Each param leaf's :class:`TileLayout` by path (Adafactor's reductions
    over whole leaves read it)."""
    shapes = {path: tuple(x.shape) for path, x in tree_flatten_with_paths(model.param_struct())}
    state = opt_state_shardings(model, opt, mesh)
    rows = flatten_specs(state["v_row"]) if "v_row" in state else {}
    cols = flatten_specs(state["v_col"]) if "v_col" in state else {}
    return {path: TileLayout.of(mesh, shapes[path], spec, rows.get(path, ()), cols.get(path, ()))
            for path, spec in specs.items()}


def build_mesh_train_step(model: BaseModel, shape: ShapeConfig,
                          opt_cfg: OptimizerConfig | None, mesh, *,
                          grad_accum: int | None = None) -> Callable:
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)`` on
    one rank of ``mesh``: ``params`` and ``opt_state`` are the rank's tiles
    (:func:`mesh_train_state`), ``batch`` the whole global batch (every rank
    passes the same one, as the reference's step takes global arrays; each
    keeps its rows and sequence shard: ``model.local_batch``). Metrics are
    alike on every rank. Adafactor's means over whole leaves are taken
    across the tiles (``runtime/optimizer.py`` ``TileLayout``)."""
    cfg = model.cfg
    opt = Optimizer(opt_cfg or OptimizerConfig(
        name=cfg.optimizer, moment_dtype=cfg.moment_dtype, first_moment=cfg.first_moment))
    accum = max(grad_accum if grad_accum is not None else cfg.grad_accum, 1)
    accum_dtype = torch_dtype(cfg.param_dtype)
    rules = make_rules(mesh, shape)
    n_model, n_rows = rules.n_model, mesh.axis_size(rules.batch_axes)
    B = shape.global_batch
    if B % accum:
        raise ValueError(f"{accum} microbatches do not split the batch of {B}")
    row_i = mesh.axis_index(rules.batch_axes) if rules.batch_axes else 0
    seq_i = mesh.axis_index("model") if n_model > 1 else 0
    split = ((row_i, n_rows), (seq_i, n_model))
    # each input's own split (raises naming the one that does not divide)
    model.local_batch({k: v[:v.shape[0] // accum] for k, v in model.input_specs(shape).items()},
                      *split)
    if n_model > 1 and cfg.padded_vocab % n_model:
        raise ValueError(f"vocab {cfg.padded_vocab} does not split over {n_model} model ranks")
    specs = flatten_specs(param_shardings(model, mesh))
    axes = flatten_specs(model.param_axes())
    kept = _kept_tiles(specs, axes)
    tiles = _tile_layouts(model, opt, mesh, specs)
    # each leaf's gradient tile is summed over the axes its param is replicated on
    repl = {path: tuple(a for a in mesh.axis_names if a not in spec_axes(spec))
            for path, spec in specs.items()}
    # a tile's share of the global norm: its square sum counted once per copy
    copies = {path: mesh.axis_size(r) for path, r in repl.items()}
    world = mesh.size
    dev = mesh.device

    def value_and_grad(leaves, params, batch):
        for p in leaves:
            p.requires_grad_(True)
        rules.stacked = {}
        try:
            with activation_rules(rules):
                loss, metrics = model.loss(
                    _mesh_view(params, specs, axes, mesh, rules.stacked, kept), batch)
                grads = torch.autograd.grad(loss, leaves,
                                            grad_outputs=torch.full_like(loss, 1.0 / world))
        finally:
            rules.stacked = {}
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params: Any, opt_state: dict, batch: dict):
        batch = shard_batch(batch, dev)
        flat = tree_flatten_with_paths(params)
        leaves = [p for _, p in flat]
        if accum <= 1:
            loss, metrics, grads = value_and_grad(leaves, params,
                                                  model.local_batch(batch, *split))
        else:
            grads = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                mb = model.local_batch({k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                                        for k, v in batch.items()}, *split)
                l, _, g = value_and_grad(leaves, params, mb)
                for acc, gg in zip(grads, g):
                    acc.add_((gg / accum).to(accum_dtype))
                lsum = lsum + l
            loss = lsum / accum
            metrics = {}
        with torch.no_grad():
            grads = [psum(g, mesh, repl[path]) if repl[path] else g
                     for (path, _), g in zip(flat, grads)]
            sq = sum(_leaf_sqnorm(g) / copies[path] for (path, _), g in zip(flat, grads))
            gnorm = torch.sqrt(psum(sq, mesh, mesh.axis_names))
        by_path = dict(zip((path for path, _ in flat), grads))
        grad_tree = tree_map_with_paths(lambda path, _: by_path[path], params)
        params, opt_state, stats = opt.update(grad_tree, opt_state, params, grad_norm=gnorm,
                                              tiles=tiles)
        return params, opt_state, dict(metrics, loss=loss, **stats)

    return train_step


class TrainRank:
    """One rank's side of a streaming train step on a rank group
    (``launch/mesh.py`` ``RankGroup``, which ``miniapps/masa.py``
    ``LMTrainApp`` drives). Built in the rank from the model config, the
    ``ShapeConfig`` and the ``OptimizerConfig`` on the rank's ``mesh``, it
    keeps the rank's tiles of the train state ``{"params", "opt"}`` between
    commands and runs the mesh step (:func:`build_mesh_train_step`) on each
    global batch it is sent: every rank takes the same batch, as the
    reference's step takes global arrays."""

    def __init__(self, mesh, cfg, shape: ShapeConfig, opt_cfg: OptimizerConfig | None):
        from repro_torch.models import build_model

        self.mesh, self.cfg, self.opt_cfg = mesh, cfg, opt_cfg
        self.model = build_model(cfg)
        self.step_fn = build_mesh_train_step(self.model, shape, opt_cfg, mesh)
        self.params: Any = None
        self.opt: dict | None = None
        self._launched = self._launch_counts()  # the process's, from groups before

    def _specs(self, opt: Optimizer) -> dict:
        return {"params": param_shardings(self.model, self.mesh),
                "opt": opt_state_shardings(self.model, opt, self.mesh)}

    def load(self, state: dict) -> None:
        """Keep this rank's tiles of the full (host) ``state`` on its device."""
        params, opt = mesh_train_state(self.model, state["params"], state["opt"], self.mesh)
        dev = self.mesh.device
        self.params = tree_map_with_paths(lambda _, x: x.to(dev), params)
        # the tiles are copies already (``shard``); ``step`` is the sender's
        self.opt = tree_map_with_paths(lambda path, x: x.to(dev, copy=path == "step"), opt)

    def step(self, tokens) -> dict | None:
        """One step on the global batch ``tokens``; rank 0 answers the loss,
        the grad norm and the step's wall seconds, the others None."""
        t0 = time.perf_counter()
        self.params, self.opt, met = self.step_fn(self.params, self.opt, {"tokens": tokens})
        if self.mesh.rank:
            return None
        out = {k: float(met[k]) for k in ("loss", "grad_norm")}
        out["s"] = time.perf_counter() - t0
        return out

    def gather(self) -> dict | None:
        """The full state, gathered over the mesh (``unshard_tree``); rank 0
        answers it in shared host memory (each leaf copied there once), the
        others None."""
        full = unshard_tree({"params": self.params, "opt": self.opt},
                            self._specs(_state_optimizer(self.opt)), self.mesh)
        if self.mesh.rank:
            return None
        return tree_map_with_paths(lambda _, x: shared_host_copy(x), full)

    def restore(self, directory: str, step: int | None) -> dict | None:
        """Keep this rank's tiles of checkpoint ``step`` in ``directory``
        (the latest by default): each leaf is read whole and cut to the
        tile, ``CheckpointManager.restore(shardings=..., mesh=...)``. Rank 0
        answers the checkpoint's step, its meta and the optimizer's step."""
        from repro_torch.checkpoint import CheckpointManager

        opt = Optimizer(self.opt_cfg or OptimizerConfig(name=self.cfg.optimizer))
        struct = self.model.param_struct()
        mgr = CheckpointManager(directory)
        step = mgr.latest_step() if step is None else step
        state, meta = mgr.restore({"params": struct, "opt": opt.state_struct(struct)}, step,
                                  device=self.mesh.device, shardings=self._specs(opt),
                                  mesh=self.mesh)
        self.params, self.opt = state["params"], state["opt"]
        return None if self.mesh.rank else {"step": step, "meta": meta,
                                            "opt_step": int(self.opt["step"])}

    @staticmethod
    def _launch_counts() -> dict:
        from repro_torch.kernels import KERNELS

        return {k.name: k.launches for k in KERNELS}

    def launches(self) -> dict:
        """This rank's launches of every kernel (``CudaKernel.launches``)
        since it joined this group."""
        return {k: n - self._launched[k] for k, n in self._launch_counts().items()}


def _kept_tiles(specs: dict, axes: dict, decode_gathered: tuple | None = None) -> dict:
    """{path: ``model_tile``'s (kept, gathered) specs} of the leaves a mesh
    step keeps as the rank's "model" tiles: the experts where "model"
    splits the expert count (expert parallelism), the vocab-sharded
    embedding and head (the vocab-parallel forms) and, in a serving decode
    step (``decode_gathered``: the names of the leaves it reads whole),
    every other leaf on "model": the tensor-parallel products' weights."""
    out = {}
    for path, spec in specs.items():
        tile = model_tile(spec, axes[path])
        if tile is None:
            continue
        on = axes[path][len(tile[0]) - 1]  # the logical axis "model" splits
        if "experts" in axes[path]:
            keep = on == "experts"
        else:
            keep = on == "vocab" or (decode_gathered is not None
                                     and path.rsplit("/", 1)[-1] not in decode_gathered)
        if keep:
            out[path] = tile
    return out


def _mesh_view(params: Any, specs: dict, axes: dict, mesh, stacked: dict, tiles: dict) -> Any:
    """The params as the model reads them on a mesh: stacked layer leaves
    as the rank's tiles (registered in ``stacked``; ``layer_params``
    gathers them per layer), the rest gathered here; a leaf of ``tiles``
    (:func:`_kept_tiles`) only over its other axes (ZeRO's), staying the
    rank's "model" tile, and a block of unstacked leaves holding such tiles
    (Zamba2's shared block) read as :class:`ModelTiles`."""
    flat = tree_flatten_with_paths(params)
    layer = {path for path, _ in flat if axes[path][:1] == ("layers",)}
    for path, x in flat:
        if path in layer and specs[path]:
            tile = tiles.get(path)
            stacked[id(x)] = (P(*specs[path][1:]),
                              None if tile is None else tuple(P(*t[1:]) for t in tile))
    rest = {path: x for path, x in flat if path not in layer}
    full = ShardedLayer(rest, {path: specs[path] for path in rest}, mesh,
                        {path: tiles[path] for path in rest if path in tiles}).gather()
    return _with_tiles(tree_map_with_paths(lambda path, x: full.get(path, x), params),
                       getattr(full, "tiles", {}), mesh)


def _with_tiles(tree: Any, kept: dict, mesh, prefix: str = "") -> Any:
    """``tree`` with every dict that holds a leaf of ``kept`` ({path: the
    spec of its "model" tile}) as :class:`ModelTiles`."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _with_tiles(v, kept, mesh, f"{prefix}{k}/") for k, v in tree.items()}
    mine = {k: kept[f"{prefix}{k}"] for k in tree if f"{prefix}{k}" in kept}
    return ModelTiles(out, mine, mesh) if mine else out


# ---------------------------------------------------------------------------
# serve on one device or a mesh: prefill & decode (the dry run's steps)
# ---------------------------------------------------------------------------


@dataclass
class StepBundle:
    """A step and what describes it, the reference's ``StepBundle``:
    ``fn`` (one rank's step), ``in_structs`` (its inputs as ``meta``
    structs, or small real tensors where their values matter: a decode
    step's positions), ``in_specs`` and ``out_specs`` (the partition specs
    of their tiles; None on one device), ``rules``, ``device`` and ``kind``.
    ``jit`` and ``lower()`` have no counterpart: :meth:`trace` runs one call
    under fake tensors and the cost counter (``runtime/cost_analysis.py``).
    ``load`` turns the rank's param tiles into the params the step takes
    (the serving steps keep the tiles, the layer weights cast to the
    compute dtype: no weight is gathered whole for the bundle's life)."""

    fn: Callable
    in_structs: tuple
    in_specs: Any
    out_specs: Any
    rules: ShardingRules | None
    device: torch.device
    kind: str
    load: Callable = field(default=lambda params: params, repr=False)

    def trace(self, *args, cost: bool = True, device: torch.device | str | None = None):
        """One call of ``fn`` on ``args`` (by default ``in_structs``) under
        fake tensors on ``device`` (the bundle's by default): (fake outputs,
        :class:`~repro_torch.runtime.cost_analysis.StepCost`), or the
        outputs alone without ``cost``."""
        from repro_torch.runtime.cost_analysis import trace_cost

        out, c = trace_cost(self.fn, *(args or self.in_structs), device=device or self.device)
        return (out, c) if cost else out


def _serving_zero(model: BaseModel, mesh) -> bool:
    """Serving shards weights over the batch axes too when the model-axis
    tile alone would not fit HBM (the 1T config); otherwise each rank keeps
    its "model" tiles, so that no step moves a weight matrix whole."""
    from repro_torch.utils.tree import tree_bytes

    per_chip = tree_bytes(model.param_struct()) / mesh.shape.get("model", 1)
    return per_chip > 8e9


def _tile_struct(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The ``meta`` struct of a rank's tile of ``x`` under ``spec``."""
    sl = shard_slices(spec, x.shape, mesh)
    shape = [len(range(*s.indices(d))) for s, d in zip(sl, x.shape)]
    return torch.empty(shape, dtype=x.dtype, device="meta")


def _tiles(tree: Any, specs: Any, mesh) -> Any:
    if isinstance(tree, dict):
        return {k: _tiles(tree[k], specs[k], mesh) for k in tree}
    return _tile_struct(tree, specs, mesh)


def serving_cache_specs(rules: ShardingRules, model: BaseModel, shape: ShapeConfig,
                        struct: Any) -> Any:
    """The serving cache's tile specs: rows over the batch axes and the K/V
    sequence over the "cache_seq" axes (``model.cache_axes``); tensor axes
    of the recurrent states (Mamba2's conv channels, "mlp") stay whole: the
    tensor-parallel products gather their outputs whole before the states
    are read (ROADMAP C15)."""
    def untensor(axes):
        if isinstance(axes, dict):
            return {k: untensor(v) for k, v in axes.items()}
        return tuple(None if a in TENSOR_AXES else a for a in axes)
    return rules.shardings(untensor(model.cache_axes(shape)), struct)


def _serving(model: BaseModel, shape: ShapeConfig, mesh, cache_len: int | None):
    """What the mesh prefill and decode steps share: (rules, the params'
    specs, the local-batch function, the weights' view). Every leaf stays
    the rank's tile of its spec for the bundle's life (ZeRO's too where the
    "model" tiles alone would not fit, ``rules.zero``). A decode step
    multiplies by the "model" tiles tensor-parallel (``models/common.py``
    ``column_products`` and ``row_product``), gathering only the small
    vectors it reads whole (``model.GATHERED_IN_DECODE``) and, with ZeRO,
    each layer's tiles over the data axes; a prefill step, whose sequence
    is sharded on "model", gathers each layer's tiles where the layer runs,
    but for the experts. Both take the embedding and head as vocab tiles."""
    zero = _serving_zero(model, mesh)
    rules = make_rules(mesh, shape, zero=zero)
    rules.cache_len = cache_len or shape.seq_len
    n_model, n_rows = rules.n_model, mesh.axis_size(rules.batch_axes)
    n_cache = mesh.axis_size(rules.cache_seq_axes(rules.cache_len))
    if rules.cache_len % n_cache:
        raise ValueError(f"a cache of {rules.cache_len} does not split over "
                         f"{rules.cache_seq_axes(rules.cache_len)} ({n_cache})")
    row_i = mesh.axis_index(rules.batch_axes) if rules.batch_axes else 0
    seq_i = mesh.axis_index("model") if n_model > 1 else 0
    split = ((row_i, n_rows), (seq_i, n_model) if shape.kind == "prefill" else (0, 1))

    def local(batch: dict) -> dict:
        """The rank's rows (and a prompt's sequence shard) of a global batch."""
        return model.local_batch(batch, *split)

    local(model.input_specs(shape))  # each input's own split: raises naming the one that does not
    nested = param_shardings(model, mesh, zero=zero)
    specs = flatten_specs(nested)
    axes = flatten_specs(model.param_axes())
    tiles = _kept_tiles(specs, axes,
                        model.GATHERED_IN_DECODE if shape.kind == "decode" else None)

    def view(params: Any) -> Any:
        rules.stacked = {}
        return _mesh_view(params, specs, axes, mesh, rules.stacked, tiles)

    return rules, nested, local, view


def _serving_structs(model: BaseModel, mesh, specs: Any) -> Any:
    """The params a serving step takes, as ``meta`` structs: the rank's
    tiles, in the serving dtypes."""
    return model.compute_params(_tiles(model.param_struct(), specs, mesh))


def build_prefill_step(model: BaseModel, shape: ShapeConfig, *, mesh=None,
                       device: torch.device | str | None = None,
                       cache_len: int | None = None) -> StepBundle:
    """Prefill of ``shape``'s prompts: ``fn(params, batch) -> (logits
    (B, 1, V_pad) f32 of the last position, cache)``, the cache ``cache_len``
    long (the prompt's length by default, as the reference's). On one
    ``device`` it is ``model.prefill``. On ``mesh`` every rank passes the
    whole batch and keeps its rows (over the batch axes) and its sequence
    shard (over "model"), as the train step does; the sharded attention,
    the sequence-parallel cores and the RoPE offset take the shard's
    context; each layer gathers its weights' tiles where it runs; the
    logits are the rank's rows' (the head's vocab tiles, gathered) and the
    cache its tile by :func:`serving_cache_specs`. ``params`` are what
    ``bundle.load`` makes of the rank's tiles."""
    if (mesh is None) == (device is None):
        raise ValueError("build_prefill_step takes a device or a mesh")
    batch_struct = model.input_specs(shape)
    if mesh is None:
        dev = resolve_device(device)

        @torch.no_grad()
        def prefill(params, batch):
            return model.prefill(params, shard_batch(batch, dev), cache_len=cache_len)

        return StepBundle(prefill, (model.compute_params(model.param_struct()), batch_struct),
                          None, None, None, dev, "prefill")
    rules, specs, local, view = _serving(model, shape, mesh, cache_len)
    dev = mesh.device

    @torch.no_grad()
    def prefill(params, batch):
        batch = local(shard_batch(batch, dev))
        with activation_rules(rules):
            return model.prefill(view(params), batch, cache_len=rules.cache_len)

    cache_shape = ShapeConfig(shape.name, rules.cache_len, shape.global_batch, "decode")
    out_specs = serving_cache_specs(rules, model, cache_shape, model.cache_struct(cache_shape))
    return StepBundle(prefill, (_serving_structs(model, mesh, specs), batch_struct),
                      (specs, model.input_axes(shape)), out_specs, rules, dev, "prefill",
                      model.compute_params)


def build_decode_step(model: BaseModel, shape: ShapeConfig, *, mesh=None,
                      device: torch.device | str | None = None) -> StepBundle:
    """One decode step at ``shape``: ``fn(params, cache, batch) -> (logits
    (B, 1, V_pad) f32, cache)``, the cache written in place; ``batch``:
    ``tokens`` (B, 1) and ``positions`` (B,). On one ``device`` it is
    ``model.decode``. On ``mesh`` every rank passes the whole batch and
    keeps its rows, and multiplies by its weights' "model" tiles
    (tensor-parallel: :func:`_serving`); ``cache`` is the rank's tile
    (:func:`serving_cache_specs`:
    the K/V sequence over the "cache_seq" axes, which take unused data axes
    too when the batch is too small for them; an enc-dec model's memory
    tiles as its self-attention cache). The self-attention cache is as long
    as ``model.cache_struct(shape)`` holds it: ``shape.seq_len``, or half
    of it for an enc-dec model, whose dry-run shapes split the budget
    between frames and tokens. The bundle's positions are the cache's last
    entry (a full cache, as the reference's decode reads every entry)."""
    if (mesh is None) == (device is None):
        raise ValueError("build_decode_step takes a device or a mesh")
    B = shape.global_batch
    cache_struct = model.cache_struct(shape)
    length = cache_struct["k"].shape[2] if "k" in cache_struct else shape.seq_len
    batch_struct = {**model.input_specs(shape),
                    "positions": torch.full((B,), length - 1, dtype=torch.int32)}
    if mesh is None:
        dev = resolve_device(device)

        @torch.no_grad()
        def decode(params, cache, batch):
            return model.decode(params, cache, shard_batch(batch, dev))

        return StepBundle(decode, (model.compute_params(model.param_struct()), cache_struct,
                                   batch_struct), None, None, None, dev, "decode")
    rules, specs, local, view = _serving(model, shape, mesh, length)
    dev = mesh.device
    cache_specs = serving_cache_specs(rules, model, shape, cache_struct)

    @torch.no_grad()
    def decode(params, cache, batch):
        batch = local(shard_batch(batch, dev))
        with activation_rules(rules):
            return model.decode(view(params), cache, batch)

    return StepBundle(decode, (_serving_structs(model, mesh, specs),
                               _tiles(cache_struct, cache_specs, mesh), batch_struct),
                      (specs, cache_specs, model.input_axes(shape)), cache_specs, rules, dev,
                      "decode", model.compute_params)


def build_step(model: BaseModel, shape: ShapeConfig, *, mesh=None,
               device: torch.device | str | None = None, **kw) -> StepBundle:
    """Dispatch on the shape kind (train, prefill, decode), as the
    reference's ``build_step``. A train bundle's ``fn(params, opt_state,
    batch)`` takes the rank's tiles (:func:`mesh_train_state`)."""
    if shape.kind == "prefill":
        return build_prefill_step(model, shape, mesh=mesh, device=device, **kw)
    if shape.kind == "decode":
        return build_decode_step(model, shape, mesh=mesh, device=device, **kw)
    return build_train_bundle(model, shape, mesh=mesh, device=device, **kw)


def build_train_bundle(model: BaseModel, shape: ShapeConfig, opt_cfg: OptimizerConfig | None = None,
                       *, mesh=None, device: torch.device | str | None = None,
                       grad_accum: int | None = None) -> StepBundle:
    """:func:`build_train_step` as a :class:`StepBundle`: its inputs are the
    rank's param and optimizer-state tiles and the global batch."""
    cfg = model.cfg
    opt = Optimizer(opt_cfg or OptimizerConfig(
        name=cfg.optimizer, moment_dtype=cfg.moment_dtype, first_moment=cfg.first_moment))
    fn = build_train_step(model, shape, opt.cfg, grad_accum=grad_accum, device=device, mesh=mesh)
    p_struct = model.param_struct()
    o_struct = opt.state_struct(p_struct)
    if mesh is None:
        return StepBundle(fn, (p_struct, o_struct, model.input_specs(shape)), None, None, None,
                          resolve_device(device), "train")
    specs = param_shardings(model, mesh)
    p_tiles = _tiles(p_struct, specs, mesh)
    o_specs = opt_state_shardings(model, opt, mesh)
    o_tiles = {k: (v if k == "step" else _tiles(v, o_specs[k], mesh)) for k, v in o_struct.items()}
    rules = make_rules(mesh, shape)
    return StepBundle(fn, (p_tiles, o_tiles, model.input_specs(shape)),
                      (specs, model.input_axes(shape)), specs, rules, mesh.device, "train")


# ---------------------------------------------------------------------------
# serve: paged prefill & decode
# ---------------------------------------------------------------------------


def _check_paged(model: BaseModel) -> None:
    """A VLM is refused too, as the JAX package refuses it: the paged steps
    take token prompts only, and would serve it with no patch embeddings."""
    if not getattr(model, "SUPPORTS_PAGED", False) or getattr(model, "is_vlm", False):
        raise ValueError(
            f"{type(model).__name__} does not support the paged serving path "
            "(needs last_pos prefill + the standard (L,B,S,KV,hd) cache dict)")


def build_paged_prefill_step(model: BaseModel, *, page_size: int) -> Callable:
    """Prefill that writes the prompt cache straight into pool pages.

    ``fn(params, k_pages, v_pages, tokens, last_pos, table) -> (next_tok,
    k_pages, v_pages)`` with ``tokens``: (B, S) rows right-padded to a
    bucket that is a multiple of ``page_size``, ``last_pos``: (B,) index of
    each row's true last prompt token, ``table``: (B, S // page_size)
    physical page ids covering each row's whole bucket (padding rows and
    columns point at scratch page 0). The pools are updated in place.
    """
    _check_paged(model)
    ps = int(page_size)

    def prefill(params, k_pages, v_pages, tokens, last_pos, table):
        B, S = tokens.shape
        logits, cache = model.prefill(params, {"tokens": tokens, "last_pos": last_pos})
        idx = table.reshape(-1).to(torch.long)

        # (L, B, S, KV, hd) -> (L, B * S/ps, ps, KV, hd): row-major, so page
        # blocks line up with the flattened table
        def to_pages(pages, dense):
            L, _, _, KV, hd = dense.shape
            pages.index_copy_(1, idx, dense.reshape(L, B * (S // ps), ps, KV, hd).to(pages.dtype))

        to_pages(k_pages, cache["k"])
        to_pages(v_pages, cache["v"])
        next_tok = first_argmax(logits[:, -1], dim=-1).to(torch.int32)  # (B,)
        return next_tok, k_pages, v_pages

    return prefill


def build_paged_decode_step(model: BaseModel, *, page_size: int, quantum: int = 1) -> Callable:
    """Decode over gathered pages, one call per scheduling quantum.

    With ``quantum=1``: ``fn(params, k_pages, v_pages, tokens, positions,
    table) -> (next_tok, k_pages, v_pages)`` with ``tokens``: (B, 1)
    current token per live row, ``positions``: (B,) write index (= live
    length) per row, ``table``: (B, max_pages) page ids padded with the
    scratch page 0. Gathers each row's logical context into a dense
    (B, max_pages * page_size) cache, runs ``model.decode`` on it, and
    writes only the new K/V entry back into the row's live page.

    With ``quantum=q > 1`` one call emits q greedy tokens per live row:
    ``fn(..., table, left) -> (tokens (B, q), k_pages, v_pages)`` where
    ``left``: (B,) tokens remaining in each row's budget. The pages are
    gathered once, q decode steps run against that dense cache, and the q
    new entries go back to the pool in one write; entries with
    ``s >= left[row]`` go to scratch page 0, so a row never writes past its
    reservation (the host discards its surplus tokens). Positions past the
    dense cache are clamped on the way back; their values are discarded.

    On CUDA tensors ``model.decode`` runs the decode-attention kernel;
    there is no switch like the JAX package's ``use_kernel``.
    """
    _check_paged(model)
    ps = int(page_size)
    q = max(int(quantum), 1)

    def gather(pages, table):
        B, mp = table.shape
        L, _, _, KV, hd = pages.shape
        return pages[:, table.to(torch.long)].reshape(L, B, mp * ps, KV, hd)

    def scatter(pages, dense, table, pos, write):
        """Write the entries at ``pos`` (B, n) of ``dense`` (L, B, S, KV, hd)
        into the pool; ``write`` False sends an entry to scratch page 0."""
        B, mp = table.shape
        L, _, S, KV, hd = dense.shape
        rows = torch.arange(B, device=pos.device)[:, None].expand_as(pos)
        tab = table.to(torch.long)
        pg = torch.where(write, tab[rows, torch.clamp(pos // ps, max=mp - 1)], 0)
        off = torch.where(write, pos % ps, 0)
        new = dense[:, rows, torch.clamp(pos, max=S - 1)]  # (L, B, n, KV, hd)
        pages[:, pg.reshape(-1), off.reshape(-1)] = new.reshape(L, -1, KV, hd).to(pages.dtype)

    if q == 1:
        def decode(params, k_pages, v_pages, tokens, positions, table):
            cache = {"k": gather(k_pages, table), "v": gather(v_pages, table)}
            logits, cache = model.decode(params, cache, {"tokens": tokens, "positions": positions})
            pos = positions.to(torch.long)[:, None]
            write = torch.ones_like(pos, dtype=torch.bool)
            scatter(k_pages, cache["k"], table, pos, write)
            scatter(v_pages, cache["v"], table, pos, write)
            next_tok = first_argmax(logits[:, -1], dim=-1).to(torch.int32)  # (B,)
            return next_tok, k_pages, v_pages
    else:
        def decode(params, k_pages, v_pages, tokens, positions, table, left):
            cache = {"k": gather(k_pages, table), "v": gather(v_pages, table)}
            tok, pos, toks = tokens, positions, []
            for _ in range(q):
                logits, cache = model.decode(params, cache, {"tokens": tok, "positions": pos})
                nt = first_argmax(logits[:, -1], dim=-1).to(torch.int32)
                toks.append(nt)
                tok, pos = nt[:, None], pos + 1
            steps = torch.arange(q, device=positions.device)[None, :]
            pos_q = positions.to(torch.long)[:, None] + steps  # (B, q)
            write = steps < left.to(torch.long)[:, None]
            scatter(k_pages, cache["k"], table, pos_q, write)
            scatter(v_pages, cache["v"], table, pos_q, write)
            return torch.stack(toks, dim=1), k_pages, v_pages  # (B, q)

    return decode
