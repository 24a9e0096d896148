"""Optimizers (AdamW, Adafactor, SGD) + LR schedules + global-norm clipping.

Own copy of the JAX package's ``runtime/optimizer.py``. Parameters, grads
and optimizer state are nested dicts of tensors; the state is an explicit
dict, ``{"step", "m", "v"}`` (adamw), ``{"step", "v_row", "v_col"[, "m"]}``
(adafactor) or ``{"step"}`` (sgd), with ``step`` an int32 scalar on the
params' device. Leaves are visited in the JAX package's order
(``utils.tree_flatten_with_paths``: dict keys sorted), so the global norm
sums its leaves in the reference's order and a state checkpointed by either
package restores in the other.

:meth:`Optimizer.update` runs under ``torch.no_grad()`` and writes the new
params and moments **into the tensors it is given** (the port's counterpart
of the JAX step's ``donate_argnums``); it returns the same param tree and a
state dict holding the same moment trees and a new ``step``. Big stacked
leaves are updated one leading slice at a time, as the reference's
``lax.map`` does: that bounds the f32 temporaries, and Adafactor's update
clipping is taken per slice there, so the numbers are the reference's. The
update is plain PyTorch: the JAX package computes it outside any Pallas
kernel. ``state_axes`` gives the state's logical axes (each moment follows
its param; Adafactor's factored ``v_row``/``v_col`` strip the last or the
second-to-last axis); on a mesh the update runs on each rank's tiles with
the global grad norm passed in (``runtime/steps.py``). Adafactor's means
over a whole axis or leaf (the factored second moments, their
normalisation, the update clip's RMS) are then the tile's sums, ``psum``'d
over the mesh axes that split that axis, over the global length
(:class:`TileLayout`); its factored moments live as tiles of their own
specs, moved to the param tile's layout for the update and back; and the
layerwise update's choice reads the global leaf's shape, as on one device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models.common import torch_dtype
from repro_torch.utils.tree import tree_flatten_with_paths, tree_map_with_paths


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # "adamw" | "adafactor" | "sgd"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # "cosine" | "constant" | "linear"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # "float32" | "bfloat16"
    min_lr_ratio: float = 0.1
    first_moment: bool = True  # adafactor: False drops m entirely (1T configs)
    # update stacked-layer leaves one layer slice at a time: bounds the f32
    # temporaries to 1/L of the leaf instead of ~3x the leaf
    layerwise_update: bool = True


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), an f32 tensor beside it."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp(
            (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        else:  # linear
            decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    return cfg.learning_rate * warm * decay


def _leaves(tree: Any) -> list[torch.Tensor]:
    return [x for _, x in tree_flatten_with_paths(tree)]


def _leaf_sqnorm(x: torch.Tensor) -> torch.Tensor:
    # big stacked-layer leaves: one slice at a time (f32 temp / L), the
    # slices' sums added in order as the reference's lax.map(...).sum()
    if x.ndim >= 3 and x.numel() >= (1 << 22):
        return torch.stack([torch.sum(torch.square(s.to(torch.float32))) for s in x]).sum()
    return torch.sum(torch.square(x.to(torch.float32)))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 square sum, in the JAX order."""
    return torch.sqrt(sum(_leaf_sqnorm(x) for x in _leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    # scaled in each leaf's own dtype: no f32 copies of full leaves
    return tree_map_with_paths(lambda _, g: g * scale.to(g.dtype), tree), norm


def _axes_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every axis tuple of a nested dict of them."""
    if isinstance(tree, dict):
        return {k: _axes_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _decay_mask(p: torch.Tensor) -> bool:
    """Weight decay only on >=2D params (skip norms/biases/scalars)."""
    return p.ndim >= 2


@dataclass(frozen=True)
class TileLayout:
    """A leaf's tile on a mesh: the leaf's global ``shape`` (a layer
    slice's, for the layerwise update), the mesh axes each dim of the
    param's tile is split over (``dims``), and those of its Adafactor
    ``v_row`` and ``v_col`` tiles (``row``, ``col``: their own specs, which
    ZeRO may give other axes than the param's)."""

    mesh: Any
    shape: tuple
    dims: tuple
    row: tuple
    col: tuple

    @classmethod
    def of(cls, mesh, shape, spec, row_spec, col_spec) -> "TileLayout":
        def full(spec, n):
            return tuple(spec[i] if i < len(spec) else None for i in range(n))
        n = len(shape)
        n_row, n_col = (n - 1, n - 1) if n >= 2 else (n, 0)
        return cls(mesh, tuple(shape), full(spec, n), full(row_spec, n_row), full(col_spec, n_col))

    def slice0(self) -> "TileLayout":
        """The layout of one slice along the (unsplit) leading dim."""
        if self.dims[0] is not None:
            raise ValueError(f"the layerwise update slices dim 0, which is split: {self.dims}")
        return TileLayout(self.mesh, self.shape[1:], self.dims[1:], self.row[1:], self.col[1:])

    def mean(self, x: torch.Tensor, dim: int, *, rows: bool = False,
             keepdim: bool = False) -> torch.Tensor:
        """The global mean over ``dim`` of a tile in the param's layout
        (``rows``: in the param's without its last dim, as ``v_row``)."""
        from repro_torch.runtime.collectives import psum
        from repro_torch.runtime.sharding import _flat

        dims, shape = (self.dims[:-1], self.shape[:-1]) if rows else (self.dims, self.shape)
        s = x.sum(dim=dim, keepdim=keepdim)
        axes = _flat(dims[dim])
        if axes:
            s = psum(s, self.mesh, axes)
        return s / shape[dim]

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        """The global mean of a tile in the param's layout."""
        from repro_torch.runtime.collectives import psum
        from repro_torch.runtime.sharding import _flat

        s = x.sum()
        axes = tuple(a for d in self.dims for a in _flat(d))
        if axes:
            s = psum(s, self.mesh, axes)
        return s / math.prod(self.shape)

    def _param_dims(self, which: str) -> tuple:
        d = self.dims
        if len(d) < 2:
            return d if which == "row" else ()
        return d[:-1] if which == "row" else d[:-2] + d[-1:]

    def to_param(self, x: torch.Tensor, which: str) -> torch.Tensor:
        """A ``v_row``/``v_col`` tile (``which``) in the param tile's layout."""
        return _retile(x, getattr(self, which), self._param_dims(which), self.mesh)

    def to_state(self, x: torch.Tensor, which: str) -> torch.Tensor:
        return _retile(x, self._param_dims(which), getattr(self, which), self.mesh)


def _retile(x: torch.Tensor, src: tuple, dst: tuple, mesh) -> torch.Tensor:
    """A tile split by ``src`` (mesh axes per dim) as the tile split by
    ``dst``: the dims they split differently gathered, then cut."""
    if src == dst:
        return x
    from repro_torch.runtime.sharding import P, shard, unshard

    diff = [i for i in range(len(src)) if src[i] != dst[i]]
    whole = unshard(x, P(*(src[i] if i in diff else None for i in range(len(src)))), mesh)
    return shard(whole, P(*(dst[i] if i in diff else None for i in range(len(dst)))), mesh)


def _zeros(params: Any, shape: Callable, dtype: torch.dtype) -> Any:
    """Zeros of ``shape(p)`` for every leaf p, on the leaf's device."""
    return tree_map_with_paths(
        lambda _, p: torch.zeros(shape(p), dtype=dtype, device=p.device), params)


# ---------------------------------------------------------------------------


class Optimizer:
    """Stateless namespace bound to a config; state is an explicit dict."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    # -- state -------------------------------------------------------------

    def init(self, params: Any) -> dict:
        """Zero state on the params' device (``meta`` params give ``meta``
        state: :meth:`state_struct`)."""
        cfg = self.cfg
        mdt = torch_dtype(cfg.moment_dtype)
        step = torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device)
        same = lambda p: p.shape  # noqa: E731
        if cfg.name == "sgd":
            return {"step": step}
        if cfg.name == "adamw":
            return {"step": step, "m": _zeros(params, same, mdt), "v": _zeros(params, same, mdt)}
        if cfg.name == "adafactor":
            state = {
                "step": step,
                "v_row": _zeros(params, lambda p: p.shape[:-1] if p.ndim >= 2 else p.shape,
                                torch.float32),
                "v_col": _zeros(params, lambda p: p.shape[:-2] + p.shape[-1:] if p.ndim >= 2
                                else (), torch.float32),
            }
            if cfg.first_moment:
                state["m"] = _zeros(params, same, mdt)
            return state
        raise ValueError(cfg.name)

    def state_struct(self, param_struct: Any) -> dict:
        """The state of ``meta`` params, as ``meta`` tensors."""
        return self.init(param_struct)

    def state_axes(self, param_axes: Any) -> dict:
        """Logical axes of the state, from the params' axes."""
        cfg = self.cfg
        if cfg.name == "sgd":
            return {"step": ()}
        if cfg.name == "adamw":
            return {"step": (), "m": param_axes, "v": param_axes}
        axes = {"step": (),
                "v_row": _axes_map(lambda ax: tuple(ax[:-1]) if len(ax) >= 2 else tuple(ax),
                                   param_axes),
                "v_col": _axes_map(lambda ax: tuple(ax[:-2] + ax[-1:]) if len(ax) >= 2 else (),
                                   param_axes)}
        if cfg.first_moment:
            axes["m"] = param_axes
        return axes

    # -- update -------------------------------------------------------------

    @torch.no_grad()
    def update(self, grads: Any, state: dict, params: Any, *,
               grad_norm: torch.Tensor | None = None,
               tiles: dict | None = None) -> tuple[Any, dict, dict]:
        """One step: params and moments written in place; returns (params,
        new state, {"lr", "grad_norm"}) with the stats as device scalars.
        ``grad_norm``: the global norm where ``grads`` are one rank's tiles
        (a mesh step), else computed here from ``grads``; ``tiles``: there,
        each leaf's :class:`TileLayout` by path."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = lr_at(cfg, step)
        # clip folded into the (layerwise) update: g32 = g.to(f32) * gscale
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        gscale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        stats = {"lr": lr, "grad_norm": gnorm}
        p_leaves, g_leaves = _leaves(params), _leaves(grads)

        if cfg.name == "sgd":
            for p, g in zip(p_leaves, g_leaves):
                p.copy_(p.to(torch.float32) - lr * gscale * g.to(torch.float32))
            return params, {"step": step}, stats

        if cfg.name == "adamw":
            b1, b2 = cfg.b1, cfg.b2
            c1 = 1 - b1 ** step.to(torch.float32)
            c2 = 1 - b2 ** step.to(torch.float32)

            def upd(p, g, m, v, lay=None):
                g32 = g.to(torch.float32) * gscale
                m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
                v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
                mhat, vhat = m32 / c1, v32 / c2
                delta = mhat / (torch.sqrt(vhat) + cfg.eps)
                if _decay_mask(p):
                    delta = delta + cfg.weight_decay * p.to(torch.float32)
                p.copy_(p.to(torch.float32) - lr * delta)
                m.copy_(m32)
                v.copy_(v32)

            for leaf in zip(p_leaves, g_leaves, _leaves(state["m"]), _leaves(state["v"])):
                self._leafwise(upd)(*leaf)
            return params, {"step": step, "m": state["m"], "v": state["v"]}, stats

        if cfg.name == "adafactor":
            b2t = 1.0 - (step.to(torch.float32) ** -0.8)
            use_m = cfg.first_moment

            def upd(p, g, vr, vc, m=None, lay=None):
                # lay: a mesh tile's layout, whose means are the global ones
                mean = (lambda x, d, **kw: x.mean(dim=d, **kw)) if lay is None else lay.mean
                g32 = g.to(torch.float32) * gscale
                g2 = g32 * g32 + 1e-30
                vr_p = vr if lay is None else lay.to_param(vr, "row")
                if p.ndim >= 2:
                    vc_p = vc if lay is None else lay.to_param(vc, "col")
                    vr32 = b2t * vr_p + (1 - b2t) * mean(g2, -1)
                    vc32 = b2t * vc_p + (1 - b2t) * mean(g2, -2)
                    row_mean = (vr32.mean(dim=-1, keepdim=True) if lay is None
                                else lay.mean(vr32, -1, rows=True, keepdim=True))
                    denom = torch.clamp(row_mean, min=1e-30)
                    vhat = (vr32[..., :, None] / denom[..., None]) * vc32[..., None, :]
                else:
                    vr32 = b2t * vr_p + (1 - b2t) * g2
                    vc32 = vc
                    vhat = vr32
                u = g32 / torch.sqrt(vhat + cfg.eps)
                # update clipping (Adafactor §7)
                uu = torch.mean(u * u) if lay is None else lay.mean_all(u * u)
                rms_u = torch.sqrt(uu + 1e-30)
                u = u / torch.clamp(rms_u, min=1.0)
                if use_m:
                    u = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * u
                    m.copy_(u)
                delta = u
                if _decay_mask(p):
                    delta = delta + cfg.weight_decay * p.to(torch.float32)
                p.copy_(p.to(torch.float32) - lr * delta)
                vr.copy_(vr32 if lay is None else lay.to_state(vr32, "row"))
                if p.ndim >= 2:
                    vc.copy_(vc32 if lay is None else lay.to_state(vc32, "col"))

            trees = [state["v_row"], state["v_col"]] + ([state["m"]] if use_m else [])
            paths = [path for path, _ in tree_flatten_with_paths(params)]
            for path, leaf in zip(paths, zip(p_leaves, g_leaves, *(_leaves(t) for t in trees))):
                self._leafwise(upd)(*leaf, lay=None if tiles is None else tiles[path])
            new_state = {"step": step, "v_row": state["v_row"], "v_col": state["v_col"]}
            if use_m:
                new_state["m"] = state["m"]
            return params, new_state, stats

        raise ValueError(cfg.name)

    def _leafwise(self, upd: Callable) -> Callable:
        """Wrap a per-leaf in-place update to run one leading-dim slice at a
        time for big stacked-layer leaves (the reference's condition)."""
        if not self.cfg.layerwise_update:
            return upd

        def wrapped(p, g, *rest, lay=None):
            # the reference's test, on the global leaf's shape on a mesh
            shape = p.shape if lay is None else lay.shape
            big = len(shape) >= 3 and shape[0] >= 8 and math.prod(shape) >= (1 << 22)
            consistent = all(r.ndim >= 1 and r.shape[:1] == p.shape[:1] for r in rest)
            if big and g.shape == p.shape and consistent:
                sl = None if lay is None else lay.slice0()
                for i in range(p.shape[0]):
                    upd(p[i], g[i], *(r[i] for r in rest), lay=sl)
            else:
                upd(p, g, *rest, lay=lay)

        return wrapped
