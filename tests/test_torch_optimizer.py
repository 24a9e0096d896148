"""The port's optimizer (``repro_torch.runtime.optimizer``) against the JAX
package's (CPU), fed the same numpy params and grads: three steps of every
optimizer over a mixed tree, the schedules, clipping, and the state's
structure (paths, leaf order, shapes and dtypes, as checkpoints need).

The tree holds a stacked 3-D leaf of 8 x 512 x 1024 (big enough for the
reference's layerwise update, whose Adafactor clips each layer slice on its
own), a small 3-D leaf, a matrix and a vector. Tolerances: the same f32
elementwise arithmetic on both sides, but XLA may contract a multiply-add
into one rounding and sums its reductions in another order. So params to
1e-6 relative (plus 1e-7 absolute); f32 moments, norms and rates to 1e-5
relative plus 1e-6 of the leaf's largest |value| (a moment b1 m + (1 - b1)
g that nearly cancels keeps the few-ulp error of its terms); bf16 moments
to one bf16 step (2^-7 relative), since the f32 values rounded to them may
sit on either side of a rounding edge, and with them the params to lr x
2^-5: one bf16 step of a moment moves an update of |delta| <= 4 by 2^-7 of
itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.optimizer import Optimizer as JaxOptimizer
from repro.runtime.optimizer import OptimizerConfig as JaxConfig
from repro.runtime.optimizer import clip_by_global_norm as jax_clip
from repro.runtime.optimizer import global_norm as jax_global_norm
from repro.runtime.optimizer import lr_at as jax_lr_at
from repro.utils.tree import tree_flatten_with_paths as jax_paths
from repro_torch.runtime.optimizer import (
    Optimizer,
    OptimizerConfig,
    clip_by_global_norm,
    global_norm,
    lr_at,
)
from repro_torch.utils import tree_flatten_with_paths

torch.set_num_threads(1)

SHAPES = {"layers": {"w": (8, 512, 1024), "small": (2, 16, 24)}, "mat": (64, 48), "vec": (48,)}


def _tree(rng, scale=1.0):
    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (rng.normal(size=node) * scale).astype(np.float32)
    return make(SHAPES)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_trees(ours, theirs, rtol, atol=0.0, atol_scale=0.0, bf16_rtol=2.0 ** -7):
    """Leaf by leaf, in the JAX order: ``rtol`` relative plus ``atol``, plus
    ``atol_scale`` times the leaf's largest |value|."""
    o, t = tree_flatten_with_paths(ours), jax_paths(theirs)
    assert [p for p, _ in o] == [p for p, _ in t]
    for (path, a), (_, b) in zip(o, t):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
        assert tuple(a.shape) == tuple(b.shape), path
        rt = bf16_rtol if a.dtype == torch.bfloat16 else rtol
        tol = atol + atol_scale * float(np.abs(_np(b)).max(initial=0.0))
        np.testing.assert_allclose(_np(a), _np(b), rtol=rt, atol=tol, err_msg=path)


CASES = {
    "adamw": dict(name="adamw"),
    "adamw_bf16": dict(name="adamw", moment_dtype="bfloat16"),
    "adafactor": dict(name="adafactor"),
    "adafactor_no_m": dict(name="adafactor", first_moment=False),
    "sgd": dict(name="sgd"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_updates_match_jax(case):
    """Three steps, each with fresh grads (the second one clipped: its norm
    is above clip_norm): params, the whole state and the stats."""
    kw = dict(CASES[case], learning_rate=1e-2, warmup_steps=2, total_steps=10)
    ours, theirs = Optimizer(OptimizerConfig(**kw)), JaxOptimizer(JaxConfig(**kw))
    rng = np.random.default_rng(7)
    params = _tree(rng)
    tp, jp = _to_torch(params), jax.tree.map(jnp.asarray, params)
    ts, js = ours.init(tp), theirs.init(jp)
    update = jax.jit(theirs.update)
    p_atol = kw["learning_rate"] * 2.0 ** -5 if case == "adamw_bf16" else 1e-7
    for step, scale in enumerate((1e-4, 1e-2, 1e-5)):
        grads = _tree(rng, scale)
        tp_in = tp
        tp, ts, tstats = ours.update(_to_torch(grads), ts, tp)
        jp, js, jstats = update(jax.tree.map(jnp.asarray, grads), js, jp)
        assert tp is tp_in  # written in place
        _close_trees(tp, jp, rtol=1e-6, atol=p_atol)
        _close_trees(ts, js, rtol=1e-5, atol_scale=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_paths_shapes_and_dtypes_match_jax(case):
    """``init`` and ``state_struct`` (meta tensors) have the JAX state's
    leaf paths in its order, with its shapes and dtypes: a checkpoint of
    either restores in the other."""
    cfg = CASES[case]
    ours, theirs = Optimizer(OptimizerConfig(**cfg)), JaxOptimizer(JaxConfig(**cfg))
    params = _tree(np.random.default_rng(0))
    real = ours.init(_to_torch(params))
    meta = ours.state_struct({
        "layers": {k: torch.empty(s, device="meta") for k, s in SHAPES["layers"].items()},
        "mat": torch.empty(SHAPES["mat"], device="meta"),
        "vec": torch.empty(SHAPES["vec"], device="meta")})
    js = theirs.state_struct(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params))
    for state in (real, meta):
        o, t = tree_flatten_with_paths(state), jax_paths(js)
        assert [p for p, _ in o] == [p for p, _ in t]
        for (path, a), (_, b) in zip(o, t):
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
    assert meta["step"].device.type == "meta"
    assert all(float(x.abs().sum()) == 0 for _, x in tree_flatten_with_paths(real))


@pytest.mark.parametrize("schedule", ["cosine", "constant", "linear"])
def test_lr_schedules_match_jax(schedule):
    kw = dict(schedule=schedule, learning_rate=3e-4, warmup_steps=5, total_steps=40,
              min_lr_ratio=0.1)
    for step in [0, 1, 4, 5, 6, 17, 39, 40, 41, 100]:
        ours = lr_at(OptimizerConfig(**kw), torch.tensor(step, dtype=torch.int32))
        theirs = jax_lr_at(JaxConfig(**kw), jnp.int32(step))
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
    # zero warmup: max(warmup, 1) guards the division
    np.testing.assert_allclose(float(lr_at(OptimizerConfig(warmup_steps=0), torch.tensor(0))),
                               float(jax_lr_at(JaxConfig(warmup_steps=0), jnp.int32(0))),
                               rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Above the norm every leaf is scaled in its own dtype (a bf16 leaf
    stays bf16); below it nothing moves."""
    grads = _tree(np.random.default_rng(3), 1e-2)
    tg, jg = _to_torch(grads), jax.tree.map(jnp.asarray, grads)
    tg["vec"], jg["vec"] = tg["vec"].to(torch.bfloat16), jg["vec"].astype(jnp.bfloat16)
    (ours, onorm), (theirs, tnorm) = clip_by_global_norm(tg, max_norm), jax_clip(jg, max_norm)
    np.testing.assert_allclose(float(onorm), float(tnorm), rtol=1e-5)
    np.testing.assert_allclose(float(global_norm(tg)), float(jax_global_norm(jg)), rtol=1e-5)
    _close_trees(ours, theirs, rtol=1e-5)
    if max_norm > float(onorm):
        assert torch.equal(ours["mat"], tg["mat"])
