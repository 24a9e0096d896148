"""The port's sharding rules (``runtime/sharding.py``) against the JAX
package's on the same duck-typed mesh: the seven cases of
``tests/test_sharding_rules.py``, spec for spec, and ``param_shardings``
of all ten archs on the (16, 16) and (2, 16, 16) meshes (the port's own
param axes, so these also hold the port's ``ParamSpec`` axes to the
reference's). A spec is compared entry for entry: the port's ``P`` is a
tuple, the reference's ``PartitionSpec`` iterates the same entries.
Also: the optimizer state's axes, the inputs' and caches' axes, a tile of
a spec and the production mesh shapes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.runtime.optimizer import Optimizer as JaxOptimizer
from repro.runtime.optimizer import OptimizerConfig as JaxOptConfig
from repro.runtime.sharding import ShardingRules as JaxRules
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
from repro_torch.runtime.sharding import (
    P,
    ShardingRules,
    activation_rules,
    constrain,
    flatten_specs,
    param_shardings,
    shard_slices,
)
from repro_torch.runtime.steps import _shard_tree, make_rules


class FakeMesh:
    """Duck-typed mesh exposing .shape (rules only need axis sizes)."""

    def __init__(self, shape: dict):
        self.shape = shape


MESH2 = {"data": 16, "model": 16}
MESH3 = {"pod": 2, "data": 16, "model": 16}


def _same(port, jax_spec):
    assert tuple(port) == tuple(jax_spec), (port, jax_spec)


def _pair(shape, batch_axes=(), zero=True, kind="train"):
    return (ShardingRules(mesh=FakeMesh(shape), batch_axes=batch_axes, zero=zero, kind=kind),
            JaxRules(mesh=FakeMesh(shape), batch_axes=batch_axes, zero=zero, kind=kind))


def test_tensor_axes_shard_on_model_when_divisible():
    r, j = _pair(MESH2)
    for args in ((("embed", "mlp"), (4096, 14336)), ((None, "mlp"), (7, 100))):
        _same(r.spec(*args), j.spec(*args))
    assert r.spec(("embed", "mlp"), (4096, 14336)) == P(None, "model")
    assert r.spec((None, "mlp"), (7, 100)) == P()


def test_zero_takes_largest_free_dim():
    r, j = _pair(MESH3)
    args = (("layers", "embed", "qkv"), (32, 4096, 6144))
    _same(r.spec(*args, is_param=True), j.spec(*args, is_param=True))
    assert r.spec(*args, is_param=True) == P(None, ("pod", "data"), "model")


def test_zero_skips_vocab_params():
    r, j = _pair(MESH3)
    args = (("vocab", "embed"), (32000, 4096))
    _same(r.spec(*args, is_param=True), j.spec(*args, is_param=True))
    assert r.spec(*args, is_param=True) == P("model")


@pytest.mark.parametrize("kind,batch", [("train", 256), ("decode", 16), ("decode", 1)])
def test_batch_trimming(kind, batch):
    r = ShardingRules.for_shape(FakeMesh(MESH3), kind=kind, global_batch=batch)
    j = JaxRules.for_shape(FakeMesh(MESH3), kind=kind, global_batch=batch)
    assert r.batch_axes == j.batch_axes
    assert r.batch_axes == {256: ("pod", "data"), 16: ("data",), 1: ()}[batch]


@pytest.mark.parametrize("batch,shape", [(1, (32, 1, 524288, 8, 128)),
                                         (128, (32, 128, 32768, 8, 128))])
def test_cache_seq_takes_unused_batch_axes(batch, shape):
    r = ShardingRules.for_shape(FakeMesh(MESH3), kind="decode", global_batch=batch)
    j = JaxRules.for_shape(FakeMesh(MESH3), kind="decode", global_batch=batch)
    axes = ("layers", "batch", "cache_seq", None, None)
    _same(r.spec(axes, shape), j.spec(axes, shape))


def test_no_mesh_axis_reuse_within_spec():
    r, j = _pair(MESH2)
    args = (("vocab", "mlp"), (32000, 4096))
    _same(r.spec(*args), j.spec(*args))
    assert r.spec(*args) == P("model")


@pytest.mark.parametrize("mesh", [MESH2, MESH3], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_param_shardings_match_jax_for_every_arch(mesh, name):
    """Every param of every full-size arch: the port's spec is the
    reference's, and every sharded dim divides."""
    model = build_model(get_arch(name))
    jmodel = jax_build_model(JAX_ARCHS[name])
    ours = flatten_specs(param_shardings(model, FakeMesh(mesh)))
    # the reference's param_shardings wraps these specs in NamedShardings of
    # a real mesh; its test takes them from the rules directly, as here
    rules = JaxRules(mesh=FakeMesh(mesh), batch_axes=())
    axes = jax.tree.leaves(jmodel.param_axes(), is_leaf=lambda x: isinstance(x, tuple))
    theirs = [rules.spec(a, st.shape, is_param=True)
              for a, st in zip(axes, jax.tree.leaves(jmodel.param_struct()))]
    assert len(ours) == len(theirs)
    theirs = dict(zip(ours, theirs))
    structs = flatten_specs(model.param_struct())
    for path, spec in ours.items():
        _same(spec, theirs[path])
        for dim, entry in zip(structs[path].shape, tuple(spec)):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            assert dim % int(np.prod([mesh[a] for a in axes])) == 0, (name, path, spec)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_state_axes_match_jax(name):
    cfg = get_arch("smollm-135m")
    model, jmodel = build_model(cfg), jax_build_model(JAX_ARCHS["smollm-135m"])
    ours = Optimizer(OptimizerConfig(name=name)).state_axes(model.param_axes())
    theirs = JaxOptimizer(JaxOptConfig(name=name)).state_axes(jmodel.param_axes())
    assert ours == theirs


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_input_and_cache_axes_match_jax(name, kind):
    model, jmodel = build_model(get_arch(name)), jax_build_model(JAX_ARCHS[name])
    shape, jshape = ShapeConfig("s", 4096, 8, kind), JaxShape("s", 4096, 8, kind)
    assert model.input_axes(shape) == jmodel.input_axes(jshape)
    ours = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in model.input_specs(shape).items()}
    theirs = {k: (tuple(v.shape), str(v.dtype)) for k, v in jmodel.input_specs(jshape).items()}
    assert ours == theirs
    assert model.cache_axes(shape) == jmodel.cache_axes(jshape)


class _Coords(FakeMesh):
    def __init__(self, shape, coords):
        super().__init__(shape)
        self.coords = coords

    def axis_index(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def test_a_ranks_tile_of_a_spec():
    mesh = _Coords({"data": 2, "model": 4}, {"data": 1, "model": 2})
    x = torch.arange(8 * 16).reshape(8, 16)
    sl = shard_slices(P(("data", "model"), None), x.shape, mesh)
    assert torch.equal(x[sl], x[6:7])  # row-major over (data, model): 1 * 4 + 2
    sl = shard_slices(P("model", "data"), x.shape, mesh)
    assert torch.equal(x[sl], x[4:6, 8:16])


@pytest.mark.parametrize("kind,batch,seq", [("train", 256, 4096), ("decode", 16, 32768)])
def test_input_and_cache_shardings_match_jax(kind, batch, seq):
    """``make_rules`` and ``_shard_tree`` over a model's inputs and cache,
    as the reference's step builders place them, spec for spec."""
    model, jmodel = build_model(get_arch("qwen3-14b")), jax_build_model(JAX_ARCHS["qwen3-14b"])
    shape, jshape = ShapeConfig("s", seq, batch, kind), JaxShape("s", seq, batch, kind)
    rules = make_rules(FakeMesh(MESH3), shape)
    jrules = JaxRules.for_shape(FakeMesh(MESH3), kind=kind, global_batch=batch)
    pairs = ((_shard_tree(rules, model.input_axes(shape), model.input_specs(shape)),
              jmodel.input_axes(jshape), jmodel.input_specs(jshape)),
             (_shard_tree(rules, model.cache_axes(shape), model.cache_struct(shape)),
              jmodel.cache_axes(jshape), jmodel.cache_struct(jshape)))
    for ours, jaxes, jstructs in pairs:  # the reference's specs, before its NamedSharding
        assert set(ours) == set(jaxes)
        for k in ours:
            _same(ours[k], jrules.spec(jaxes[k], jstructs[k].shape))


def test_constrain_checks_the_local_share():
    """No GSPMD to hint: under the rules, ``constrain`` takes a tensor that
    is the spec's share of the global shape and refuses any other; outside
    them it passes anything."""
    rules = ShardingRules(mesh=FakeMesh({"data": 2, "model": 4}), batch_axes=("data",))
    x = torch.zeros(4, 32, 16)
    assert constrain(x, ("batch", "seq", None), (8, 128, 16)) is x  # outside the rules
    with activation_rules(rules):
        assert constrain(x, ("batch", "seq", None), (8, 128, 16)) is x
        with pytest.raises(ValueError, match="share"):
            constrain(x, ("batch", "seq", None), (8, 64, 16))


def test_production_mesh_shapes():
    assert make_production_mesh().shape == MESH2
    assert make_production_mesh(multi_pod=True).shape == MESH3
