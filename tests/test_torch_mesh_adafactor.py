"""Adafactor on a mesh: kimi-k2's optimizer (factored second moments,
``first_moment=False``) in the mesh train step on a 2 x 2 ("data",
"model") mesh of gloo ranks on the CPU, kimi-k2 reduced (4 experts top-2
and a shared one) from the JAX package's weights, against the JAX
package's one-device train step (its ``Optimizer.update`` on the JAX
gradients) and the port's one-device step.

Each rank holds its tiles of ``v_row`` and ``v_col`` by their own specs
(``runtime/steps.py`` ``opt_state_shardings``: ZeRO splits them on other
axes than their params, so the update moves them to the param tile's
layout and back), and the means over a whole axis or leaf run across the
tiles. The config is cut to 8 layers with d_ff 1024 so that the expert
leaves (8, 4, 128, 1024) hold 2^22 elements: the layerwise update clips
each layer on its own there, while a rank's tile (8, 2, 128, 512) alone
would not be "big"; the decision reads the global leaf, as on one device.

Tolerances are ``tests/test_torch_distributed.py``'s: the loss and grad
norm to 1e-5 relative, each param's update to 1e-3 of its norm, each
factored moment tile to 1e-3 of its leaf's largest |value|. A state
checkpointed whole restores onto the mesh by ``opt_state_shardings``,
each rank's tiles bitwise ``mesh_train_state``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.runtime.optimizer import Optimizer as JaxOptimizer
from repro.runtime.optimizer import OptimizerConfig as JaxOptConfig
from repro_torch.launch.mesh import spawn_ranks

torch.set_num_threads(1)

NAME = "kimi-k2-1t-a32b"
B, S = 4, 16
OVER = {"n_layers": 8, "d_ff": 1024}
OPT = {"name": "adafactor", "first_moment": False, "learning_rate": 1e-3, "warmup_steps": 0}


def _jax():
    m = jax_build_model(jax_get_arch(NAME).reduced(**OVER))
    p = m.init(jax.random.key(0))
    p["layers"]["router"] = p["layers"]["router"] * 100.0  # as tests/test_torch_moe.py
    return m, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_adafactor")
    rng = np.random.default_rng(12)
    case = {"arch": NAME, "overrides": OVER, "opt": OPT, "seq_len": S, "params": _jax()[1],
            "batch": {"tokens": rng.integers(1, 512, (B, S)).astype(np.int32)}}
    res = spawn_ranks(cases.mesh_adafactor_cases, 4, init_method=f"file://{d}/store",
                      args=({"case": case, "clip_scope": _clip_case()}, str(d / "ckpt")),
                      timeout=120)
    return case, res


def _clip_case() -> dict:
    """A stacked leaf of 8 layers and 2^22 elements and a norm; two steps of
    gradients, the second 30x larger in layer 0 only: its update clip binds
    in that layer's slice, not over the whole leaf."""
    rng = np.random.default_rng(13)
    f32 = np.float32
    params = {"w": (rng.standard_normal((8, 4, 128, 1024)) * 0.02).astype(f32),
              "n": np.ones(128, f32)}
    grads = []
    for i in range(2):
        g = {k: rng.standard_normal(v.shape).astype(f32) for k, v in params.items()}
        if i:
            g["w"][0] *= 30.0
        grads.append(g)
    return {"opt": OPT, "params": params, "grads": grads}


@pytest.fixture(scope="module")
def jax_step(ran):
    """The JAX package's one-device step: (metrics, params, state) numpy."""
    case, _ = ran
    jm, jp = _jax()
    params = jax.tree.map(jnp.asarray, jp)
    (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, jax.tree.map(jnp.asarray, case["batch"]))
    opt = JaxOptimizer(JaxOptConfig(**OPT))
    new, state, stats = opt.update(grads, opt.init(params), params)
    met = {"loss": float(loss), **{k: float(v) for k, v in stats.items()}}
    return met, jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, state)


def _flat(tree) -> dict:
    from repro.utils.tree import tree_flatten_with_paths

    return {p: np.asarray(x) for p, x in tree_flatten_with_paths(tree)}


def test_the_expert_leaves_are_big_only_as_a_whole():
    """The layerwise test (ndim >= 3, >= 8 layers, >= 2^22 elements) holds
    for the global expert leaves and fails for every rank's tile of them."""
    import math

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.sharding import flatten_specs, param_shardings, shard_slices
    from repro_torch.utils import tree_flatten_with_paths

    model = build_model(get_arch(NAME).reduced(**OVER))
    shapes = dict((p, tuple(x.shape)) for p, x in tree_flatten_with_paths(model.param_struct()))
    for rank in range(4):
        mesh = Mesh(shape={"data": 2, "model": 2}, rank=rank, device=torch.device("cpu"),
                    backend="gloo")
        specs = flatten_specs(param_shardings(model, mesh))
        for leaf in ("w_gate", "w_up", "w_down"):
            shape = shapes[f"layers/{leaf}"]
            tile = [len(range(*s.indices(d)))
                    for s, d in zip(shard_slices(specs[f"layers/{leaf}"], shape, mesh), shape)]
            assert shape[0] == 8 and math.prod(shape) >= 1 << 22, shape
            assert math.prod(tile) < 1 << 22, tile


def test_mesh_adafactor_step_matches_jax(ran, jax_step):
    case, res = ran
    met, params, state = jax_step
    init = _flat(case["params"])
    for r in res:
        got = r["step"]["metrics"]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], met[k], rtol=1e-5, err_msg=k)
    mesh_p = res[0]["step"]["params"]
    for path, want in _flat(params).items():
        du, dj = mesh_p[path] - init[path], want - init[path]
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), path


@pytest.mark.parametrize("which", ["v_row", "v_col"])
def test_factored_moment_tiles_are_the_jax_state_slices(ran, jax_step, which):
    """Each rank's tile of each factored moment against its slice of the
    JAX state after the step."""
    _, res = ran
    want = _flat(jax_step[2][which])
    for r in res:
        tiles = r["step"]["factored"][which]
        assert sorted(tiles) == sorted(want)
        for path, (tile, sl) in tiles.items():
            ref = want[path][tuple(slice(a, b) for a, b in sl)]
            assert tile.shape == ref.shape, path
            np.testing.assert_allclose(tile, ref, rtol=0,
                                       atol=1e-3 * float(np.abs(want[path]).max(initial=0)),
                                       err_msg=f"{which} {path}")


def test_mesh_adafactor_step_matches_the_one_device_step(ran):
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_train_step
    from repro_torch.utils import tree_flatten_with_paths

    case, res = ran
    model = build_model(get_arch(NAME).reduced(**OVER))
    opt = Optimizer(OptimizerConfig(**OPT))
    params = params_from_jax(case["params"], "cpu")
    init = {p: x.clone().numpy() for p, x in tree_flatten_with_paths(params)}
    params, state, met = build_train_step(model, ShapeConfig("t", S, B, "train"), opt.cfg,
                                          device="cpu")(params, opt.init(params), case["batch"])
    got = res[0]["step"]["metrics"]
    assert sorted(got) == sorted(met)
    for k, v in met.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=k)
    for path, x in tree_flatten_with_paths(params):
        du, dj = res[0]["step"]["params"][path] - init[path], x.numpy() - init[path]
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), path
    for which in ("v_row", "v_col"):
        for path, x in tree_flatten_with_paths(state[which]):
            tile, sl = res[0]["step"]["factored"][which][path]
            ref = x.numpy()[tuple(slice(a, b) for a, b in sl)]
            np.testing.assert_allclose(tile, ref, rtol=0,
                                       atol=1e-3 * float(np.abs(x.numpy()).max(initial=0)),
                                       err_msg=f"{which} {path}")


def test_an_adafactor_state_restores_onto_the_mesh(ran):
    _, res = ran
    for r in res:
        assert r["restore"]["bitwise"] and r["restore"]["leaves"] > 0


def test_the_layerwise_clip_takes_the_global_leaf_on_tiles(ran):
    """Two Adafactor updates of the clip case on the mesh's tiles (the leaf
    "big" as a whole, not as a tile) against the port's and the JAX
    package's one-device updates, each leaf's update to 1e-3 of its norm;
    the whole-leaf clip (``layerwise_update=False``) moves layer 0 by more
    than 100x that, so a tile-sized decision would fail."""
    import torch

    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig

    _, res = ran
    case = _clip_case()

    def port(layerwise: bool):
        opt = Optimizer(OptimizerConfig(**OPT, layerwise_update=layerwise))
        p = {k: torch.from_numpy(v.copy()) for k, v in case["params"].items()}
        s, out = opt.init(p), []
        for g in case["grads"]:
            p, s, _ = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, s, p)
            out.append({k: v.clone().numpy() for k, v in p.items()})
        return out

    jopt = JaxOptimizer(JaxOptConfig(**OPT))
    jp = {k: jnp.asarray(v) for k, v in case["params"].items()}
    js, jax_out = jopt.init(jp), []
    for g in case["grads"]:
        jp, js, _ = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jax_out.append({k: np.asarray(v) for k, v in jp.items()})
    one, whole = port(True), port(False)
    for step in range(2):
        for k, start in case["params"].items():
            dj = one[step][k] - start
            for name, got in (("mesh", res[0]["clip_scope"][step][k]), ("jax", jax_out[step][k])):
                assert np.linalg.norm(got - start - dj) <= 1e-3 * np.linalg.norm(dj), \
                    (name, step, k)
    d0 = one[1]["w"][0] - case["params"]["w"][0]
    assert np.linalg.norm(whole[1]["w"][0] - one[1]["w"][0]) > 0.1 * np.linalg.norm(d0)

