"""The MoE, VLM and enc-dec families' mesh train step (``runtime/steps.py``
``build_mesh_train_step``) on a 2 x 2 ("data", "model") mesh of gloo ranks
on the CPU, from the JAX package's weights (``params_from_jax``), against
the JAX package's one-device loss and gradients and the port's one-device
step:

* phi3.5-moe reduced at ``capacity_factor`` 1.0 (``reduced()``'s 4.0 never
  drops), B = 4, S = 16: groups of 16 tokens over sequence shards of 8, so
  every group spans both "model" ranks and a token's slot counts the
  group's tokens on the other rank; tokens are dropped (asserted), and the
  same step with each rank blind to the other's counts fails the
  comparison. The router is scaled x100 (``tests/test_torch_moe.py``'s
  ROUTER_SCALE) so no top-k set hangs on the frameworks' rounding;
* llava-next reduced: 16 patches and 12 text tokens, S = 28 in shards of
  14, so the first "model" rank of each row holds only patches;
* seamless-m4t reduced: 32 frames and 16 tokens, each split over "model"
  (the encoder's non-causal sharded attention, the decoder's
  cross-attention over the gathered memory at Sq != Skv).

Tolerances are ``tests/test_torch_distributed.py``'s: the metrics (loss,
its parts, grad norm, rate) to 1e-5 relative, each param's update to 1e-3
of its norm, each first moment (0.1 x the clipped gradient after one
AdamW step) to 1e-3 of its leaf's largest |value|; the same moment against
the JAX gradient times 0.1 x the clip scale, and the loss against the JAX
loss to 1e-5 relative.

One rank group runs every case once (a module-scoped fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.launch.mesh import spawn_ranks

torch.set_num_threads(1)

B = 4
ROUTER_SCALE = 100.0
OPT = {"learning_rate": 1e-3, "warmup_steps": 0}
CASES = {
    "phi3.5-moe-42b-a6.6b": ({"capacity_factor": 1.0}, 16),
    "llava-next-mistral-7b": ({}, 28),
    "seamless-m4t-medium": ({}, 32),
}


def _batch(name: str, rng) -> dict:
    tokens = rng.integers(1, 512, (B, 12 if "llava" in name else 16)).astype(np.int32)
    if "llava" in name:
        return {"tokens": tokens, "patch_embeds": rng.standard_normal((B, 16, 128)).astype(
            np.float32)}
    if "seamless" in name:
        return {"tokens": tokens, "frame_embeds": rng.standard_normal((B, 32, 128)).astype(
            np.float32)}
    return {"tokens": tokens}


def _jax(name: str):
    over, _ = CASES[name]
    m = jax_build_model(jax_get_arch(name).reduced(**over))
    p = m.init(jax.random.key(0))
    if "moe" in name:
        p["layers"]["router"] = p["layers"]["router"] * ROUTER_SCALE
    return m, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_families")
    rng = np.random.default_rng(11)
    inp = {"cases": {}}
    for name, (over, seq) in CASES.items():
        inp["cases"][name] = {"arch": name, "overrides": over, "opt": OPT, "seq_len": seq,
                              "params": _jax(name)[1], "batch": _batch(name, rng)}
    res = spawn_ranks(cases.mesh_family_cases, 4, init_method=f"file://{d}/store",
                      args=(inp,), timeout=120)
    return inp, res


def _one_device(case: dict):
    """The port's one-device step from the same weights and batch:
    (initial params, metrics, params, first moments) as numpy."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_train_step
    from repro_torch.utils import tree_flatten_with_paths

    model = build_model(get_arch(case["arch"]).reduced(**case["overrides"]))
    opt = Optimizer(OptimizerConfig(**case["opt"]))
    params = params_from_jax(case["params"], "cpu")
    init = {p: x.clone().numpy() for p, x in tree_flatten_with_paths(params)}
    state = opt.init(params)
    shape = ShapeConfig("t", case["seq_len"], B, "train")
    params, state, met = build_train_step(model, shape, opt.cfg, device="cpu")(
        params, state, case["batch"])
    return (init, {k: float(v) for k, v in met.items()},
            {p: x.numpy() for p, x in tree_flatten_with_paths(params)},
            {p: x.numpy() for p, x in tree_flatten_with_paths(state["m"])})


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_the_one_device_step(ran, name):
    inp, res = ran
    init, met, params, moments = _one_device(inp["cases"][name])
    for r in res:
        got = r[name]["metrics"]
        assert sorted(got) == sorted(met)
        for k in met:
            np.testing.assert_allclose(got[k], met[k], rtol=1e-5, err_msg=f"{name} {k}")
    mesh_p, mesh_m = res[0][name]["params"], res[0][name]["m"]
    assert sorted(mesh_p) == sorted(params)
    for path, want in params.items():
        du, dj = mesh_p[path] - init[path], want - init[path]
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), (name, path)
        np.testing.assert_allclose(mesh_m[path], moments[path], rtol=0,
                                   atol=1e-3 * float(np.abs(moments[path]).max(initial=0)),
                                   err_msg=f"{name} {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_the_jax_loss_and_gradients(ran, name):
    """The mesh step's loss (and the MoE aux loss) against the JAX
    package's on one device; its first moments, 0.1 x the clip scale x the
    gradient, against the JAX gradient the same way."""
    from repro.utils.tree import tree_flatten_with_paths as jax_paths

    inp, res = ran
    case = inp["cases"][name]
    jm, jp = _jax(name)
    (loss, jmet), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, case["batch"]))
    got = res[0][name]["metrics"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for k in ("ce_loss", "aux_loss"):
        if k in jmet:
            np.testing.assert_allclose(got[k], float(jmet[k]), rtol=1e-5, err_msg=k)
    scale = 0.1 * min(1.0, 1.0 / got["grad_norm"])
    mesh_m = res[0][name]["m"]
    for path, g in jax_paths(grads):
        g = np.asarray(g)
        np.testing.assert_allclose(mesh_m[path] / scale, g, rtol=0,
                                   atol=1e-3 * float(np.abs(g).max(initial=0)),
                                   err_msg=f"{name} {path}")


def test_moe_groups_span_the_shards_drop_tokens_and_need_the_other_rank(ran):
    """Each of the 4 ranks routes its 2 rows x 8 positions (2 layers, top-2);
    some choices drop (the capacity binds); a step whose slots ignore the
    other "model" rank's earlier tokens of the group no longer matches."""
    inp, res = ran
    name = "phi3.5-moe-42b-a6.6b"
    routed = sum(r[name]["routed"] for r in res)
    kept = sum(r[name]["kept"] for r in res)
    assert routed == 2 * B * 16 * 2  # layers x tokens x top-2, each token once
    assert kept < routed, (kept, routed)
    _, met, _, _ = _one_device(inp["cases"][name])
    blind = res[0][name]["own_counts_only"]
    assert abs(blind["loss"] - met["loss"]) > 100 * 1e-5 * abs(met["loss"]), (blind, met)


def test_vlm_rank_of_patches_only(ran):
    """The first "model" rank of each row block holds 14 patches and no
    text (its share of the tokens is empty), the second 2 patches and the
    12 text tokens; both ranks' losses are the global one."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    inp, res = ran
    model = build_model(get_arch("llava-next-mistral-7b").reduced())
    batch = {k: torch.from_numpy(v) for k, v in inp["cases"]["llava-next-mistral-7b"]["batch"]
             .items()}
    first = model.local_batch(batch, (0, 2), (0, 2))
    second = model.local_batch(batch, (0, 2), (1, 2))
    assert first["tokens"].shape == (2, 0) and first["patch_embeds"].shape == (2, 14, 128)
    assert second["tokens"].shape == (2, 12) and second["patch_embeds"].shape == (2, 2, 128)
    losses = {r["llava-next-mistral-7b"]["metrics"]["loss"] for r in res}
    assert len(losses) == 1


def test_a_batch_that_does_not_split_is_refused_naming_the_input():
    """The mesh step checks each input's own split where it is built:
    seamless's 15 frames (and 15 tokens) of a 30-long shape over 2 "model"
    ranks fail, the frames named; llava's [16 patches; 13 tokens] too; a
    call's batch is checked the same way (frames of 30 over 4 ranks)."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.steps import build_train_step

    mesh = Mesh(shape={"data": 2, "model": 2}, rank=0, device=torch.device("cpu"),
                backend="gloo")
    encdec = build_model(get_arch("seamless-m4t-medium").reduced())
    with pytest.raises(ValueError, match="frame_embeds"):
        build_train_step(encdec, ShapeConfig("t", 30, 4, "train"), mesh=mesh)
    vlm = build_model(get_arch("llava-next-mistral-7b").reduced())
    with pytest.raises(ValueError, match="29 positions"):
        build_train_step(vlm, ShapeConfig("t", 29, 4, "train"), mesh=mesh)
    with pytest.raises(ValueError, match="3 rows"):  # 6 rows in 2 microbatches over 2 ranks
        build_train_step(vlm, ShapeConfig("t", 28, 6, "train"), mesh=mesh, grad_accum=2)
    build_train_step(vlm, ShapeConfig("t", 28, 4, "train"), mesh=mesh)  # splits
    with pytest.raises(ValueError, match="frame_embeds"):
        encdec.local_batch({"tokens": torch.zeros((4, 16), dtype=torch.int32),
                            "frame_embeds": torch.zeros((4, 30, 128))}, (0, 2), (0, 4))
