"""The port's multi-device layer on a 2 x 2 ("data", "model") mesh of
gloo ranks on the CPU, against the JAX package (one device, in this
process) or, where the reference's own test fails on this jax, against
the port's one-device step:

* the vocab-parallel cross-entropy, its gradient and the vocab-parallel
  embedding against the JAX package's dense loss and lookup (rtol 1e-5 on
  the summed loss, atol 1e-4 on the gradient, 1e-6 on the embedding:
  ``tests/test_distributed.py``'s);
* sharded attention ("allgather" for prefill and training, "flash" with the
  gradients of q, k and v) and ring attention, causal and not, against JAX
  ``naive_attention`` (3e-5, and 5e-5 on the gradients, the reference's);
* three steps of the mesh train step of the reduced smollm against the
  port's one-device step on the same weights and batches (the reference's
  ``test_small_mesh_train_step_runs`` fails on this jax): the loss, grad
  norm and rate to 1e-5 relative, every param's update to 1e-3 of its norm
  and its first moment to 1e-3 of its largest |value|, the tolerances of
  ``tests/test_torch_train.py``; each rank holds only its tile; one step
  of each other family likewise (the MoE, VLM and enc-dec families also
  against the JAX package's loss);
* a checkpoint saved from a (4,) "model" mesh restored onto the 2 x 2 mesh,
  each rank's tile bitwise.

One rank group runs every case once (a module-scoped fixture), its ranks
initialised from a ``file://`` store under the test's temporary directory.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_mesh_cases as cases

from repro.models.attention import naive_attention
from repro_torch.launch.mesh import spawn_ranks

B, S, D, V = 4, 32, 16, 64
H, KV, HD = 6, 3, 16
TRAIN_B, TRAIN_S = 4, 32


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "x": rng.standard_normal((B, S, D)).astype(f32),
        "head": (rng.standard_normal((V, D)) * 0.1).astype(f32),
        "targets": rng.integers(0, V, (B, S)).astype(np.int64),
        "mask": (rng.random((B, S)) < 0.9).astype(f32),
        "tokens": rng.integers(0, V, (B, S)).astype(np.int64),
        "q": rng.standard_normal((B, 64, H, HD)).astype(f32),
        "k": rng.standard_normal((B, 64, KV, HD)).astype(f32),
        "v": rng.standard_normal((B, 64, KV, HD)).astype(f32),
        "tokens_train": rng.integers(0, 512, (3, TRAIN_B, TRAIN_S)).astype(np.int32),
        "tokens_families": rng.integers(0, 512, (TRAIN_B, 64)).astype(np.int32),
        "w": np.arange(64.0, dtype=f32).reshape(8, 8),
    }


def _jax_family(name):
    from repro.configs.registry import get_arch as jax_get_arch
    from repro.models import build_model as jax_build_model

    return jax_build_model(jax_get_arch(name).reduced())


def _family_cases(inp):
    """The MoE, VLM and enc-dec families' mesh-step cases: JAX weights
    (the MoE router x100, as tests/test_torch_moe.py, so no top-k set hangs
    on rounding) and their batches."""
    rng = np.random.default_rng(3)
    tokens = inp["tokens_families"]
    out = {}
    for name, seq in (("phi3.5-moe-42b-a6.6b", 64), ("llava-next-mistral-7b", 80),
                      ("seamless-m4t-medium", 64)):
        p = _jax_family(name).init(jax.random.key(0))
        if "moe" in name:
            p["layers"]["router"] = p["layers"]["router"] * 100.0
        batch = {"tokens": tokens}
        if "llava" in name:
            batch["patch_embeds"] = rng.standard_normal((TRAIN_B, 16, 128)).astype(np.float32)
        if "seamless" in name:
            batch["frame_embeds"] = rng.standard_normal((TRAIN_B, 32, 128)).astype(np.float32)
        out[name] = {"arch": name, "overrides": {}, "seq_len": seq, "batch": batch,
                     "opt": {"learning_rate": 1e-3, "warmup_steps": 0},
                     "params": jax.tree.map(np.asarray, p)}
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    inp = _inputs()
    inp["family_cases"] = _family_cases(inp)
    res = spawn_ranks(cases.distributed_cases, 4, init_method=f"file://{d}/store",
                      args=(inp, str(d / "ckpt")), timeout=120)
    return inp, res


def _assemble(tiles, seq_dim=1):
    """Global array from the ranks' tiles: rank 2 d + m holds rows block d
    ("data") and sequence block m ("model")."""
    return np.concatenate([np.concatenate(tiles[2 * d:2 * d + 2], axis=seq_dim)
                           for d in range(2)], axis=0)


def test_mesh_coordinates_are_row_major(group):
    _, res = group
    assert [r["coords"] for r in res] == [{"data": d, "model": m} for d in range(2)
                                          for m in range(2)]
    assert all(r["local_mesh"] == {"data": 2, "model": 2} for r in res)  # make_local_mesh


def test_vocab_parallel_loss_and_embed_match_dense(group):
    inp, res = group
    x, head = jnp.asarray(inp["x"]), jnp.asarray(inp["head"])
    t, m = jnp.asarray(inp["targets"]), jnp.asarray(inp["mask"])

    def dense(x):
        logits = (x @ head.T).astype(jnp.float32)
        lse = jax.nn.logsumexp(logits, axis=-1)
        picked = jnp.take_along_axis(logits, t[..., None], -1)[..., 0]
        return ((lse - picked) * m).sum()

    tot = float(dense(x))
    for r in res:
        np.testing.assert_allclose(r["vocab"]["tot"], tot, rtol=1e-5)
        assert r["vocab"]["cnt"] == float(inp["mask"].sum())
    grad = _assemble([r["vocab"]["grad_x"] for r in res])
    np.testing.assert_allclose(grad, np.asarray(jax.grad(dense)(x)), atol=1e-4)
    emb = _assemble([r["vocab"]["embed"] for r in res])
    np.testing.assert_allclose(emb, inp["head"][inp["tokens"]], atol=1e-6)


@pytest.mark.parametrize("case", ["prefill/allgather", "train/allgather", "train/flash",
                                  "ring/True", "ring/False", "ring/train"])
def test_sharded_and_ring_attention_match_naive(group, case):
    inp, res = group
    causal = case != "ring/False"
    ref = naive_attention(*(jnp.asarray(inp[n]) for n in "qkv"), causal=causal)
    out = _assemble([r["attention"][case] for r in res])
    np.testing.assert_allclose(out, np.asarray(ref), atol=3e-5)


def test_sharded_attention_gradients_match_naive(group):
    inp, res = group
    q, k, v = (jnp.asarray(inp[n]) for n in "qkv")
    ref = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(naive_attention(q, k, v, causal=True))),
                   argnums=(0, 1, 2))(q, k, v)
    for i, g in enumerate(ref):
        got = _assemble([r["attention"]["grads"][i] for r in res])
        np.testing.assert_allclose(got, np.asarray(g), atol=5e-5)


def _one_device_steps(inp):
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_train_step
    from repro_torch.utils import tree_flatten_with_paths

    model = build_model(get_arch("smollm-135m").reduced())
    opt_cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=0)
    params = model.init(torch.Generator().manual_seed(0))
    init = {p: x.clone().numpy() for p, x in tree_flatten_with_paths(params)}
    state = Optimizer(opt_cfg).init(params)
    step = build_train_step(model, ShapeConfig("t", TRAIN_S, TRAIN_B, "train"), opt_cfg,
                            device="cpu")
    metrics = []
    for i in range(3):
        params, state, met = step(params, state, {"tokens": inp["tokens_train"][i]})
        metrics.append({k: float(v) for k, v in met.items()})
    return (init, metrics, {p: x.numpy() for p, x in tree_flatten_with_paths(params)},
            {p: x.numpy() for p, x in tree_flatten_with_paths(state["m"])})


def test_mesh_train_steps_match_the_one_device_step(group):
    inp, res = group
    init, metrics, params, moments = _one_device_steps(inp)
    for r in res:
        for got, want in zip(r["train"]["metrics"], metrics):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    mesh_params, mesh_m = res[0]["train"]["params"], res[0]["train"]["m"]
    assert sorted(mesh_params) == sorted(params)
    for path, want in params.items():
        du, dj = mesh_params[path] - init[path], want - init[path]
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), path
        np.testing.assert_allclose(mesh_m[path], moments[path], rtol=0,
                                   atol=1e-3 * float(np.abs(moments[path]).max(initial=0)),
                                   err_msg=path)
    # each rank stores only its tile: wqkv (L, d, qkv) is ZeRO-sharded on d
    # over "data" and on qkv over "model"; the embedding on vocab over "model"
    full = params["layers/wqkv"].shape
    for r in res:
        assert r["train"]["tiles"]["wqkv"].shape == (full[0], full[1] // 2, full[2] // 2)
        assert r["train"]["tiles"]["embed"].shape == (params["embed"].shape[0] // 2,
                                                      params["embed"].shape[1])


@pytest.mark.parametrize("name", ["rwkv6-3b", "zamba2-1.2b"])
def test_mesh_train_step_of_the_recurrent_families_matches_one_device(group, name):
    """One step of the reduced rwkv6 and zamba2 on the 2 x 2 mesh (each
    shard's token shift, WKV6 / SSD prefix, conv halo and RoPE offset come
    from the shards before it) against the one-device step, at the
    tolerances of the smollm case."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_train_step
    from repro_torch.utils import tree_flatten_with_paths

    inp, res = group
    tokens = inp["tokens_families"]
    model = build_model(get_arch(name).reduced())
    opt_cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=0)
    params = model.init(torch.Generator().manual_seed(1))
    init = {p: x.clone().numpy() for p, x in tree_flatten_with_paths(params)}
    state = Optimizer(opt_cfg).init(params)
    step = build_train_step(model, ShapeConfig("t", tokens.shape[1], tokens.shape[0], "train"),
                            opt_cfg, device="cpu")
    params, _, met = step(params, state, {"tokens": tokens})
    for r in res:
        got = r["families"][name]["metrics"]
        assert sorted(got) == sorted(met)
        for k, v in met.items():
            np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=k)
    mesh_params = res[0]["families"][name]["params"]
    for path, x in tree_flatten_with_paths(params):
        du, dj = mesh_params[path] - init[path], x.numpy() - init[path]
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), path


@pytest.mark.parametrize("name,item", [("phi3.5-moe-42b-a6.6b", "MoE"),
                                       ("llava-next-mistral-7b", "VLM"),
                                       ("seamless-m4t-medium", "enc-dec")])
def test_mesh_train_step_of_the_moe_vlm_and_encdec_families_matches(group, name, item):
    """One step of the reduced MoE, VLM and enc-dec families on the 2 x 2
    mesh from the JAX weights, at 64 tokens a row (the VLM's behind its 16
    patches: S = 80; the enc-dec model's beside 32 frames), against the
    port's one-device step (the smollm case's tolerances) and the JAX
    package's loss (1e-5 relative). ``tests/test_torch_mesh_families.py``
    holds these families' gradients, drops and shards in detail."""
    import jax.numpy as jnp
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_train_step
    from repro_torch.utils import tree_flatten_with_paths

    inp, res = group
    case = inp["family_cases"][name]
    model = build_model(get_arch(name).reduced())
    assert {"MoE": bool(model.cfg.n_experts), "VLM": model.cfg.frontend == "vision",
            "enc-dec": bool(model.cfg.n_enc_layers)}[item]
    opt_cfg = OptimizerConfig(**case["opt"])
    params = params_from_jax(case["params"], "cpu")
    init = {p: x.clone().numpy() for p, x in tree_flatten_with_paths(params)}
    state = Optimizer(opt_cfg).init(params)
    step = build_train_step(model, ShapeConfig("t", case["seq_len"], TRAIN_B, "train"), opt_cfg,
                            device="cpu")
    params, _, met = step(params, state, case["batch"])
    for r in res:
        got = r["families"][name]["metrics"]
        assert sorted(got) == sorted(met)
        for k, v in met.items():
            np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=k)
    mesh_params = res[0]["families"][name]["params"]
    for path, x in tree_flatten_with_paths(params):
        du, dj = mesh_params[path] - init[path], x.numpy() - init[path]
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), path
    jm = _jax_family(name)
    loss, _ = jm.loss(jax.tree.map(jnp.asarray, case["params"]),
                      jax.tree.map(jnp.asarray, case["batch"]))
    np.testing.assert_allclose(res[0]["families"][name]["metrics"]["loss"], float(loss),
                               rtol=1e-5)


def test_checkpoint_restores_onto_another_mesh(group):
    inp, res = group
    tiles = [r["restore"]["tile"] for r in res]
    for r, t in zip(res, tiles):
        np.testing.assert_array_equal(t, r["restore"]["want"])
    np.testing.assert_array_equal(np.concatenate(tiles), inp["w"])
    for r in res:
        for full in r["restore"]["gathered"]:
            np.testing.assert_array_equal(full, inp["w"])
