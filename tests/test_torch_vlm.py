"""The port's VLM branch of ``DecoderLM`` (llava-next's Mistral backbone and
its stub vision frontend) against the JAX package's (CPU), on the same
weights (``params_from_jax``) and patch embeddings.

Tolerances: f32 at ``tests/test_models.py``'s atol 2e-4, rtol 2e-3
(logits, loss, caches); bf16 compute 4e-2 of the largest value compared,
as ``tests/test_torch_models.py`` holds the dense family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.miniapps import LMServeApp
from repro_torch.models import build_model, params_from_jax, tree_to_numpy
from repro_torch.models.transformer import attn_block_specs
from repro_torch.runtime.steps import build_paged_decode_step, build_paged_prefill_step
from repro_torch.serving import ContinuousBatcher

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

NAME = "llava-next-mistral-7b"
P = 16  # reduced() keeps 16 of the 576 patches


def _pair(**overrides):
    jm = jax_build_model(jax_get_arch(NAME).reduced(**overrides))
    tm = build_model(get_arch(NAME).reduced(**overrides))
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32), **tol)


def _tol(compute_dtype, *refs):
    if compute_dtype == "float32":
        return {"atol": 2e-4, "rtol": 2e-3}
    return {"atol": 4e-2 * max(float(np.abs(np.asarray(r, np.float32)).max()) for r in refs),
            "rtol": 0}


def _batch(B=2, T=12, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, 512, (B, T)).astype(np.int32),
            "patch_embeds": rng.normal(size=(B, P, 128)).astype(np.float32)}


def test_param_specs_match_jax_at_full_width():
    """Every leaf's shape and storage dtype on the abstract full-size model
    (meta tensors), ``vision_proj`` among them, and the parameter count."""
    j = dict(_flat(jax_build_model(jax_get_arch(NAME)).param_struct()))
    t = dict(_flat(build_model(get_arch(NAME)).param_struct()))
    assert sorted(j) == sorted(t) and "/vision_proj" in t
    for key in j:
        assert tuple(j[key].shape) == tuple(t[key].shape), key
        assert str(j[key].dtype) == str(t[key].dtype).removeprefix("torch."), key
        assert t[key].device.type == "meta"
    assert get_arch(NAME).param_count() == jax_get_arch(NAME).param_count()
    tm = build_model(get_arch(NAME))
    assert tm.is_vlm and not tm.is_moe and get_arch(NAME).n_patches == 576


def test_attn_block_specs_take_an_input_width():
    """``d_in`` widens the qkv projection's input only (Zamba's shared
    block reads concat(x, x0)); the output stays d_model wide."""
    cfg = get_arch("zamba2-1.2b")
    s = attn_block_specs(cfg, None, torch.bfloat16, d_in=2 * cfg.d_model)
    assert s["wqkv"].shape == (4096, 3 * 32 * 64) and s["wo"].shape == (32 * 64, 2048)
    assert attn_block_specs(cfg, 3, torch.float32)["wqkv"].shape == (3, 2048, 3 * 32 * 64)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips_every_leaf(param_dtype):
    _, jp, _, tp = _pair(param_dtype=param_dtype)
    j, t = dict(_flat(jax.tree.map(np.asarray, jp))), dict(_flat(tp))
    back = dict(_flat(tree_to_numpy(tp)))
    assert sorted(j) == sorted(t) == sorted(back)
    for key, arr in j.items():
        assert tuple(t[key].shape) == arr.shape, key
        assert back[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(back[key].astype(np.float32), arr.astype(np.float32))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_loss_prefill_and_decode_match_jax(compute_dtype):
    """The loss (its text states start after the patches), the prefill's
    logits (at the last position and at ``last_pos``, both counting the
    patches) and cache, grown to ``cache_len`` (which counts them too), and
    one decode step at position P + T."""
    jm, jp, tm, tp = _pair(compute_dtype=compute_dtype)
    tp = tm.compute_params(tp)
    batch = _batch()
    jb, tb = jax.tree.map(jnp.asarray, batch), {k: _t(v) for k, v in batch.items()}
    jl, _ = jax.jit(jm.loss)(jp, jb)
    tl, metrics = tm.loss(tp, tb)
    assert float(metrics["tokens"]) == 2 * 11
    _close(tl, jl, _tol(compute_dtype, jl))
    last = np.array([P + 11, P + 4], np.int32)
    jlog, jc = jax.jit(jm.prefill)(jp, jb)
    jlast, _ = jax.jit(jm.prefill)(jp, dict(jb, last_pos=jnp.asarray(last)))
    tlog, tc = tm.prefill(tp, tb, cache_len=P + 13)
    tlast, _ = tm.prefill(tp, dict(tb, last_pos=_t(last)))
    _close(tlog, jlog, _tol(compute_dtype, jlog))
    _close(tlast, jlast, _tol(compute_dtype, jlast))
    assert tc["k"].shape == (2, 2, P + 13, 2, 32) and not bool(tc["k"][:, :, P + 12:].any())
    _close(tc["v"][:, :, :P + 12], jc["v"], _tol(compute_dtype, jc["v"]))
    grown = {k: jnp.pad(jc[k], [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]) for k in ("k", "v")}
    step = {"tokens": np.array([[5], [7]], np.int32),
            "positions": np.array([P + 12, P + 12], np.int32)}
    jd, _ = jax.jit(jm.decode)(jp, grown, jax.tree.map(jnp.asarray, step))
    td, _ = tm.decode(tp, tc, {k: _t(v) for k, v in step.items()})
    _close(td, jd, _tol(compute_dtype, jd))
    with pytest.raises(ValueError, match="shorter"):
        tm.prefill(tp, tb, cache_len=12 + 1)  # tokens alone: the patches do not fit


def test_decode_matches_prefill_of_the_longer_prompt():
    """The port against itself, as ``tests/test_models.py`` holds the JAX
    VLM: prefill of the patches and 15 tokens, then one decode step at
    position P + 15, gives the logits of a prefill of 16 tokens."""
    tm = build_model(get_arch(NAME).reduced())
    p = tm.compute_params(tm.init(torch.Generator().manual_seed(3)))
    b = {k: _t(v) for k, v in _batch(T=16, seed=2).items()}
    full, _ = tm.prefill(p, b)
    _, cache = tm.prefill(p, dict(b, tokens=b["tokens"][:, :15]), cache_len=P + 16)
    step, _ = tm.decode(p, cache, {"tokens": b["tokens"][:, 15:],
                                   "positions": torch.tensor([P + 15, P + 15])})
    torch.testing.assert_close(step, full, atol=2e-4, rtol=2e-3)


def test_paged_steps_and_continuous_batching_refuse_a_vlm():
    """As the JAX package's ``_check_paged``: the paged steps take token
    prompts only, and would serve a VLM with no patch embeddings."""
    tm = build_model(get_arch(NAME).reduced())
    with pytest.raises(ValueError, match="paged"):
        build_paged_prefill_step(tm, page_size=8)
    with pytest.raises(ValueError, match="paged"):
        build_paged_decode_step(tm, page_size=8)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(tm, n_pages=8, page_size=8, device="cpu")
    build_paged_prefill_step(build_model(get_arch("smollm-135m").reduced()), page_size=8)


def test_serving_app_refuses_a_model_that_needs_patch_embeddings():
    with pytest.raises(ValueError, match="patch embeddings"):
        LMServeApp(get_arch(NAME).reduced(), device="cpu")


def test_cache_struct_is_meta():
    kv = build_model(get_arch(NAME)).cache_struct(ShapeConfig("s", 1024, 2, "decode"))["k"]
    assert kv.device.type == "meta" and kv.shape == (32, 2, 1024, 8, 128)
