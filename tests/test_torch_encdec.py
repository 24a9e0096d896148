"""The port's enc-dec family (``repro_torch.models.encdec``, seamless-m4t's
backbone) against the JAX package's (CPU), on the same weights
(``params_from_jax``) and stub frame embeddings.

Tolerances: the model in f32 at ``tests/test_models.py``'s atol 2e-4, rtol
2e-3 (logits, loss, caches); in bf16 compute 4e-2 of the largest value
compared, as ``tests/test_torch_models.py`` holds the dense family; the
flash plain version, non-causal with Sq != Skv, against the JAX package's
``blockwise_attention`` at ``tests/test_sequence_cores.py``'s 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models.attention import blockwise_attention as jax_blockwise_attention
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.kernels.attention.ref import flash_attention_plain
from repro_torch.miniapps import LMServeApp
from repro_torch.models import attention as attn_lib
from repro_torch.models import build_model, params_from_jax, tree_to_numpy

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

NAME = "seamless-m4t-medium"


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


def _batch(d, B=2, S_enc=8, S=12, seed=1):
    rng = np.random.default_rng(seed)
    return {"frame_embeds": rng.normal(size=(B, S_enc, d)).astype(np.float32),
            "tokens": rng.integers(1, 512, (B, S)).astype(np.int32)}


def test_param_specs_match_jax_at_full_width():
    """Every leaf's shape and storage dtype on the abstract full-size model
    (meta tensors), the parameter count (its 256 206-id vocabulary padded to
    256 256 twice)."""
    j = dict(_flat(jax_build_model(jax_get_arch(NAME)).param_struct()))
    t = dict(_flat(build_model(get_arch(NAME)).param_struct()))
    assert sorted(j) == sorted(t)
    for key in j:
        assert tuple(j[key].shape) == tuple(t[key].shape), key
        assert str(j[key].dtype) == str(t[key].dtype).removeprefix("torch."), key
        assert t[key].device.type == "meta"
    assert get_arch(NAME).param_count() == jax_get_arch(NAME).param_count()
    assert t["/embed"].shape == (256_256, 1024) and t["/encoder/wqkv"].shape[0] == 12


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips_every_leaf(param_dtype):
    """The ``encoder``/``decoder`` split crosses as it is, and back."""
    _, jp, _, tp = _pair(param_dtype=param_dtype)
    j, t = dict(_flat(jax.tree.map(np.asarray, jp))), dict(_flat(tp))
    back = dict(_flat(tree_to_numpy(tp)))
    assert sorted(j) == sorted(t) == sorted(back)
    assert {"encoder", "decoder", "frame_proj"} <= set(tp)
    for key, arr in j.items():
        assert tuple(t[key].shape) == arr.shape, key
        assert str(t[key].dtype).removeprefix("torch.") == str(arr.dtype), key
        assert back[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(back[key].astype(np.float32), arr.astype(np.float32))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_loss_prefill_and_decode_match_jax(compute_dtype):
    """The loss, the prefill's logits and cache (self-attention K/V grown
    to ``cache_len``, the cross-attention memory not), and one decode step
    on it."""
    jm, jp, tm, tp = _pair(compute_dtype=compute_dtype)
    batch = _batch(128)
    jl, _ = jax.jit(jm.loss)(jp, jax.tree.map(jnp.asarray, batch))
    tl, metrics = tm.loss(tp, {k: _t(v) for k, v in batch.items()})
    assert float(metrics["tokens"]) == 2 * 11
    _close(tl, jl, _tol(compute_dtype, jl))
    jlog, jc = jax.jit(jm.prefill)(jp, jax.tree.map(jnp.asarray, batch))
    tlog, tc = tm.prefill(tp, {k: _t(v) for k, v in batch.items()}, cache_len=13)
    assert tlog.shape == (2, 1, 512) and tlog.dtype == torch.float32
    _close(tlog, jlog, _tol(compute_dtype, jlog))
    assert tc["k"].shape == (2, 2, 13, 2, 32) and not bool(tc["k"][:, :, 12:].any())
    assert tc["k_mem"].shape == jc["k_mem"].shape == (2, 2, 8, 2, 32)
    _close(tc["v"][:, :, :12], jc["v"], _tol(compute_dtype, jc["v"]))
    for key in ("k_mem", "v_mem"):
        _close(tc[key], jc[key], _tol(compute_dtype, jc[key]))
    grown = dict(jc, **{k: jnp.pad(jc[k], [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
                        for k in ("k", "v")})
    step = {"tokens": np.array([[5], [7]], np.int32), "positions": np.array([12, 12], np.int32)}
    jd, _ = jax.jit(jm.decode)(jp, grown, jax.tree.map(jnp.asarray, step))
    td, tc2 = tm.decode(tp, tc, {k: _t(v) for k, v in step.items()})
    assert tc2 is tc and bool(tc["k"][:, :, 12].any())  # written in place
    _close(td, jd, _tol(compute_dtype, jd))


def test_decode_matches_prefill_of_the_longer_prompt():
    """The port against itself, as ``tests/test_models.py`` holds the JAX
    model: prefill of 11 tokens then one decode step gives the logits of a
    prefill of 12, over the same frames."""
    tm = build_model(get_arch(NAME).reduced())
    p = tm.init(torch.Generator().manual_seed(3))
    b = {k: _t(v) for k, v in _batch(128, seed=2).items()}
    full, _ = tm.prefill(p, b)
    _, cache = tm.prefill(p, dict(b, tokens=b["tokens"][:, :11]), cache_len=12)
    step, _ = tm.decode(p, cache, {"tokens": b["tokens"][:, 11:],
                                   "positions": torch.tensor([11, 11])})
    torch.testing.assert_close(step, full, atol=2e-4, rtol=2e-3)


def test_cross_attention_follows_the_reference_dispatch(monkeypatch):
    """Prefill: the encoder's self-attention and the cross-attention go
    through the flash wrapper non-causal (the cross-attention with Sq !=
    Skv), the decoder's self-attention causal; the one-token decode's
    cross-attention through the plain ``naive_attention``."""
    calls = []
    flash, naive = attn_lib.blockwise_attention, attn_lib.naive_attention

    def flash_seen(q, k, v, *, causal=True):
        calls.append(("flash", q.shape[1], k.shape[1], causal))
        return flash(q, k, v, causal=causal)

    def naive_seen(q, k, v, *, causal=True):
        calls.append(("naive", q.shape[1], k.shape[1], causal))
        return naive(q, k, v, causal=causal)

    monkeypatch.setattr(attn_lib, "blockwise_attention", flash_seen)
    monkeypatch.setattr(attn_lib, "naive_attention", naive_seen)
    tm = build_model(get_arch(NAME).reduced())
    p = tm.init(torch.Generator().manual_seed(0))
    b = {k: _t(v) for k, v in _batch(128).items()}
    _, cache = tm.prefill(p, b, cache_len=13)
    assert sorted(set(calls)) == [("flash", 8, 8, False), ("flash", 12, 8, False),
                                  ("flash", 12, 12, True)]
    assert len(calls) == 2 + 2 * 2  # 2 encoder layers; 2 decoder layers, self and cross
    calls.clear()
    tm.decode(p, cache, {"tokens": torch.tensor([[1], [2]]), "positions": torch.tensor([12, 12])})
    assert calls == [("naive", 1, 8, False)] * 2


@pytest.mark.parametrize("Sq,Skv,H,KV,block", [(12, 20, 4, 4, 8), (16, 48, 4, 2, 16),
                                               (20, 8, 6, 3, 4), (33, 64, 2, 1, 16)])
def test_flash_plain_non_causal_cross_lengths_matches_jax(Sq, Skv, H, KV, block):
    """The flash wrapper's plain version, non-causal with Sq != Skv (G = 1
    and G > 1, blocks that do and do not divide the lengths on the port's
    side), against the JAX package's ``blockwise_attention`` (whose blocks
    must divide them)."""
    rng = np.random.default_rng(Sq + Skv)
    q = rng.normal(size=(2, Sq, H, 16)).astype(np.float32)
    k = rng.normal(size=(2, Skv, KV, 16)).astype(np.float32)
    v = rng.normal(size=(2, Skv, KV, 16)).astype(np.float32)
    want = jax_blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                   block_q=Sq, block_kv=Skv)
    for bq, bkv in ((block, block), (512, 1024)):
        got = flash_attention_plain(_t(q), _t(k), _t(v), causal=False, block_q=bq, block_kv=bkv)
        _close(got, want, {"atol": 2e-5, "rtol": 0})
    _close(attn_lib.blockwise_attention(_t(q), _t(k), _t(v), causal=False), want,
           {"atol": 2e-5, "rtol": 0})


def test_remat_checkpoints_only_where_a_gradient_is_taken(monkeypatch):
    """Under ``remat="full"`` the encoder's layers (remat under any policy,
    as the reference's) go through ``torch.utils.checkpoint`` in the loss
    of weights that take gradients, never in serving: a prefill and decode
    with no gradient run the layers as they are, and give the logits of
    ``remat="none"``."""
    from repro_torch.models import transformer

    seen = []

    def checkpoint_seen(fn, *args, **kwargs):
        seen.append(fn)
        return fn(*args)

    monkeypatch.setattr(transformer, "checkpoint", checkpoint_seen)
    tm = build_model(get_arch(NAME).reduced(remat="full"))
    p = tm.init(torch.Generator().manual_seed(0))
    b = {k: _t(v) for k, v in _batch(128).items()}
    logits, cache = tm.prefill(p, b, cache_len=13)
    tm.decode(p, cache, {"tokens": torch.tensor([[1], [2]]), "positions": torch.tensor([12, 12])})
    assert seen == []
    plain, _ = build_model(get_arch(NAME).reduced()).prefill(p, b)
    torch.testing.assert_close(logits, plain, atol=0, rtol=0)
    for leaf in jax.tree.leaves(p):
        leaf.requires_grad_(True)
    tm.loss(p, b)[0].backward()
    assert len(seen) == 2 + 2  # 2 encoder layers, 2 decoder layers


def test_cache_struct_is_meta():
    c = build_model(get_arch(NAME)).cache_struct(ShapeConfig("s", 512, 4, "decode"))
    assert sorted(c) == ["k", "k_mem", "v", "v_mem"]
    assert c["k"].device.type == "meta" and c["k"].shape == (12, 4, 256, 16, 64)


def test_serving_app_refuses_a_model_that_needs_frame_embeddings():
    """A token stream carries no frame embeddings: the app refuses an
    enc-dec model up front (the JAX app fails at its first prefill)."""
    with pytest.raises(ValueError, match="frame embeddings"):
        LMServeApp(get_arch(NAME).reduced(), device="cpu")
