"""The port's RWKV6 family (``repro_torch.models.rwkv6``) against the JAX
package's (CPU), on the same weights (``params_from_jax``) and inputs.

Tolerances: the WKV6 cores at ``tests/test_sequence_cores.py``'s sizes and
its 1e-4; the model in f32 at ``tests/test_models.py``'s atol 2e-4, rtol
2e-3 (logits, loss, states); in bf16 compute 4e-2 of the largest value
compared, as ``tests/test_torch_models.py`` holds the dense family (a bf16
residual stream, 2^-8 relative a rounding, rounded at other places by the
two frameworks). The lockstep serving app (C11) must give the JAX model's
own greedy tokens exactly, in f32.
"""
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.miniapps import LMServeApp as JaxLMServeApp
from repro.models import build_model as jax_build_model
from repro.models.common import group_norm as jax_group_norm
from repro.models.rwkv6 import wkv6_chunked as jax_wkv6_chunked
from repro.models.rwkv6 import wkv6_recurrent as jax_wkv6_recurrent
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.miniapps import LMServeApp
from repro_torch.models import build_model, params_from_jax, tree_to_numpy
from repro_torch.models.common import group_norm
from repro_torch.models.rwkv6 import wkv6_chunked, wkv6_recurrent

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

NAME = "rwkv6-3b"


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


def test_param_specs_match_jax_at_full_width():
    """Every leaf's shape and storage dtype on the abstract full-size model
    (meta tensors), and the parameter count."""
    j = dict(_flat(jax_build_model(jax_get_arch(NAME)).param_struct()))
    t = dict(_flat(build_model(get_arch(NAME)).param_struct()))
    assert sorted(j) == sorted(t)
    for key in j:
        assert tuple(j[key].shape) == tuple(t[key].shape), key
        assert str(j[key].dtype) == str(t[key].dtype).removeprefix("torch."), key
        assert t[key].device.type == "meta"
    assert get_arch(NAME).param_count() == jax_get_arch(NAME).param_count()
    cfg = get_arch(NAME)
    assert (cfg.n_rwkv_heads, cfg.rwkv_head_dim) == (40, 64)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips_every_leaf(param_dtype):
    _, jp, _, tp = _pair(param_dtype=param_dtype)
    j, t = dict(_flat(jax.tree.map(np.asarray, jp))), dict(_flat(tp))
    back = dict(_flat(tree_to_numpy(tp)))
    assert sorted(j) == sorted(t) == sorted(back)
    for key, arr in j.items():
        assert tuple(t[key].shape) == arr.shape, key
        assert str(t[key].dtype).removeprefix("torch.") == str(arr.dtype), key
        assert back[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(back[key].astype(np.float32), arr.astype(np.float32))
    assert t["/layers/wkv_norm_bias"].shape[0] == 2 and not bool(t["/layers/wkv_norm_bias"].any())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_loss_prefill_and_decode_match_jax(compute_dtype):
    """The loss of 64 tokens, the prefill's last-token logits and its
    states (two chunks of 32), and one decode step from those states. The
    decoded WKV state carries f32 precision in both dtypes, as the
    reference keeps it: under 1 % of its elements equal their own bf16
    rounding (a random f32 value does with odds of about 2^-16; a state
    rounded to the compute dtype on the way, which the bf16 tolerance cannot
    see, always does)."""
    jm, jp, tm, tp = _pair(compute_dtype=compute_dtype)
    toks = np.random.default_rng(1).integers(1, 512, (2, 64)).astype(np.int32)
    jl, _ = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks)})
    tl, metrics = tm.loss(tp, {"tokens": _t(toks)})
    assert tl.dtype == torch.float32 and float(metrics["tokens"]) == 2 * 63
    _close(tl, jl, _tol(compute_dtype, jl))
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tlog, tc = tm.prefill(tp, {"tokens": _t(toks)}, cache_len=80)  # nothing grows
    assert tlog.shape == (2, 1, 512) and tlog.dtype == torch.float32
    _close(tlog, jlog, _tol(compute_dtype, jlog))
    assert sorted(tc) == sorted(jc) == ["cm_shift", "tm_shift", "wkv"]
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).removeprefix("torch.") == str(jc[key].dtype), key
        _close(tc[key], jc[key], _tol(compute_dtype, jc[key]))
    tok = np.array([[5], [7]], np.int32)
    batch = {"tokens": tok, "positions": np.array([64, 64], np.int32)}
    jd, jc2 = jax.jit(jm.decode)(jp, jc, jax.tree.map(jnp.asarray, batch))
    td, tc2 = tm.decode(tp, tc, {k: _t(v) for k, v in batch.items()})
    assert tc2 is tc  # the states are written in place
    _close(td, jd, _tol(compute_dtype, jd))
    for key in tc:
        _close(tc[key], jc2[key], _tol(compute_dtype, jc2[key]))
    for state in (tc["wkv"], _t(jc2["wkv"])):
        assert float((state.to(torch.bfloat16).float() == state).float().mean()) < 0.01


def test_decode_matches_prefill_of_the_longer_prompt():
    """The port against itself, as ``tests/test_models.py`` holds the JAX
    model: prefill of 15 tokens then one decode step gives the logits of a
    prefill of 16."""
    tm = build_model(get_arch(NAME).reduced())
    p = tm.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, 512, (2, 16)).astype(np.int32))
    full, _ = tm.prefill(p, {"tokens": toks})
    _, cache = tm.prefill(p, {"tokens": toks[:, :15]})
    step, _ = tm.decode(p, cache, {"tokens": toks[:, 15:], "positions": torch.tensor([15, 15])})
    torch.testing.assert_close(step, full, atol=2e-4, rtol=2e-3)


def _wkv_inputs(T, B=2, H=3, N=16, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, H, T, N)).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-(rng.normal(size=(B, H, T, N)) - 1.0)))).astype(np.float32)
    u = (rng.normal(size=(H, N)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("T,chunk", [(32, 8), (64, 16), (48, 48), (40, 8)])
def test_wkv6_cores_match_jax_and_each_other(T, chunk):
    """``tests/test_sequence_cores.py``'s cases: the port's chunked and
    recurrent cores against the JAX package's, and against each other."""
    args = _wkv_inputs(T, seed=T)
    jo1, js1 = jax_wkv6_recurrent(*map(jnp.asarray, args))
    jo2, js2 = jax_wkv6_chunked(*map(jnp.asarray, args), chunk=chunk)
    to1, ts1 = wkv6_recurrent(*map(_t, args))
    to2, ts2 = wkv6_chunked(*map(_t, args), chunk=chunk)
    for got, want in ((to1, jo1), (ts1, js1), (to2, jo2), (ts2, js2), (to2, to1.numpy()),
                      (ts2, ts1.numpy())):
        _close(got, want, {"atol": 1e-4, "rtol": 0})


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4])
def test_wkv6_state_continuation(n_chunks):
    """T tokens at once == chunk by chunk with the carried state (what
    decode after prefill relies on), against the JAX recurrence."""
    r, k, v, w, u, _ = _wkv_inputs(8 * n_chunks, B=1, H=2, N=8, seed=n_chunks)
    s0 = np.zeros((1, 2, 8, 8), np.float32)
    jo, js = jax_wkv6_recurrent(*map(jnp.asarray, (r, k, v, w, u, s0)))
    S, outs = _t(s0), []
    for c in range(n_chunks):
        sl = slice(c * 8, (c + 1) * 8)
        o, S = wkv6_chunked(_t(r[:, :, sl]), _t(k[:, :, sl]), _t(v[:, :, sl]),
                            _t(w[:, :, sl]), _t(u), S, chunk=8)
        outs.append(o)
    _close(torch.cat(outs, 2), jo, {"atol": 1e-4, "rtol": 0})
    _close(S, js, {"atol": 1e-4, "rtol": 0})


def test_wkv6_chunked_refuses_a_chunk_that_does_not_divide_t():
    """As the reference asserts it: a prefill of 143 tokens does not split
    into chunks of 32 (``chip_smoke.py`` re-scores at 192 instead)."""
    args = _wkv_inputs(40)
    with pytest.raises(ValueError, match="does not divide"):
        wkv6_chunked(*map(_t, args), chunk=16)
    tm = build_model(get_arch(NAME).reduced())
    p = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not divide"):
        tm.prefill(p, {"tokens": torch.zeros((1, 143), dtype=torch.int32)})


def test_group_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 96)).astype(np.float32) * 3 + 1
    scale, bias = rng.normal(size=(96,)).astype(np.float32), rng.normal(size=(96,)).astype(np.float32)
    want = jax_group_norm(jnp.asarray(x), 3, jnp.asarray(scale), jnp.asarray(bias), 64e-5)
    _close(group_norm(_t(x), 3, _t(scale), _t(bias), 64e-5), want, {"atol": 1e-5, "rtol": 0})
    got = group_norm(_t(x).to(torch.bfloat16), 3, _t(scale), _t(bias))
    assert got.dtype == torch.bfloat16


def test_cache_struct_is_meta_and_has_no_sequence_axis():
    tm = build_model(get_arch(NAME))
    c = tm.cache_struct(ShapeConfig("s", 4096, 4, "decode"))
    assert all(t.device.type == "meta" for t in c.values())
    assert c["wkv"].shape == (32, 4, 40, 64, 64) and c["wkv"].dtype == torch.float32
    assert c["tm_shift"].shape == (32, 4, 2560) and c["tm_shift"].dtype == torch.bfloat16


@dataclass
class Msg:
    value: Any
    timestamp: float = 0.0


def test_lockstep_serving_equals_the_jax_models_greedy_loop():
    """C11: the port's ``LMServeApp`` lockstep serves RWKV6 (its prefill's
    ``cache_len`` grows nothing), with the tokens of a greedy loop over the
    JAX model's own prefill and decode. The JAX app pads axis 2 of every
    4-d-or-more cache leaf, the heads of ``wkv``, and fails."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(11)
    msgs = [Msg(rng.integers(1, 512, size=(2, 32)).astype(np.int32)) for _ in range(2)]
    got = LMServeApp(get_arch(NAME).reduced(), prompt_len=32, gen_tokens=5, batch=2,
                     device="cpu").generate_tokens(tp, msgs)
    toks = jnp.asarray(np.concatenate([m.value for m in msgs]))
    logits, cache = jax.jit(jm.prefill)(jp, {"tokens": toks})
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(4):
        batch = {"tokens": tok, "positions": jnp.full((4,), 32 + i, jnp.int32)}
        logits, cache = jax.jit(jm.decode)(jp, cache, batch)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(got, np.asarray(jnp.concatenate(want, axis=1)))
    ref = JaxLMServeApp(jax_get_arch(NAME).reduced(), prompt_len=32, gen_tokens=5, batch=2)
    with pytest.raises(TypeError):
        ref.generate_tokens(jp, msgs)
