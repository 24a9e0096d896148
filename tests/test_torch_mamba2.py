"""The port's Mamba2 block and Zamba2 hybrid (``repro_torch.models.mamba2``,
``repro_torch.models.zamba``) against the JAX package's (CPU), on the same
weights (``params_from_jax``) and inputs.

Tolerances: the SSD cores and the causal conv at
``tests/test_sequence_cores.py``'s sizes and its 1e-4 (1e-5 / 1e-6 for the
conv); the model in f32 at ``tests/test_models.py``'s atol 2e-4, rtol 2e-3
(logits, loss, K/V and states); in bf16 compute 4e-2 of the largest value
compared, as ``tests/test_torch_models.py`` holds the dense family. The
lockstep serving app (C11) must give the JAX model's own greedy tokens
exactly, in f32.
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
from repro.models.mamba2 import conv1d_causal as jax_conv1d_causal
from repro.models.mamba2 import mamba_apply as jax_mamba_apply
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro.models.mamba2 import ssd_recurrent as jax_ssd_recurrent
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.miniapps import LMServeApp
from repro_torch.models import build_model, params_from_jax, tree_to_numpy
from repro_torch.models.mamba2 import conv1d_causal, mamba_apply, ssd_chunked, ssd_recurrent

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

NAME = "zamba2-1.2b"
F32 = {"atol": 2e-4, "rtol": 2e-3}


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
        return F32
    return {"atol": 4e-2 * max(float(np.abs(np.asarray(r, np.float32)).max()) for r in refs),
            "rtol": 0}


def test_param_specs_match_jax_at_full_width():
    """Every leaf's shape and storage dtype on the abstract full-size model
    (meta tensors), the parameter count, and the 7 shared sites of 38
    layers."""
    jm, tm = jax_build_model(jax_get_arch(NAME)), build_model(get_arch(NAME))
    j, t = dict(_flat(jm.param_struct())), dict(_flat(tm.param_struct()))
    assert sorted(j) == sorted(t)
    for key in j:
        assert tuple(j[key].shape) == tuple(t[key].shape), key
        assert str(j[key].dtype) == str(t[key].dtype).removeprefix("torch."), key
        assert t[key].device.type == "meta"
    assert get_arch(NAME).param_count() == jax_get_arch(NAME).param_count()
    assert tm.n_sites == jm.n_sites == 7 and tm._groups() == jm._groups()
    assert t["/shared/wqkv"].shape == (2 * 2048, 3 * 32 * 64)  # concat(x, x0) in
    cfg = get_arch(NAME)
    assert (cfg.d_inner, cfg.n_ssm_heads) == (4096, 64)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips_every_leaf(param_dtype):
    """The ``shared``/``mamba`` split crosses as it is, and back."""
    _, jp, _, tp = _pair(param_dtype=param_dtype)
    j, t = dict(_flat(jax.tree.map(np.asarray, jp))), dict(_flat(tp))
    back = dict(_flat(tree_to_numpy(tp)))
    assert sorted(j) == sorted(t) == sorted(back)
    assert sorted(tp) == ["embed", "final_norm", "lm_head", "mamba", "shared"]
    for key, arr in j.items():
        assert tuple(t[key].shape) == arr.shape, key
        assert str(t[key].dtype).removeprefix("torch.") == str(arr.dtype), key
        assert back[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(back[key].astype(np.float32), arr.astype(np.float32))
    assert not bool(t["/mamba/conv_b"].any())  # the "zeros" init


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_loss_prefill_and_decode_match_jax(compute_dtype):
    """The loss of 64 tokens, the prefill's logits and cache (the sites'
    K/V grown to ``cache_len``, the Mamba2 states as they are), and one
    decode step on it. The decoded SSD state carries f32 precision in both
    dtypes, as the reference keeps it: under 1 % of its elements equal
    their own bf16 rounding (a random f32 value does with odds of about
    2^-16; a state rounded to the compute dtype on the way, which the bf16
    tolerance cannot see, always does)."""
    jm, jp, tm, tp = _pair(compute_dtype=compute_dtype)
    toks = np.random.default_rng(1).integers(1, 512, (2, 64)).astype(np.int32)
    jl, _ = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.loss(tp, {"tokens": _t(toks)})
    _close(tl, jl, _tol(compute_dtype, jl))
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tlog, tc = tm.prefill(tp, {"tokens": _t(toks)}, cache_len=65)
    assert tlog.shape == (2, 1, 512) and tlog.dtype == torch.float32
    _close(tlog, jlog, _tol(compute_dtype, jlog))
    sites = tm.n_sites
    assert tc["k"].shape == (sites, 2, 65, 2, 32) and not bool(tc["k"][:, :, 64:].any())
    _close(tc["v"][:, :, :64], jc["v"], _tol(compute_dtype, jc["v"]))
    for key in ("conv", "ssd"):  # the states do not grow
        assert tuple(tc["mamba"][key].shape) == jc["mamba"][key].shape, key
        assert str(tc["mamba"][key].dtype).removeprefix("torch.") == str(jc["mamba"][key].dtype)
        _close(tc["mamba"][key], jc["mamba"][key], _tol(compute_dtype, jc["mamba"][key]))
    grown = dict(jc, **{k: jnp.pad(jc[k], [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
                        for k in ("k", "v")})
    batch = {"tokens": np.array([[5], [7]], np.int32), "positions": np.array([64, 64], np.int32)}
    jd, jc2 = jax.jit(jm.decode)(jp, grown, jax.tree.map(jnp.asarray, batch))
    td, tc2 = tm.decode(tp, tc, {k: _t(v) for k, v in batch.items()})
    assert tc2 is tc and bool(tc["k"][:, :, 64].any())  # written in place
    _close(td, jd, _tol(compute_dtype, jd))
    for key in ("conv", "ssd"):
        _close(tc["mamba"][key], jc2["mamba"][key], _tol(compute_dtype, jc2["mamba"][key]))
    for state in (tc["mamba"]["ssd"], _t(jc2["mamba"]["ssd"])):
        assert float((state.to(torch.bfloat16).float() == state).float().mean()) < 0.01


def test_decode_matches_prefill_of_the_longer_prompt():
    """The port against itself, as ``tests/test_models.py`` holds the JAX
    model: prefill of 15 tokens then one decode step gives the logits of a
    prefill of 16."""
    tm = build_model(get_arch(NAME).reduced())
    p = tm.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, 512, (2, 16)).astype(np.int32))
    full, _ = tm.prefill(p, {"tokens": toks})
    _, cache = tm.prefill(p, {"tokens": toks[:, :15]}, cache_len=16)
    step, _ = tm.decode(p, cache, {"tokens": toks[:, 15:], "positions": torch.tensor([15, 15])})
    torch.testing.assert_close(step, full, atol=2e-4, rtol=2e-3)


def _ssd_inputs(T, Bt=2, H=3, P=8, N=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bt, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bt, T, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,)) * 0.5).astype(np.float32)
    B = rng.normal(size=(Bt, T, 1, N)).astype(np.float32)
    C = rng.normal(size=(Bt, T, 1, N)).astype(np.float32)
    D = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(Bt, H, P, N)) * 0.1).astype(np.float32)
    return x, dt, A, B, C, D, s0


@pytest.mark.parametrize("T,chunk", [(32, 8), (64, 64), (48, 16)])
def test_ssd_cores_match_jax_and_each_other(T, chunk):
    """``tests/test_sequence_cores.py``'s cases (here from a carried-in
    state): the port's chunked and recurrent SSD against the JAX package's,
    and against each other."""
    args = _ssd_inputs(T, seed=T)
    jy1, js1 = jax_ssd_recurrent(*map(jnp.asarray, args))
    jy2, js2 = jax_ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty1, ts1 = ssd_recurrent(*map(_t, args))
    ty2, ts2 = ssd_chunked(*map(_t, args), chunk=chunk)
    for got, want in ((ty1, jy1), (ts1, js1), (ty2, jy2), (ts2, js2), (ty2, ty1.numpy()),
                      (ts2, ts1.numpy())):
        _close(got, want, {"atol": 1e-4, "rtol": 0})


def test_ssd_chunked_refuses_a_chunk_that_does_not_divide_t():
    args = _ssd_inputs(40)
    with pytest.raises(ValueError, match="does not divide"):
        ssd_chunked(*map(_t, args), chunk=16)


@pytest.mark.parametrize("split", [1, 8, 15])
def test_conv1d_causal_state_continuation_matches_jax(split):
    """The whole sequence at once, and in two parts with the carried state,
    against the JAX package's conv."""
    rng = np.random.default_rng(split)
    x = rng.normal(size=(2, 16, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    jfull, jstate = jax_conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), None)
    full, state = conv1d_causal(_t(x), _t(w), _t(b), None)
    _close(full, jfull, {"atol": 1e-5, "rtol": 0})
    _close(state, jstate, {"atol": 1e-6, "rtol": 0})
    a, st = conv1d_causal(_t(x[:, :split]), _t(w), _t(b), None)
    rest, st2 = conv1d_causal(_t(x[:, split:]), _t(w), _t(b), st)
    _close(torch.cat([a, rest], 1), jfull, {"atol": 1e-5, "rtol": 0})
    _close(st2, jstate, {"atol": 1e-6, "rtol": 0})


@pytest.mark.parametrize("chunked", [True, False])
def test_mamba_block_matches_jax(chunked):
    """One Mamba2 block, from zeros (the prefill's chunked core) and from
    the carried states (the decode's recurrent core)."""
    jm, jp, _, tp = _pair()
    cfg, tcfg = jax_get_arch(NAME).reduced(), get_arch(NAME).reduced()
    jl = jax.tree.map(lambda a: a[0], jp["mamba"])
    tl = {k: v[0] for k, v in tp["mamba"].items()}
    x = np.random.default_rng(5).normal(size=(2, 32 if chunked else 1, 128)).astype(np.float32)
    state = None
    if not chunked:
        rng = np.random.default_rng(6)
        state = {"conv": rng.normal(size=(2, 3, tcfg.d_inner + 32)).astype(np.float32),
                 "ssd": rng.normal(size=(2, tcfg.n_ssm_heads, 32, 16)).astype(np.float32)}
    jout, jst = jax_mamba_apply(cfg, jl, jnp.asarray(x),
                                None if state is None else jax.tree.map(jnp.asarray, state),
                                compute_dtype=jnp.float32, chunked=chunked)
    tout, tst = mamba_apply(tcfg, tl, _t(x), None if state is None else
                            {k: _t(v) for k, v in state.items()}, compute_dtype=torch.float32,
                            chunked=chunked)
    _close(tout, jout, F32)
    for key in ("conv", "ssd"):
        _close(tst[key], jst[key], F32)


def test_cache_struct_is_meta():
    tm = build_model(get_arch(NAME))
    c = tm.cache_struct(ShapeConfig("s", 256, 4, "decode"))
    assert c["k"].device.type == "meta" and c["k"].shape == (7, 4, 256, 32, 64)
    assert c["mamba"]["ssd"].shape == (38, 4, 64, 64, 64)
    assert c["mamba"]["conv"].shape == (38, 4, 3, 4096 + 2 * 64)
    assert c["mamba"]["ssd"].dtype == torch.float32


@dataclass
class Msg:
    value: Any
    timestamp: float = 0.0


def test_lockstep_serving_equals_the_jax_models_greedy_loop():
    """C11: the port's ``LMServeApp`` lockstep serves Zamba2 (its prefill's
    ``cache_len`` grows only the sites' K/V), with the tokens of a greedy
    loop over the JAX model's own prefill and decode, only ``k``/``v``
    grown as ``tests/test_models.py`` grows them. The JAX app pads axis 2
    of every 4-d-or-more cache leaf (the SSD state's heads, the conv
    window) and fails."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(11)
    msgs = [Msg(rng.integers(1, 512, size=(2, 32)).astype(np.int32)) for _ in range(2)]
    got = LMServeApp(get_arch(NAME).reduced(), prompt_len=32, gen_tokens=5, batch=2,
                     device="cpu").generate_tokens(tp, msgs)
    toks = jnp.asarray(np.concatenate([m.value for m in msgs]))
    logits, cache = jax.jit(jm.prefill)(jp, {"tokens": toks})
    cache = dict(cache, **{k: jnp.pad(cache[k], [(0, 0), (0, 0), (0, 5), (0, 0), (0, 0)])
                           for k in ("k", "v")})
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
