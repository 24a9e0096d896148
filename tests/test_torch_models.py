"""The port's dense LM (``repro_torch.models``) against the JAX package's
(CPU), on the same weights: the JAX ``model.init`` pytree goes across with
``params_from_jax``.

Tolerances: 2e-5 on logits and caches for f32 compute (the same f32
arithmetic with sums in another order); for bf16 compute 4e-2 of the
largest value compared (logits or cache entries) — the
residual stream is bf16 (2^-8 relative per rounding) and the two
frameworks round intermediate products at different places over two layers,
which moves them by a few bf16 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as jax_archs_dict
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models.common import apply_rope as jax_apply_rope
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch.configs import ARCHS, ShapeConfig, get_arch
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.common import apply_rope, first_argmax, rms_norm, tree_leaves

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

DENSE = ["smollm-135m", "stablelm-1.6b", "starcoder2-3b", "qwen3-14b"]
MOE = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]  # their parity: test_torch_moe.py


def _pair(name, **overrides):
    jm = jax_build_model(jax_get_arch(name).reduced(**overrides))
    tm = build_model(get_arch(name).reduced(**overrides))
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", DENSE + MOE)
def test_param_specs_match_jax_at_full_width(name):
    """Every leaf's shape and storage dtype, on the abstract full-size
    model, and the parameter count."""
    jm, tm = jax_build_model(jax_get_arch(name)), build_model(get_arch(name))
    j = dict(_flat(jm.param_struct()))
    t = dict(_flat(tm.param_struct()))
    assert sorted(j) == sorted(t)
    for key in j:
        assert tuple(j[key].shape) == tuple(t[key].shape), key
        assert str(j[key].dtype) == str(t[key].dtype).removeprefix("torch."), key
        assert t[key].device.type == "meta"
    assert get_arch(name).param_count() == jax_get_arch(name).param_count()


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips_every_leaf(param_dtype):
    jm, jp, tm, tp = _pair("qwen3-14b", param_dtype=param_dtype)
    j, t = dict(_flat(jax.tree.map(np.asarray, jp))), dict(_flat(tp))
    assert sorted(j) == sorted(t)
    for key, arr in j.items():
        assert tuple(t[key].shape) == arr.shape, key
        assert str(t[key].dtype).removeprefix("torch.") == str(arr.dtype), key
        np.testing.assert_array_equal(t[key].to(torch.float32).numpy(), arr.astype(np.float32))
    assert t["/layers/wqkv"].shape[0] == 2  # the stacked layer axis is kept
    with pytest.raises(TypeError):
        params_from_jax({"layers": [np.zeros(3)]}, "cpu")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_logits_match_jax(name, compute_dtype):
    """Prefill of a 12-token prompt (logits at the last token and at
    ``last_pos``), its cache, and one decode step on the grown cache."""
    jm, jp, tm, tp = _pair(name, compute_dtype=compute_dtype)
    tp = tm.compute_params(tp)
    toks = np.random.default_rng(1).integers(1, 512, (2, 12)).astype(np.int32)
    last = np.array([11, 6], np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=13)
    jl_last, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks), "last_pos": jnp.asarray(last)})
    tl_last, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "last_pos": torch.from_numpy(last)})
    scale = float(np.abs(np.asarray(jl)).max())
    tol = 2e-5 if compute_dtype == "float32" else 4e-2 * scale
    assert tl.shape == (2, 1, 512) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    np.testing.assert_allclose(tl_last.numpy(), np.asarray(jl_last), atol=tol)
    assert tc["k"].dtype == tm.compute_dtype and tc["k"].shape == (2, 2, 13, 2, 32)
    jv = np.asarray(jc["v"], np.float32)
    tol_v = 2e-5 if compute_dtype == "float32" else 4e-2 * float(np.abs(jv).max())
    np.testing.assert_allclose(tc["v"][:, :, :12].to(torch.float32).numpy(), jv, atol=tol_v)
    assert not bool(tc["k"][:, :, 12:].any())  # zeros past the prompt

    jc = jax.tree.map(lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]), jc)
    tok, pos = np.array([[5], [7]], np.int32), np.array([12, 12], np.int32)
    jd, _ = jax.jit(jm.decode)(jp, jc, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)})
    td, tc2 = tm.decode(tp, tc, {"tokens": torch.from_numpy(tok), "positions": torch.from_numpy(pos)})
    assert tc2 is tc and bool(tc["k"][:, :, 12].any())  # written in place
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=tol)


def test_decode_matches_prefill_of_the_longer_prompt():
    """The port against itself, as tests/test_models.py holds the JAX
    model: prefill of S tokens then one decode step gives the logits of a
    prefill of S + 1 tokens."""
    tm = build_model(get_arch("smollm-135m").reduced())
    p = tm.compute_params(tm.init(torch.Generator().manual_seed(3)))
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, 512, (2, 9)).astype(np.int32))
    full, _ = tm.prefill(p, {"tokens": toks})
    _, cache = tm.prefill(p, {"tokens": toks[:, :8]}, cache_len=9)
    step, _ = tm.decode(p, cache, {"tokens": toks[:, 8:], "positions": torch.tensor([8, 8])})
    torch.testing.assert_close(step, full, atol=2e-5, rtol=0)


def test_compute_params_casts_only_the_matmul_weights():
    tm = build_model(get_arch("qwen3-14b").reduced(compute_dtype="bfloat16"))
    p = tm.init(torch.Generator().manual_seed(0))
    c = tm.compute_params(p)
    for key, t in c["layers"].items():
        want = torch.bfloat16 if key in tm.MATMUL_WEIGHTS else torch.float32
        assert t.dtype == want, key
    assert c["embed"] is p["embed"] and c["final_norm"] is p["final_norm"]
    assert all(t.dtype == torch.float32 for t in tree_leaves(p))  # storage untouched


def test_init_draws_from_the_generator_with_the_spec_scales():
    tm = build_model(get_arch("smollm-135m").reduced())
    a = tm.init(torch.Generator().manual_seed(5))
    b = tm.init(torch.Generator().manual_seed(5))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert bool((a["final_norm"] == 1).all()) and bool((a["layers"]["attn_norm"] == 1).all())
    assert abs(float(a["embed"].std()) - 0.02) < 0.002
    assert abs(float(a["layers"]["w_up"].std()) - 128 ** -0.5) < 0.01  # 1/sqrt(fan_in)


def test_norm_rope_and_argmax_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
                               np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(scale))),
                               atol=1e-6)
    pos = np.array([[0, 1, 2, 700, 4]] * 2, np.int32)
    for pct in (1.0, 0.25):
        got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0, pct).numpy()
        want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, pct))
        np.testing.assert_allclose(got, want, atol=2e-5)
    ties = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert first_argmax(ties).tolist() == [1, 0]
    assert first_argmax(ties.T, dim=0).tolist() == [1, 0]


FAMILY_CLASS = {"dense": "DecoderLM", "moe": "DecoderLM", "vlm": "DecoderLM",
                "encdec": "EncDecLM", "ssm": "Rwkv6LM", "hybrid": "ZambaLM"}


def test_registry_knows_every_jax_arch():
    assert sorted(ARCHS) == sorted(jax_archs_dict) and len(ARCHS) == 10
    import dataclasses

    for name, cfg in ARCHS.items():
        ref = jax_archs_dict[name]
        for f in dataclasses.fields(cfg):  # every field the port has, as the JAX config says
            assert getattr(cfg, f.name) == getattr(ref, f.name), (name, f.name)
        small, ref_small = cfg.reduced(), ref.reduced()
        for f in dataclasses.fields(small):  # and their reduced() forms
            assert getattr(small, f.name) == getattr(ref_small, f.name), (name, f.name)
        assert (cfg.d_inner, cfg.n_ssm_heads, cfg.n_rwkv_heads) == (
            ref.d_inner, ref.n_ssm_heads, ref.n_rwkv_heads)


@pytest.mark.parametrize("name", sorted(jax_archs_dict))
def test_build_model_is_dense_only_and_cache_struct_is_meta(name):
    """Every one of the JAX package's ten archs is known and builds (since
    the families of ROADMAP A8 were ported, no family raises): the model
    class is its family's, the MoE and VLM branches of ``DecoderLM`` are
    set as the config says, and the decode cache of a dry-run shape is
    ``meta`` tensors, self-attention K/V (where the family has them) of
    (layers or sites, B, S, KV, hd) in bf16."""
    cfg = get_arch(name)
    model = build_model(cfg)
    assert type(model).__name__ == FAMILY_CLASS[cfg.family]
    if cfg.family in ("dense", "moe", "vlm"):
        assert model.is_moe == (cfg.family == "moe") and model.is_vlm == (cfg.family == "vlm")
        assert ("router" in model.param_specs()["layers"]) == model.is_moe
    cache = model.cache_struct(ShapeConfig("s", 256, 4, "decode"))
    leaves = tree_leaves(cache)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    if "k" in cache:
        kv = cache["k"]
        assert kv.dtype == torch.bfloat16 and kv.shape[1] == 4 and kv.shape[-2:] == (
            cfg.n_kv_heads, cfg.resolved_head_dim)
    if name == "smollm-135m":
        assert cache["k"].shape == (30, 4, 256, 3, 64)
    with pytest.raises(ValueError):
        build_model(cfg.replace(family="unknown"))
    with pytest.raises(KeyError):
        get_arch(name + "-unknown")
