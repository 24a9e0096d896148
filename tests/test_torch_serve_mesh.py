"""The port's mesh serving steps (``runtime/steps.py`` ``build_prefill_step``
and ``build_decode_step`` on a mesh) on a 2 x 2 ("data", "model") mesh of
gloo ranks on the CPU, against the JAX package's one-device ``prefill`` and
``decode`` on the same weights (``params_from_jax``):

* the reduced smollm, rwkv6 and zamba2 in f32: a prefill of 4 prompts of 28
  tokens into a cache of 64 positions (rows over "data", the prompt's
  sequence and the K/V cache's over "model": the cache tiles are positions
  0-31 and 32-63, so the prompt's sequence shards and the cache's tiles
  differ), then 8 decode steps at positions 28-35: for the first 4 the
  second "model" rank's cache tile holds no valid entry (the empty shard
  is on the path), from position 32 on that rank writes the new entry and
  both tiles' partials merge; every call's logits of each rank's rows
  within the tolerances of ``tests/test_torch_models.py`` (2e-5 for the
  dense model) and of ``tests/test_torch_rwkv6.py`` /
  ``test_torch_mamba2.py`` (atol 2e-4, rtol 2e-3), and each rank's K/V
  cache tile, after the prefill and after the last decode step, against
  the JAX cache's segment;
* the sharded decode attention's merge at a shard start one off fails
  where the right start holds (against the one-device plain decode over
  the gathered cache, whose both tiles hold valid entries);
* the reduced MoE, VLM and enc-dec families through the same calls, beside
  their patch or frame embeddings, against the JAX package's logits.

One rank group runs every case once (a module-scoped fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_cases as cases
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.launch.mesh import spawn_ranks

NAMES = ("smollm-135m", "rwkv6-3b", "zamba2-1.2b")
B, T, CACHE, STEPS = 4, 28, 64, 8
TOL = {"smollm-135m": {"atol": 2e-5, "rtol": 0},
       "rwkv6-3b": {"atol": 2e-4, "rtol": 2e-3}, "zamba2-1.2b": {"atol": 2e-4, "rtol": 2e-3}}


def _jax(name):
    m = jax_build_model(jax_get_arch(name).reduced())
    p = m.init(jax.random.key(0))
    if "moe" in name:  # as tests/test_torch_moe.py: no top-k set hangs on rounding
        p["layers"]["router"] = p["layers"]["router"] * 100.0
    return m, p


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_mesh")
    rng = np.random.default_rng(5)
    inp = {"tokens": rng.integers(1, 512, (B, T)).astype(np.int32),
           "steps": rng.integers(1, 512, (STEPS, B, 1)).astype(np.int32),
           "cache_len": CACHE,
           "params": {n: jax.tree.map(np.asarray, _jax(n)[1]) for n in NAMES}}
    extra = {"phi3.5-moe-42b-a6.6b": {},
             "llava-next-mistral-7b": {"patch_embeds": rng.standard_normal(
                 (B, 16, 128)).astype(np.float32)},
             "seamless-m4t-medium": {"frame_embeds": rng.standard_normal(
                 (B, 20, 128)).astype(np.float32)}}
    inp["families"] = {n: {"params": jax.tree.map(np.asarray, _jax(n)[1]), "extra": e}
                       for n, e in extra.items()}
    res = spawn_ranks(cases.serve_mesh_cases, 4, init_method=f"file://{d}/store",
                      args=(inp,), timeout=120)
    return inp, res


def _jax_run(name, inp, extra=None):
    """The JAX package's one-device prefill and decode steps (beside
    ``extra`` inputs: patch or frame embeddings): every call's logits, the
    prefill's cache (the K/V grown to CACHE by zeros) and the cache after
    the last decode step."""
    m, p = _jax(name)
    extra = extra or {}
    logits, cache = jax.jit(m.prefill)(p, {"tokens": jnp.asarray(inp["tokens"]),
                                           **{k: jnp.asarray(v) for k, v in extra.items()}})
    S = T + (extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0)
    out = [np.asarray(logits)]
    pad = [(0, 0), (0, 0), (0, CACHE - S), (0, 0), (0, 0)]
    grown = dict(cache, **{k: jnp.pad(cache[k], pad) for k in ("k", "v") if k in cache})
    prefill_cache = jax.tree.map(np.asarray, grown)
    dec = jax.jit(m.decode)
    for i, tok in enumerate(inp["steps"]):
        batch = {"tokens": jnp.asarray(tok), "positions": jnp.full((B,), S + i, jnp.int32)}
        logits, grown = dec(p, grown, batch)
        out.append(np.asarray(logits))
    return out, prefill_cache, jax.tree.map(np.asarray, grown)


def _rows(rank: int) -> slice:
    d = rank // 2  # rank 2 d + m: rows block d ("data")
    return slice(d * B // 2, (d + 1) * B // 2)


@pytest.mark.parametrize("name", NAMES + ("smollm-135m/zero",))
def test_mesh_prefill_and_decode_match_jax(served, name):
    """("/zero": the weights kept as the ranks' ZeRO tiles and gathered a
    layer at a time where the layer runs, instead of whole once.)"""
    inp, res = served
    arch = name.split("/")[0]
    want, _, _ = _jax_run(arch, inp)
    for rank, r in enumerate(res):
        got = r[name]["logits"]
        assert len(got) == STEPS + 1
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w[_rows(rank)], **TOL[arch],
                                       err_msg=f"{name} rank {rank} call {step}")


def _segment(rank: int) -> slice:
    m = rank % 2  # the rank's "model" tile of the cache
    return slice(m * CACHE // 2, (m + 1) * CACHE // 2)


@pytest.mark.parametrize("name", ["smollm-135m", "zamba2-1.2b"])
def test_mesh_prefill_cache_tiles_are_the_jax_cache_segments(served, name):
    """Each rank holds its rows and its "model" segment of the K/V cache
    (32 positions: the second segment is zeros, past the prompt); the
    recurrent states (Zamba2's Mamba2 layers) are its rows', whole."""
    inp, res = served
    _, cache, _ = _jax_run(name, inp)
    for rank, r in enumerate(res):
        for k in ("k", "v"):
            np.testing.assert_allclose(r[name]["cache"][k],
                                       cache[k][:, _rows(rank), _segment(rank)], **TOL[name])
        if name == "zamba2-1.2b":
            for k in ("conv", "ssd"):
                np.testing.assert_allclose(r[name]["cache"][f"mamba/{k}"],
                                           cache["mamba"][k][:, _rows(rank)], **TOL[name])
    assert not res[1][name]["cache"]["k"].any()  # no prompt entry in the second segment


@pytest.mark.parametrize("name", ["smollm-135m", "zamba2-1.2b"])
def test_mesh_decode_writes_each_entry_into_the_tile_that_holds_it(served, name):
    """After the 8 decode steps (positions 28-35) each rank's K/V tiles are
    the JAX cache's segment: positions 28-31 written by the first "model"
    rank, 32-35 by the second, nothing else changed."""
    inp, res = served
    _, _, final = _jax_run(name, inp)
    for rank, r in enumerate(res):
        for k in ("k", "v"):
            np.testing.assert_allclose(r[name]["final_cache"][k],
                                       final[k][:, _rows(rank), _segment(rank)], **TOL[name],
                                       err_msg=f"{name} rank {rank} {k}")
    written = np.abs(res[1][name]["final_cache"]["k"]).sum(axis=(0, 1, 3, 4)) > 0
    assert written.tolist() == [True] * (T + STEPS - CACHE // 2) + [False] * (CACHE - T - STEPS)


def test_rwkv6_states_are_the_rows_whole(served):
    inp, res = served
    _, cache, _ = _jax_run("rwkv6-3b", inp)
    for rank, r in enumerate(res):
        for k in ("tm_shift", "cm_shift", "wkv"):
            np.testing.assert_allclose(r["rwkv6-3b"]["cache"][k], cache[k][:, _rows(rank)],
                                       **TOL["rwkv6-3b"])


@pytest.mark.parametrize("name", ["smollm-135m", "zamba2-1.2b"])
def test_a_shard_start_one_off_fails_the_merge(served, name):
    _, res = served
    for r in res:
        e = r[name]["start_errs"]
        assert r[name]["axes"] == ["model"]
        assert e["right"] <= 1e-5, e
        assert e["one_off"] > 100 * 1e-5, e
    assert [r[name]["start"] for r in res] == [0, CACHE // 2, 0, CACHE // 2]


@pytest.mark.parametrize("name,family", [("phi3.5-moe-42b-a6.6b", "the MoE family"),
                                         ("llava-next-mistral-7b", "the VLM family"),
                                         ("seamless-m4t-medium", "the enc-dec family")])
def test_mesh_serving_of_the_moe_vlm_and_encdec_families_matches_jax(served, name, family):
    """The reduced MoE, VLM and enc-dec families through the same prefill
    and 8 decode steps (the VLM's 28 tokens behind its 16 patches, the
    enc-dec model's beside 20 frames): every call's logits of each rank's
    rows against the JAX package's (``tests/test_torch_moe.py``'s 2e-5 for
    the MoE model, ``tests/test_torch_vlm.py``'s and
    ``test_torch_encdec.py``'s atol 2e-4, rtol 2e-3 for the others).
    ``tests/test_torch_serve_mesh_families.py`` holds these families'
    caches, drops and tile crossings in detail."""
    inp, res = served
    extra = inp["families"][name]["extra"]
    want, _, _ = _jax_run(name, inp, extra)
    tol = {"atol": 2e-5, "rtol": 0} if "moe" in name else {"atol": 2e-4, "rtol": 2e-3}
    for rank, r in enumerate(res):
        got = r[name]["logits"]
        assert len(got) == STEPS + 1, family
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w[_rows(rank)], **tol,
                                       err_msg=f"{name} rank {rank} call {step}")
