"""The MoE, VLM and enc-dec families' mesh serving steps
(``runtime/steps.py`` ``build_prefill_step`` and ``build_decode_step`` on a
mesh) on a 2 x 2 ("data", "model") mesh of gloo ranks on the CPU, against
the JAX package's one-device ``prefill`` and ``decode`` on the same weights
(``params_from_jax``), in f32; each prefill fills a cache of 64 positions
(tiles of 32 over "model") and 8 decode steps cross the tiles' boundary:

* phi3.5-moe reduced at ``capacity_factor`` 1.0, its router x100
  (``tests/test_torch_moe.py``'s ROUTER_SCALE): 16 prompts of 28 tokens
  (groups of 16 tokens across the sequence shards of 14 and the rows),
  decode at positions 28-35, where the 16 rows are one group of 16 tokens
  across both "data" ranks (8 rows each): the capacity of 8 binds and
  tokens drop (asserted), each rank's slots counting the other's rows;
* llava-next reduced: 16 patches and 12 text tokens (S = 28: the first
  "model" rank of each row holds only patches), decode at 28-35;
* seamless-m4t reduced: 20 frames and 28 tokens, the memory's K/V written
  as tiles of 10 frames over "model"; each decode step's cross-attention
  runs the decode kernel's plain version over the rank's memory tile with
  every row at the memory's last position, the tiles merged.

Each call's logits of each rank's rows within ``tests/test_torch_moe.py``'s
2e-5 (MoE, f32) and ``tests/test_torch_vlm.py`` / ``test_torch_encdec.py``'s
atol 2e-4, rtol 2e-3; each rank's K/V cache tiles after the prefill and
after the last step against the JAX cache's segment, and seamless's memory
tiles against the JAX memory's.

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

CACHE, STEPS = 64, 8
TOL = {"phi3.5-moe-42b-a6.6b": {"atol": 2e-5, "rtol": 0},
       "llava-next-mistral-7b": {"atol": 2e-4, "rtol": 2e-3},
       "seamless-m4t-medium": {"atol": 2e-4, "rtol": 2e-3}}
OVER = {"phi3.5-moe-42b-a6.6b": {"capacity_factor": 1.0}}


def _jax(name):
    m = jax_build_model(jax_get_arch(name).reduced(**OVER.get(name, {})))
    p = m.init(jax.random.key(0))
    if "moe" in name:
        p["layers"]["router"] = p["layers"]["router"] * 100.0
    return m, p


def _case(name, rng) -> dict:
    B = 16 if "moe" in name else 4
    T = 12 if "llava" in name else 28
    extra = {}
    if "llava" in name:
        extra["patch_embeds"] = rng.standard_normal((B, 16, 128)).astype(np.float32)
    if "seamless" in name:
        extra["frame_embeds"] = rng.standard_normal((B, 20, 128)).astype(np.float32)
    return {"tokens": rng.integers(1, 512, (B, T)).astype(np.int32), "extra": extra,
            "steps": rng.integers(1, 512, (STEPS, B, 1)).astype(np.int32), "cache_len": CACHE,
            "overrides": OVER.get(name, {}), "params": jax.tree.map(np.asarray, _jax(name)[1])}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_mesh_families")
    rng = np.random.default_rng(9)
    inp = {name: _case(name, rng) for name in TOL}
    res = spawn_ranks(cases.serve_families_cases, 4, init_method=f"file://{d}/store",
                      args=(inp,), timeout=120)
    return inp, res


def _jax_run(name, case):
    """The JAX package's one-device prefill and decode: every call's
    logits, the prefill's cache (K/V grown to CACHE by zeros) and the cache
    after the last decode step."""
    m, p = _jax(name)
    batch = {"tokens": jnp.asarray(case["tokens"]),
             **{k: jnp.asarray(v) for k, v in case["extra"].items()}}
    logits, cache = jax.jit(m.prefill)(p, batch)
    S = cache["k"].shape[2]
    out = [np.asarray(logits)]
    pad = [(0, 0), (0, 0), (0, CACHE - S), (0, 0), (0, 0)]
    grown = dict(cache, **{k: jnp.pad(cache[k], pad) for k in ("k", "v")})
    first = jax.tree.map(np.asarray, grown)
    dec = jax.jit(m.decode)
    B = case["tokens"].shape[0]
    for i, tok in enumerate(case["steps"]):
        batch = {"tokens": jnp.asarray(tok), "positions": jnp.full((B,), S + i, jnp.int32)}
        logits, grown = dec(p, grown, batch)
        out.append(np.asarray(logits))
    return out, first, jax.tree.map(np.asarray, grown)


def _rows(rank, B):
    d = rank // 2
    return slice(d * B // 2, (d + 1) * B // 2)


def _segment(rank, n):
    m = rank % 2
    return slice(m * n // 2, (m + 1) * n // 2)


@pytest.mark.parametrize("name", list(TOL))
def test_mesh_prefill_and_decode_logits_match_jax(served, name):
    inp, res = served
    want, _, _ = _jax_run(name, inp[name])
    B = inp[name]["tokens"].shape[0]
    for rank, r in enumerate(res):
        got = r[name]["logits"]
        assert len(got) == STEPS + 1
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w[_rows(rank, B)], **TOL[name],
                                       err_msg=f"{name} rank {rank} call {step}")


@pytest.mark.parametrize("name", list(TOL))
def test_mesh_cache_tiles_are_the_jax_cache_segments(served, name):
    """After the prefill and after the last step, each rank's K/V tiles
    (and seamless's memory tiles) are the JAX caches' segments."""
    inp, res = served
    _, first, final = _jax_run(name, inp[name])
    B = inp[name]["tokens"].shape[0]
    for rank, r in enumerate(res):
        for key, cache in (("cache", first), ("final_cache", final)):
            for k in ("k", "v"):
                np.testing.assert_allclose(r[name][key][k],
                                           cache[k][:, _rows(rank, B), _segment(rank, CACHE)],
                                           **TOL[name], err_msg=f"{name} {key} {k} rank {rank}")
        if "seamless" in name:
            for k in ("k_mem", "v_mem"):
                mem = first[k]
                np.testing.assert_allclose(r[name]["cache"][k],
                                           mem[:, _rows(rank, B), _segment(rank, mem.shape[2])],
                                           **TOL[name], err_msg=f"{name} {k} rank {rank}")


def test_moe_decode_group_spans_the_data_ranks_and_drops(served):
    """Each decode call routes the rank's 8 rows (one group of 16 with the
    other "data" rank's 8): per call and layer 16 x 2 choices over both
    ranks, 4 experts of capacity 8; some drop."""
    _, res = served
    name = "phi3.5-moe-42b-a6.6b"
    routed = kept = 0
    for r in res:
        decode = [(n, rt, k) for n, rt, k in r[name]["routes"] if n == 8]
        assert len(decode) == STEPS * 2  # two layers a step
        routed += sum(rt for _, rt, _ in decode)
        kept += sum(k for _, _, k in decode)
    assert routed == 2 * (16 * 2 * 2 * STEPS)  # the two "model" ranks route the same rows
    assert kept < routed, (kept, routed)
