"""bf16 tensor-parallel serving on a mesh (``runtime/steps.py`` on a (2, 2)
("data", "model") mesh of gloo ranks on the CPU), held to one device.

A bf16 row-parallel product (``models/common.py`` ``row_product``) sums the
ranks' f32 partial products and rounds once after the ``psum``; the
one-device product rounds its own f32 sum once. The reduced smollm at bf16
compute, from the JAX weights, serves 4 prompts of 28 tokens into a cache of
64 positions (two tiles of 32), then 10 greedy decode steps across the
tiles' boundary, each rank feeding its rows' argmax. Every served token
must be the argmax of the one-device bf16 steps fed the same tokens
wherever their top-2 gap exceeds 0.05 (``PERF.md`` §2's rule for a served
token, ``chip_smoke.py``'s ``RESCORE_GAP``): the port's one-device steps
and the JAX package's ``prefill`` / ``decode`` alike. Every call's logits
lie within 2^-4 x max|logit| of the port's one-device steps' (bf16 keeps 8
significant bits; the two sums round at other points over 2 layers); a
row-parallel slice one tile off leaves them by far more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_cases as cases
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.launch.mesh import spawn_ranks

B, T, CACHE, STEPS = 4, 28, 64, 10
GAP = 0.05
LOGIT_REL = 2.0 ** -4


def _jax():
    m = jax_build_model(jax_get_arch("smollm-135m").reduced(compute_dtype="bfloat16"))
    return m, m.init(jax.random.key(0))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_mesh_bf16")
    rng = np.random.default_rng(31)
    inp = {"tokens": rng.integers(1, 512, (B, T)).astype(np.int32), "cache_len": CACHE,
           "n_steps": STEPS, "params": jax.tree.map(np.asarray, _jax()[1])}
    res = spawn_ranks(cases.serve_bf16_cases, 4, init_method=f"file://{d}/store",
                      args=(inp,), timeout=120)
    return inp, res


@pytest.fixture(scope="module")
def mutated(tmp_path_factory, served):
    d = tmp_path_factory.mktemp("serve_mesh_bf16_mutated")
    inp = dict(served[0], mutate=True)
    return spawn_ranks(cases.serve_bf16_cases, 4, init_method=f"file://{d}/store",
                       args=(inp,), timeout=120)


def _flips(tokens: list, logits: list) -> tuple[int, int]:
    """(served tokens that are not the argmax where its top-2 gap exceeds
    GAP, tokens served)."""
    flips = n = 0
    for tok, w in zip(tokens, logits):
        last = np.asarray(w, np.float32)[:, -1]
        top2 = np.sort(last, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > GAP
        flips += int((sure & (tok[:, 0] != last.argmax(-1))).sum())
        n += len(tok)
    return flips, n


def test_bf16_mesh_tokens_are_the_one_device_port_argmax_by_the_gap_rule(served):
    _, res = served
    for rank, r in enumerate(res):
        flips, n = _flips(r["tokens"], r["one_logits"])
        assert n == STEPS * B // 2
        assert flips == 0, f"rank {rank}: {flips} of {n} served tokens flipped past the gap"


def test_bf16_mesh_tokens_are_the_jax_argmax_by_the_gap_rule(served):
    """The JAX package's one-device bf16 steps fed the mesh's tokens (rows
    0-1 from the first "data" rank, 2-3 from the second)."""
    inp, res = served
    m, p = _jax()
    steps = [np.concatenate([res[0]["tokens"][i], res[2]["tokens"][i]]) for i in range(STEPS)]
    logits, cache = jax.jit(m.prefill)(p, {"tokens": jnp.asarray(inp["tokens"])})
    pad = [(0, 0), (0, 0), (0, CACHE - T), (0, 0), (0, 0)]
    cache = dict(cache, **{k: jnp.pad(cache[k], pad) for k in ("k", "v")})
    want = [np.asarray(logits)]
    dec = jax.jit(m.decode)
    for i, tok in enumerate(steps[:-1]):
        logits, cache = dec(p, cache, {"tokens": jnp.asarray(tok),
                                       "positions": jnp.full((B,), T + i, jnp.int32)})
        want.append(np.asarray(logits))
    for rank, r in enumerate(res):
        rows = slice(*r["rows"])
        flips, n = _flips(r["tokens"], [w[rows] for w in want])
        assert flips == 0, f"rank {rank}: {flips} of {n} served tokens flipped past the gap"


def test_bf16_mesh_logits_lie_near_the_one_device_logits(served):
    _, res = served
    for rank, r in enumerate(res):
        assert len(r["mesh_logits"]) == STEPS + 1
        for step, (g, w) in enumerate(zip(r["mesh_logits"], r["one_logits"])):
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= LOGIT_REL, f"rank {rank} call {step}: {err}"


def test_a_row_parallel_slice_one_tile_off_leaves_the_one_device_logits(mutated):
    worst = max(np.abs(g - w).max() / np.abs(w).max()
                for r in mutated for g, w in zip(r["mesh_logits"][1:], r["one_logits"][1:]))
    assert worst > 4 * LOGIT_REL
