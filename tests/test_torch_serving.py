"""The port's serving engine (``repro_torch.serving``) against the JAX
package's (CPU), on the same weights (``params_from_jax``) and the same
seeded ``heavy_tail_trace``.

At the reduced f32 config the greedy tokens must be **identical** to the
JAX batcher's — with ``decode_quantum`` 1 and 4 — and to the JAX batcher
that routes decode attention through the Pallas kernel in interpret mode;
the pure-Python allocator, admission and trace cases are the JAX suite's
(``tests/test_serving.py``), run on the port's copies.
"""
from dataclasses import dataclass
from typing import Any

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.miniapps import LMServeApp as JaxLMServeApp
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatcher as JaxContinuousBatcher
from repro.serving import heavy_tail_trace as jax_heavy_tail_trace
from repro_torch.configs import get_arch
from repro_torch.elastic.metrics import MetricsBus
from repro_torch.miniapps import LMServeApp
from repro_torch.models import build_model, params_from_jax
from repro_torch.serving import (
    ADMIT,
    QUEUE,
    REJECT,
    AdmissionController,
    ContinuousBatcher,
    PageAllocError,
    PagedKVCache,
    PagePool,
    Request,
    TraceConfig,
    heavy_tail_trace,
    trace_summary,
)
from repro_torch.streaming.dispatch import ShapeBuckets, next_pow2, pad_rows

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL_TRACE = dict(n_requests=10, seed=3, rate=64.0, prompt_median=10,
                   max_prompt=40, out_median=5, out_sigma=0.5, max_output=10)


@dataclass
class Msg:
    value: Any
    timestamp: float = 0.0


@pytest.fixture(scope="module")
def served():
    """The reduced config in both packages, the JAX params and their port
    copy — shared, never mutated."""
    jm = jax_build_model(jax_get_arch("smollm-135m").reduced())
    jp = jm.init(jax.random.key(0))
    tm = build_model(get_arch("smollm-135m").reduced())
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def run_trace(batcher, trace):
    now = 0.0
    verdicts = []
    for r in trace:
        now = max(now, r.arrival)
        verdicts.append(batcher.submit(r, now))
        now += batcher.step(now)
    batcher.drain(now)
    return verdicts


def _batcher(tm, tp, **kw):
    b = ContinuousBatcher(tm, device=CPU, **{"n_pages": 64, "page_size": 8, **kw})
    b.params = tp
    return b


@pytest.fixture(scope="module")
def jax_tokens(served):
    """The JAX batcher's greedy tokens on SMALL_TRACE, by request id."""
    jm, jp, _, _ = served
    b = JaxContinuousBatcher(jm, n_pages=64, page_size=8, max_queue=32)
    b.params = jp
    trace = jax_heavy_tail_trace(**SMALL_TRACE, vocab=512)
    run_trace(b, trace)
    return {rid: list(r["tokens"]) for rid, r in b.results.items()}


# ---------------------------------------------------------------------------
# page pool, admission, trace, buckets (the JAX suite's pure-Python cases)
# ---------------------------------------------------------------------------


def test_page_pool_alloc_release_conservation():
    pool = PagePool(9, 4)
    assert pool.capacity_pages == 8  # page 0 reserved
    assert pool.alloc("a", 3) and pool.alloc("b", 5)
    assert pool.free_pages == 0
    assert not pool.alloc("c", 1), "over-capacity alloc must fail atomically"
    assert "c" not in pool.sequences()
    pool.check_invariants()
    assert pool.release("a") == 3
    assert pool.alloc("c", 3)
    assert pool.release("b") == 5 and pool.release("c") == 3
    assert pool.free_pages == pool.capacity_pages
    pool.check_invariants()


def test_page_pool_rejects_impossible_request():
    pool = PagePool(4, 2)
    with pytest.raises(PageAllocError):
        pool.alloc("x", 99)
    pool.check_invariants()


def test_page_pool_ensure_grows_to_token_count():
    pool = PagePool(8, 4)
    assert pool.ensure("s", 10)
    assert pool.capacity_tokens("s") == 12
    assert pool.ensure("s", 12)
    assert len(pool.owned("s")) == 3
    assert pool.ensure("s", 13)
    assert len(pool.owned("s")) == 4
    pool.check_invariants()


def test_paged_cache_table_pads_with_scratch_and_truncates():
    cache = PagedKVCache(1, 1, 4, n_pages=8, page_size=2, device=CPU)
    assert cache.admit("a", 6)  # 3 pages
    t = cache.table(["a"], 4)
    assert t.shape == (1, 4) and t[0, 3] == 0 and (t[0, :3] > 0).all()
    with pytest.raises(ValueError):
        cache.table(["a"], 2)
    t = cache.table(["a"], 2, truncate=True)
    assert (t[0] == cache.pool.owned("a")[:2]).all()
    t = cache.table(["a"], 4, rows=3)
    assert t.shape == (3, 4) and (t[1:] == 0).all()
    assert cache.k.shape == (1, 8, 2, 1, 4) and cache.k.device == CPU


def test_admission_rate_limit_rejects_at_the_door():
    adm = AdmissionController(PagePool(64, 16), rate=10.0, burst=20.0)
    assert adm.offer(16, 0.0, queue_depth=0) == ADMIT
    assert adm.offer(16, 0.0, queue_depth=0) == REJECT
    assert adm.offer(16, 2.0, queue_depth=0) == ADMIT
    assert adm.stats.rejected_rate == 1


def test_admission_queues_then_rejects_when_full():
    pool = PagePool(3, 4)
    adm = AdmissionController(pool, max_queue=2)
    assert adm.offer(8, 0.0, queue_depth=0) == ADMIT
    pool.alloc("a", 2)
    assert adm.offer(4, 0.0, queue_depth=0) == QUEUE
    assert adm.offer(4, 0.0, queue_depth=1) == QUEUE
    assert adm.offer(4, 0.0, queue_depth=2) == REJECT
    assert adm.stats.as_dict()["rejected_queue_full"] == 1


def test_admission_fifo_no_bypass_and_headroom():
    pool = PagePool(5, 4)
    adm = AdmissionController(pool)
    pool.alloc("live", 3)  # 1 page free
    assert adm.offer(8, 0.0, queue_depth=0) == QUEUE
    assert adm.offer(2, 0.0, queue_depth=1) == QUEUE  # would fit, but FIFO
    reserve = AdmissionController(PagePool(5, 4), headroom_pages=2)
    assert reserve.can_place(8) and not reserve.can_place(9)


def test_trace_is_seed_deterministic_and_equals_the_jax_trace():
    a = heavy_tail_trace(TraceConfig(seed=7))
    assert a == heavy_tail_trace(TraceConfig(seed=7)) != heavy_tail_trace(TraceConfig(seed=8))
    j = jax_heavy_tail_trace(seed=7)
    assert [(r.rid, r.arrival, r.prompt, r.out_tokens) for r in a] == \
        [(r.rid, r.arrival, r.prompt, r.out_tokens) for r in j]
    s = trace_summary(a)
    assert s["n_requests"] == len(a) and s["prompt_p99"] >= s["prompt_p50"]


def test_shape_buckets_and_padding():
    b = ShapeBuckets(min_size=3, max_size=16)
    assert b.sizes == (4, 8, 16) and [b.fit(n) for n in (1, 4, 5, 16, 17, 40)] == [4, 4, 8, 16, 32, 48]
    assert [next_pow2(n) for n in (0, 1, 2, 3, 9)] == [1, 1, 2, 4, 16]
    x = np.ones((3, 2), np.int32)
    assert pad_rows(x, 2) is x and pad_rows(x, 5).tolist() == [[1, 1]] * 3 + [[0, 0]] * 2


# ---------------------------------------------------------------------------
# continuous batcher against the JAX batcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantum", [1, 4])
def test_batcher_tokens_identical_to_jax(served, jax_tokens, quantum):
    _, _, tm, tp = served
    trace = heavy_tail_trace(**SMALL_TRACE, vocab=512)
    b = _batcher(tm, tp, max_queue=32, decode_quantum=quantum)
    verdicts = run_trace(b, trace)
    assert REJECT not in verdicts
    for r in trace:
        assert list(b.results[r.rid]["tokens"]) == jax_tokens[r.rid], r.rid
        assert len(b.results[r.rid]["tokens"]) == r.out_tokens  # budget mask holds
        assert b.results[r.rid]["finish"] >= b.results[r.rid]["first_token"] >= r.arrival
    assert b.cache.pool.used_pages == 0, "finished sequences must free pages"
    b.cache.pool.check_invariants()
    assert b.idle and not b._journal


def test_batcher_tokens_identical_to_jax_pallas_decode(served):
    """The JAX batcher with decode attention in the Pallas kernel
    (interpret mode) emits the same tokens as the port's."""
    jm, jp, tm, tp = served
    trace = heavy_tail_trace(**{**SMALL_TRACE, "n_requests": 6}, vocab=512)
    ker = JaxContinuousBatcher(jm, n_pages=64, page_size=8, use_kernel=True, interpret=True)
    ker.params = jp
    run_trace(ker, jax_heavy_tail_trace(**{**SMALL_TRACE, "n_requests": 6}, vocab=512))
    b = _batcher(tm, tp)
    run_trace(b, trace)
    for r in trace:
        assert b.results[r.rid]["tokens"] == ker.results[r.rid]["tokens"], r.rid


def test_crash_mid_trace_recovers_no_dupes_no_losses(served, jax_tokens):
    _, _, tm, tp = served
    trace = heavy_tail_trace(**SMALL_TRACE, vocab=512)
    for crash_at in (0, len(trace) // 2, len(trace) - 1):
        b = _batcher(tm, tp, max_queue=32)
        now = 0.0
        for i, r in enumerate(trace):
            now = max(now, r.arrival)
            b.submit(r, now)
            now += b.step(now)
            if i == crash_at:
                b.crash()
                assert b.cache.pool.used_pages == 0
                b.recover()
        b.drain(now)
        assert set(b.results) == set(jax_tokens), crash_at
        for rid, toks in jax_tokens.items():
            assert list(b.results[rid]["tokens"]) == toks, (crash_at, rid)
        b.cache.pool.check_invariants()


def test_batcher_queue_admits_as_pages_free(served):
    """A pool sized for about one request at a time still serves the whole
    trace, with the JAX batcher's tokens."""
    jm, jp, tm, tp = served
    kw = dict(n_requests=6, seed=5, rate=512.0, prompt_median=8, max_prompt=16,
              out_median=4, max_output=6, vocab=512)
    ref = JaxContinuousBatcher(jm, n_pages=7, page_size=8, max_queue=16)
    ref.params = jp
    run_trace(ref, jax_heavy_tail_trace(**kw))
    b = _batcher(tm, tp, n_pages=7, max_queue=16)
    trace = heavy_tail_trace(**kw)
    verdicts = run_trace(b, trace)
    assert QUEUE in verdicts and REJECT not in verdicts
    for r in trace:
        assert b.results[r.rid]["tokens"] == ref.results[r.rid]["tokens"]


def test_batcher_rejects_never_ghost(served):
    _, _, tm, tp = served
    trace = heavy_tail_trace(**SMALL_TRACE, vocab=512)
    b = _batcher(tm, tp, rate=60.0, burst=60.0)
    verdicts = run_trace(b, trace)
    assert REJECT in verdicts, "tight rate must shed something"
    rejected = {r.rid for r, v in zip(trace, verdicts) if v == REJECT}
    assert set(b.results) == {r.rid for r in trace} - rejected
    assert b.admission.stats.rejected_rate == len(rejected)


def test_batcher_eos_exits_early_and_frees_pages(served):
    _, _, tm, tp = served
    b = _batcher(tm, tp, n_pages=32)
    b.submit(Request(0, 0.0, (5, 6, 7), 6), 0.0)
    b.drain(0.0)
    eos = b.results[0]["tokens"][0]
    b2 = _batcher(tm, tp, n_pages=32, eos_id=int(eos))
    b2.submit(Request(1, 0.0, (5, 6, 7), 6), 0.0)
    b2.drain(0.0)
    assert b2.results[1]["tokens"] == (eos,)
    assert b2.cache.pool.used_pages == 0


def test_batcher_burst_stacked_prefill_and_bounded_shapes(served, jax_tokens):
    """Every request at t=0: joiners prefill as multi-row calls (one per
    prompt bucket); the step shapes stay within the bucket cross-products,
    and a warmed-up batcher meets no new shape on a replay."""
    _, _, tm, tp = served
    trace = heavy_tail_trace(**SMALL_TRACE, vocab=512)
    b = _batcher(tm, tp, max_queue=32)
    for r in trace:
        assert b.submit(r, 0.0) != REJECT
    b.drain(0.0)
    for r in trace:
        assert list(b.results[r.rid]["tokens"]) == jax_tokens[r.rid], r.rid
    n_prompt = len({b.prompt_buckets.fit(r.prompt_len) for r in trace})
    assert 1 <= len(b.prefill_shapes) <= len(b.batch_buckets.sizes) * n_prompt
    assert len(b.decode_shapes) <= len(b.batch_buckets.sizes) * len(b.pages_buckets.sizes)
    assert any(rows > 1 for rows, _ in b.prefill_shapes)

    w = _batcher(tm, tp, max_queue=32)
    assert w.warmup(max_prompt=max(r.prompt_len for r in trace),
                    max_tokens=max(r.total_tokens for r in trace), max_live=16) > 0
    assert w.cache.pool.used_pages == 0
    shapes = (set(w.prefill_shapes), set(w.decode_shapes))
    run_trace(w, trace)
    assert (w.prefill_shapes, w.decode_shapes) == shapes, "a shape the warmup missed"
    assert {r: list(x["tokens"]) for r, x in w.results.items()} == jax_tokens


def test_batcher_params_cast_once_and_gauges(served):
    _, _, tm, tp = served
    bus = MetricsBus()
    b = ContinuousBatcher(tm, n_pages=16, page_size=8, device=CPU, metrics=bus)
    assert b.params is None
    b.params = tp
    cast = b.params
    b.params = tp  # the same params again: no new cast
    assert b.params is cast
    b.submit(Request(0, 0.0, (1, 2, 3), 2), 0.0)
    b.drain(0.0)
    # gauges are published at the start of each step: the last one saw the
    # request's pages still held
    assert bus.latest("serving.free_pages").value == b.cache.pool.capacity_pages - 1
    assert b.cache.free_pages == b.cache.pool.capacity_pages
    assert len(b.latency) == 1


# ---------------------------------------------------------------------------
# LMServeApp
# ---------------------------------------------------------------------------


def _msgs(rng, n_msgs=2, batch=2, prompt_len=12):
    return [Msg(rng.integers(1, 512, size=(batch, prompt_len)).astype(np.int32))
            for _ in range(n_msgs)]


def test_lm_serve_lockstep_equals_continuous_equals_jax(served):
    jm, jp, tm, tp = served
    msgs = _msgs(np.random.default_rng(11))
    cfg = get_arch("smollm-135m").reduced()
    lock = LMServeApp(cfg, prompt_len=12, gen_tokens=5, batch=2, device=CPU)
    cont = LMServeApp(cfg, prompt_len=12, gen_tokens=5, batch=2, mode="continuous",
                      n_pages=64, page_size=8, device=CPU)
    ref = JaxLMServeApp(jax_get_arch("smollm-135m").reduced(), prompt_len=12, gen_tokens=5,
                        batch=2)
    a = lock.generate_tokens(tp, msgs)
    c = cont.generate_tokens(tp, msgs)
    assert a.shape == c.shape == (4, 5)
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(a, ref.generate_tokens(jp, msgs))


def test_lm_serve_process_counts_and_stream_state(served):
    _, _, tm, tp = served
    bus = MetricsBus()
    cfg = get_arch("smollm-135m").reduced()
    for mode in ("lockstep", "continuous"):
        app = LMServeApp(cfg, prompt_len=12, gen_tokens=4, batch=2, mode=mode,
                         n_pages=64, page_size=8, metrics=bus, device=CPU)
        assert app.process(tp, _msgs(np.random.default_rng(13))) is tp  # state = params
        app.sync()
        assert app.stats.batches == 1 and app.stats.items == 4 * 4
    assert bus.latest("serving.page_utilization") is not None
    with pytest.raises(ValueError):
        LMServeApp(cfg, mode="beam", device=CPU)
