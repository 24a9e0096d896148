"""Continuous (in-flight) batching scheduler over the paged KV cache.

The lockstep serving path (``LMServeApp``) prefills a whole micro-batch
together and decodes a fixed token budget in a fused scan — every request
waits for the batch's longest prompt, and a finished row keeps occupying its
batch slot to the end. The :class:`ContinuousBatcher` replaces that with a
per-token scheduler loop:

1. queued prompts whose lifetime fits the free pages prefill as stacked
   rows — grouped by prompt bucket, one dispatch per (row-bucket, prompt-
   bucket) pair — and *join the live decode batch mid-stream*;
2. the live batch takes one greedy decode step against the page pool
   (gather/scatter in ``runtime/steps.py``; batch size and table width are
   shape-bucketed, so the set of step shapes stays bounded);
3. finished sequences (budget or EOS) exit immediately, releasing their
   pages — which is exactly what admits the next queued prompt.

Admission is **reservation-based**: pages for a request's whole lifetime
(``max(prompt_bucket, prompt + out_budget)`` tokens) are allocated at admit
time, so a live sequence can never stall mid-decode waiting for pages —
``lost_requests = 0`` by construction, traded against the higher pool
utilization an incremental allocator (with preemption) could reach.

Time is virtual: callers pass ``now`` into :meth:`submit`/:meth:`step`; the
step measures its own device time (host clock around work that ends in a
device synchronisation) and stamps first-token/finish events at
``now + measured``, so the benchmark can replay a trace on a virtual clock
with no sleeping and the same code path serves real wall-clock callers.

Crash/recovery (the serving pilot contract): every admitted-or-queued
request sits in a journal until its response is recorded; ``crash()`` drops
all live state including the device pages, ``recover()`` re-queues the
journal in arrival order. Completed responses are never re-run (journal
entries are removed on delivery) and greedy decode is deterministic, so a
mid-trace crash yields the same response set as a fault-free run — no
duplicates, no losses.

This is the port's copy of ``repro/serving/batcher.py``. The pools live on
the batcher's device (CUDA unless a CPU device is named) and the steps
update them in place; on CUDA, prefill attention runs the flash kernel and
decode attention the decode kernel. PyTorch does not compile per shape, so
the JAX package's compile counts become ``prefill_shapes`` and
``decode_shapes``: the distinct step shapes seen.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core.service import resolve_device
from repro_torch.runtime.steps import build_paged_decode_step, build_paged_prefill_step
from repro_torch.serving.admission import ADMIT, QUEUE, AdmissionController
from repro_torch.serving.pages import PagedKVCache
from repro_torch.serving.trace import Request
from repro_torch.streaming.dispatch import LatencyWindow, ShapeBuckets


@dataclass
class _Seq:
    """One live sequence: its request plus decode-loop position state."""

    req: Request
    tokens: list[int] = field(default_factory=list)  # generated so far
    t_first: float = 0.0

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def pos(self) -> int:
        """Write index of the next decode step (= live cache length)."""
        return self.req.prompt_len + len(self.tokens) - 1

    def done(self, eos_id: int | None) -> bool:
        if len(self.tokens) >= self.req.out_tokens:
            return True
        return eos_id is not None and bool(self.tokens) and self.tokens[-1] == eos_id


class ContinuousBatcher:
    """Scheduler loop: admit → prefill-into-pages → joint decode → exit.

    ``params`` must be assigned before the first :meth:`step` (the serving
    state arrives with the stream, not at construction); assigning casts the
    matmul weights to the compute dtype once (``model.compute_params``), and
    assigning the same params again is free. All scheduling is host-side
    and deterministic: live order is admission order, the queue is FIFO
    with no head-of-line bypass.
    """

    def __init__(self, model: Any, *, n_pages: int = 256, page_size: int = 16,
                 cache: PagedKVCache | None = None, eos_id: int | None = None,
                 rate: float = 0.0, burst: float | None = None, max_queue: int = 64,
                 max_live: int = 64, metrics: Any = None, stream: str = "serving",
                 decode_quantum: int = 1, device: torch.device | str = "cuda"):
        self.model = model
        self.device = cache.device if cache is not None else resolve_device(device)
        self._params_src: Any = None
        self._params: Any = None
        self.cache = cache or PagedKVCache.from_model(
            model, n_pages=n_pages, page_size=page_size, device=self.device)
        ps = self.cache.page_size
        self.eos_id = eos_id
        self.max_live = int(max_live)
        self.metrics = metrics
        self._labels = {"stream": stream}
        self.admission = AdmissionController(
            self.cache.pool, rate=rate, burst=burst, max_queue=max_queue)
        # buckets: prompt lengths (>= page_size => always page multiples),
        # live-batch rows, and page-table width — these bound the step shapes
        self.prompt_buckets = ShapeBuckets(min_size=ps, max_size=4 * ps)
        self.batch_buckets = ShapeBuckets(min_size=1, max_size=self.max_live)
        self.pages_buckets = ShapeBuckets(
            min_size=1, max_size=max(self.cache.pool.capacity_pages, 1))
        self._prefill = build_paged_prefill_step(model, page_size=ps)
        # >1 amortizes per-call host overhead: one call emits q tokens per
        # live row, surplus past a row's budget/EOS discarded on the host
        self.decode_quantum = max(int(decode_quantum), 1)
        self._decode = build_paged_decode_step(model, page_size=ps, quantum=self.decode_quantum)
        #: distinct step shapes run: (rows, prompt bucket) and (rows, pages)
        self.prefill_shapes: set[tuple[int, int]] = set()
        self.decode_shapes: set[tuple[int, int]] = set()

        self._queue: deque[Request] = deque()
        self._pending: list[Request] = []  # admitted, awaiting prefill
        self._live: list[_Seq] = []
        self._journal: dict[int, Request] = {}  # rid -> not-yet-delivered
        self.results: dict[int, dict] = {}  # rid -> delivered response
        self.latency = LatencyWindow()  # arrival -> finish, per request

    @property
    def params(self) -> Any:
        return self._params

    @params.setter
    def params(self, params: Any) -> None:
        if params is self._params_src:
            return
        self._params_src = params
        self._params = None if params is None else self.model.compute_params(params)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # ---- arrival side -----------------------------------------------------

    def submit(self, req: Request, now: float = 0.0) -> str:
        """Classify one arrival; ADMIT reserves its lifetime pages now."""
        verdict = self.admission.offer(
            self._lifetime_tokens(req), now, queue_depth=len(self._queue))
        if verdict == ADMIT:
            ok = self.cache.admit(req.rid, self._lifetime_tokens(req))
            assert ok, "admission said place but the pool refused"
            self._pending.append(req)
            self._journal[req.rid] = req
        elif verdict == QUEUE:
            self._queue.append(req)
            self._journal[req.rid] = req
        return verdict

    def _lifetime_tokens(self, req: Request) -> int:
        # prefill scatters the whole prompt bucket, so the reservation covers
        # max(bucket, true lifetime)
        return max(self.prompt_buckets.fit(req.prompt_len), req.total_tokens)

    # ---- the scheduler step ----------------------------------------------

    def step(self, now: float = 0.0) -> float:
        """One scheduler iteration: drain the queue into free pages, prefill
        joiners, one decode step for the live batch, retire finished
        sequences. Returns the measured device seconds (the caller advances
        its clock by this)."""
        self._publish_gauges()
        # FIFO drain: strictly the head, so a small request can never starve
        # a big one that arrived first
        while (self._queue and len(self._live) + len(self._pending) < self.max_live
               and self.admission.can_place(self._lifetime_tokens(self._queue[0]))):
            req = self._queue.popleft()
            ok = self.cache.admit(req.rid, self._lifetime_tokens(req))
            assert ok
            self._pending.append(req)
        dt = 0.0
        if self._pending and self.params is not None:
            t0 = time.monotonic()
            joiners, self._pending = self._pending, []
            self._prefill_joiners(joiners)
            self.cache.synchronize()
            dt += time.monotonic() - t0
            for req in joiners:
                self._seq_of(req.rid).t_first = now + dt
            self._retire(now + dt)  # out_tokens == 1 finishes at prefill
        if self._live:
            t0 = time.monotonic()
            self._decode_step()
            dt += time.monotonic() - t0
            self._retire(now + dt)
        return dt

    def _seq_of(self, rid: int) -> _Seq:
        for s in self._live:
            if s.rid == rid:
                return s
        raise KeyError(rid)

    def _prefill_joiners(self, joiners: list[Request]) -> None:
        """A step's joiners prefill as stacked calls, one per occupied
        prompt bucket: rows padded to a batch bucket, prompts padded to
        their own bucket. Stacking amortizes the per-call host overhead
        that would otherwise dominate an arrival burst; splitting by bucket
        keeps a burst's one long prompt from padding every row to its
        length. Padding rows scatter into scratch page 0 and their sampled
        token is discarded."""
        by_bucket: dict[int, list[Request]] = {}
        for r in joiners:
            by_bucket.setdefault(self.prompt_buckets.fit(r.prompt_len), []).append(r)
        for bucket, group in sorted(by_bucket.items()):
            self._prefill_group(group, bucket)

    def _prefill_group(self, joiners: list[Request], bucket: int) -> None:
        rows = self.batch_buckets.fit(len(joiners))
        toks = np.zeros((rows, bucket), np.int32)
        last = np.zeros((rows,), np.int32)
        for i, r in enumerate(joiners):
            toks[i, : r.prompt_len] = r.prompt
            last[i] = r.prompt_len - 1
        table = self.cache.table(
            [r.rid for r in joiners], bucket // self.cache.page_size,
            rows=rows, truncate=True)
        self.prefill_shapes.add((rows, bucket))
        next_tok, self.cache.k, self.cache.v = self._prefill(
            self.params, self.cache.k, self.cache.v,
            self._dev(toks), self._dev(last), self._dev(table))
        out = next_tok.cpu().numpy().reshape(-1)
        for i, r in enumerate(joiners):
            seq = _Seq(r)
            seq.tokens.append(int(out[i]))
            self._live.append(seq)

    def _decode_step(self) -> None:
        live = self._live
        mp = self.pages_buckets.fit(
            max(len(self.cache.pool.owned(s.rid)) for s in live))
        B = self.batch_buckets.fit(len(live))
        toks = np.zeros((B, 1), np.int32)
        pos = np.zeros((B,), np.int32)
        left = np.zeros((B,), np.int32)  # budget remaining (0 = padding row)
        for i, s in enumerate(live):
            toks[i, 0] = s.tokens[-1]
            pos[i] = s.pos
            left[i] = s.req.out_tokens - len(s.tokens)
        table = self.cache.table((s.rid for s in live), mp, rows=B)
        self.decode_shapes.add((B, mp))
        args = (self.params, self.cache.k, self.cache.v,
                self._dev(toks), self._dev(pos), self._dev(table))
        if self.decode_quantum == 1:
            next_tok, self.cache.k, self.cache.v = self._decode(*args)
            out = next_tok.cpu().numpy().reshape(B, 1)
        else:
            next_tok, self.cache.k, self.cache.v = self._decode(*args, self._dev(left))
            out = next_tok.cpu().numpy()  # (B, quantum)
        keep = 1 if self.decode_quantum == 1 else None
        for i, s in enumerate(live):
            for t in out[i, : keep or max(int(left[i]), 1)]:
                s.tokens.append(int(t))
                if s.done(self.eos_id):
                    break

    def _retire(self, t: float) -> None:
        still = []
        for s in self._live:
            if s.done(self.eos_id):
                self._deliver(s, t)
            else:
                still.append(s)
        self._live = still

    def _deliver(self, s: _Seq, t: float) -> None:
        assert s.rid not in self.results, f"duplicate response for {s.rid}"
        self.results[s.rid] = {
            "tokens": tuple(s.tokens),
            "arrival": s.req.arrival,
            "first_token": s.t_first,
            "finish": t,
        }
        self._journal.pop(s.rid, None)
        self.cache.release(s.rid)
        self.latency.record(max(t - s.req.arrival, 0.0))

    # ---- draining / state ------------------------------------------------

    @property
    def idle(self) -> bool:
        return not (self._live or self._pending or self._queue)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def live_count(self) -> int:
        return len(self._live)

    def drain(self, now: float = 0.0, *, max_steps: int = 100_000) -> float:
        """Step until every submitted request has a response."""
        t = now
        for _ in range(max_steps):
            if self.idle:
                return t
            t += self.step(t)
        raise RuntimeError("drain did not converge (scheduler wedged?)")

    def _publish_gauges(self) -> None:
        if self.metrics is None:
            return
        self.metrics.publish("serving.free_pages", self.cache.free_pages, **self._labels)
        self.metrics.publish("serving.queue_depth", len(self._queue), **self._labels)
        self.metrics.publish("serving.live", len(self._live), **self._labels)
        self.metrics.publish("serving.page_utilization", self.cache.utilization,
                             **self._labels)
        if len(self.latency):
            # the gauges SLOPolicy reads via MetricsSnapshot.latency_p50/p99
            self.metrics.publish("stream.latency_p50", self.latency.p50, **self._labels)
            self.metrics.publish("stream.latency_p99", self.latency.p99, **self._labels)

    # ---- crash / recovery (serving-pilot contract) -----------------------

    def crash(self) -> None:
        """Simulate a pilot kill: device pages and all scheduler state gone.
        ``results`` (delivered responses) and the journal survive — they
        model the durable output stream and the request log."""
        self._live = []
        self._pending = []
        self._queue.clear()
        self.cache.reset()

    def recover(self) -> None:
        """Re-queue every undelivered journaled request in arrival order.
        Greedy decode is deterministic, so regenerated responses are
        identical to what the lost in-flight work would have produced."""
        self._live = []
        self._pending = []
        self._queue = deque(
            sorted(self._journal.values(), key=lambda r: (r.arrival, r.rid)))

    def reset(self) -> None:
        """Full reset for benchmark warmup: drop all serving state."""
        self.crash()
        self._journal.clear()
        self.results.clear()
        self.latency = LatencyWindow()
        self.admission.stats.__init__()
        self.admission.bucket.__post_init__()
        self.admission.bucket._t = 0.0

    def warmup(self, *, max_prompt: int | None = None,
               max_tokens: int | None = None,
               max_live: int | None = None) -> int:
        """Run every bucketed step shape the scheduler can reach, once.

        PyTorch compiles nothing per shape, but a shape's first run still
        pays one-off costs (the caching allocator's first blocks of that
        size, the kernels' libraries loading on first launch) that would
        otherwise land on a virtual clock that bills milliseconds. This
        drives the prefill and decode steps through the bucket
        cross-product with page tables pointing at the reserved scratch
        page 0, so no pool or scheduler state is touched. Caps
        (``max_prompt`` tokens, ``max_tokens`` lifetime tokens per
        sequence, ``max_live`` rows) keep the sweep to the shapes a given
        trace can produce. Returns the number of step shapes not run
        before."""
        assert self.params is not None, "assign params before warmup()"
        ps = self.cache.page_size
        before = len(self.prefill_shapes) + len(self.decode_shapes)
        pb_cap = self.prompt_buckets.fit(max_prompt) if max_prompt else \
            self.prompt_buckets.max_size
        mp_cap = self.pages_buckets.fit(self.cache.pool.pages_for(max_tokens)) \
            if max_tokens else self.pages_buckets.max_size
        b_cap = self.batch_buckets.fit(min(max_live or self.max_live, self.max_live))

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        for pb in self.prompt_buckets.sizes:
            if pb > pb_cap:
                continue
            for b in self.batch_buckets.sizes:  # joiners batch per step
                if b > b_cap:
                    continue
                self.prefill_shapes.add((b, pb))
                self._prefill(self.params, self.cache.k, self.cache.v,
                              zeros(b, pb), zeros(b), zeros(b, pb // ps))
        for b in self.batch_buckets.sizes:
            if b > b_cap:
                continue
            for mp in self.pages_buckets.sizes:
                if mp > mp_cap:
                    continue
                self.decode_shapes.add((b, mp))
                args = (self.params, self.cache.k, self.cache.v, zeros(b, 1), zeros(b),
                        zeros(b, mp))
                if self.decode_quantum > 1:
                    args += (zeros(b),)
                self._decode(*args)
        self.cache.synchronize()
        return len(self.prefill_shapes) + len(self.decode_shapes) - before
