"""MASA — Mini-App for Streaming Analysis (paper §5).

Pluggable processors for the micro-batch engine:

* ``StreamingKMeans``   — score + decayed centroid update (paper Table 1)
* ``ReconstructionApp`` — GridRec / ML-EM per frame (paper §3.2.2, Fig. 9)
* ``LMServeApp``        — streaming LM inference (prefill/decode)

Each exposes ``process(state, msgs) -> state`` for
``MicroBatchPlugin.stream``. Each works on the device it is given
(``device="cuda"`` by default; a CPU run asks for ``device="cpu"``), copies
every message's payload there, and dispatches the micro-batch as one
stacked call. Results are double-buffered (``streaming.dispatch.
AsyncWindow``) so batch N+1 dispatches while N executes, syncing only at
stats/checkpoint/rescale boundaries. On CUDA tensors the hot loops run the
port's hand-written kernels (``repro_torch.kernels``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core.service import resolve_device
from repro_torch.kernels import kmeans as kmeans_ops
from repro_torch.kernels import tomo as tomo_ops
from repro_torch.models import build_model
from repro_torch.models.common import first_argmax
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.streaming.dispatch import AsyncWindow, LatencyWindow, ShapeBuckets, pad_rows


@dataclass
class AppStats:
    messages: int = 0
    items: int = 0
    batches: int = 0
    compute_time: float = 0.0
    latency: LatencyWindow = field(default_factory=LatencyWindow)

    @property
    def msgs_per_sec(self) -> float:
        return self.messages / self.compute_time if self.compute_time else 0.0


class _HotPathApp:
    """Shared double-buffering plumbing for the MASA processors.

    Subclasses dispatch work with :meth:`_submit` and override
    :meth:`_on_complete` to fold a finished batch's outputs into their
    exposed attributes. ``sync()`` is the barrier the engine calls at
    checkpoint/rescale boundaries; stats accessors that need completed
    results call it implicitly.
    """

    def _init_hotpath(self, *, async_depth: int = 2, metrics: Any = None,
                      name: str | None = None) -> None:
        self.stats = AppStats()
        self.metrics = metrics
        self._metrics_name = name or type(self).__name__
        self._window = AsyncWindow(async_depth, self.stats.latency)

    def _submit(self, result: Any, meta: Any = None, t0: float | None = None) -> None:
        """Enqueue a dispatched batch; ``t0`` = start of the batch's host
        work, so drained latencies span prep+compute. ``compute_time`` sums
        those per-batch completion latencies."""
        for res, m, dt in self._window.push(result, meta, t0=t0):
            self.stats.compute_time += dt
            self._on_complete(res, m, dt)
            self._publish_latency()

    def sync(self) -> None:
        """Block until every in-flight batch has completed (the
        stats/checkpoint/rescale barrier)."""
        done = self._window.sync()
        if not done:
            return
        for res, m, dt in done:
            self.stats.compute_time += dt
            self._on_complete(res, m, dt)
        self._publish_latency()

    def _on_complete(self, result: Any, meta: Any, dt: float) -> None:
        pass

    def _publish_latency(self) -> None:
        if self.metrics is None or len(self.stats.latency) == 0:
            return
        lat, labels = self.stats.latency, {"app": self._metrics_name}
        self.metrics.publish("app.latency_p50", lat.p50, **labels)
        self.metrics.publish("app.latency_p99", lat.p99, **labels)

    @property
    def in_flight(self) -> int:
        return self._window.in_flight


class StreamingKMeans(_HotPathApp):
    """Assign incoming points to centroids, update the model with decay.

    The initial centroids are ``n_clusters`` standard normals drawn with
    numpy from ``seed`` (the JAX package draws the same numbers), placed on
    ``device``. Each micro-batch's points go to the device at their own
    size: no padding, since PyTorch does not recompile per batch size.
    """

    def __init__(self, n_clusters: int = 10, dim: int = 3, *, decay: float = 0.9,
                 seed: int = 0, async_depth: int = 2, metrics: Any = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.centroids = torch.as_tensor(
            rng.normal(size=(n_clusters, dim)), dtype=torch.float32).to(self.device)
        self.decay = decay
        self._init_hotpath(async_depth=async_depth, metrics=metrics, name="kmeans")
        self._inertia = float("nan")

    def process(self, state, msgs):
        centroids = state if state is not None else self.centroids
        pts = np.concatenate([np.asarray(m.value) for m in msgs]).astype(np.float32)
        n = pts.shape[0]
        t0 = time.monotonic()
        points = torch.from_numpy(pts).to(self.device)
        centroids, labels, inertia = kmeans_ops.minibatch_update(
            points, centroids, decay=self.decay)
        self.stats.messages += len(msgs)
        self.stats.items += n
        self.stats.batches += 1
        self._submit(centroids, meta=(inertia, n), t0=t0)
        return centroids

    def _on_complete(self, result, meta, dt):
        inertia, n = meta
        self._inertia = float(inertia) / max(n, 1)

    @property
    def inertia(self) -> float:
        """Mean inertia of the most recent batch (syncs in-flight work)."""
        self.sync()
        return self._inertia

    def on_rescale(self, devices):
        """Elastic hook: the centroids (tiny) move to ``devices[0]``, and
        later batches are placed there too."""
        def f(state):
            self.device = torch.device(devices[0])
            return state.to(self.device) if state is not None else state
        return f


class ReconstructionApp(_HotPathApp):
    """Per-frame tomographic reconstruction (GridRec or ML-EM).

    A micro-batch's frames are grouped by sinogram shape; each group is
    stacked (at its own depth, no padding) and reconstructed in one batched
    call. Angles are cached per sinogram shape. The returned state is the
    LAST message's reconstruction.
    """

    def __init__(self, algorithm: str = "gridrec", *, n: int = 64, mlem_iters: int = 4,
                 async_depth: int = 2, metrics: Any = None,
                 device: torch.device | str = "cuda"):
        if algorithm not in ("gridrec", "mlem"):
            raise ValueError(f"algorithm must be 'gridrec' or 'mlem', got {algorithm!r}")
        self.device = resolve_device(device)
        self.algorithm = algorithm
        self.n = n
        self.mlem_iters = mlem_iters
        self._init_hotpath(async_depth=async_depth, metrics=metrics, name=algorithm)
        self._angles_cache: dict[int, torch.Tensor] = {}

    def _angles(self, n_angles: int) -> torch.Tensor:
        """Per-shape cache: the same angle grid is re-used for every frame of
        that sinogram shape instead of re-materializing per message."""
        a = self._angles_cache.get(n_angles)
        if a is None:
            a = self._angles_cache[n_angles] = torch.from_numpy(
                tomo_ops.angle_grid(n_angles)).to(self.device)
        return a

    def _reconstruct(self, sinos: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
        if self.algorithm == "gridrec":
            return tomo_ops.gridrec_batch(sinos, angles, self.n)
        return tomo_ops.mlem_batch(sinos, angles, self.n, iters=self.mlem_iters)

    def process(self, state, msgs):
        t0 = time.monotonic()
        groups: dict[tuple, list[np.ndarray]] = {}
        for m in msgs:
            sino = np.asarray(m.value, np.float32)
            groups.setdefault(sino.shape, []).append(sino)
        last_shape = np.asarray(msgs[-1].value).shape
        recon = None
        for shape, frames in groups.items():
            stack = torch.from_numpy(np.stack(frames)).to(self.device)
            rec = self._reconstruct(stack, self._angles(shape[0]))[len(frames) - 1]
            # state contract: the LAST message's reconstruction (its frame is
            # the last element of its shape group)
            if shape == last_shape:
                recon = rec
        self.stats.messages += len(msgs)
        self.stats.items += len(msgs)
        self.stats.batches += 1
        self._submit(recon, t0=t0)
        return recon  # last reconstruction = state (exposed for inspection)


class LMServeApp(_HotPathApp):
    """Streaming LM inference: prefill each request batch, decode n tokens.

    ``mode="lockstep"`` (default): the whole micro-batch's requests are
    stacked into one prefill (rows padded to a bucket) whose cache is
    allocated at ``prompt_len + gen_tokens`` positions, and the decode loop
    writes into it in place — every row enters and exits together.

    ``mode="continuous"``: requests go through the in-flight batching
    scheduler (``repro_torch.serving.ContinuousBatcher``) — prompts prefill
    into paged KV-cache slots and join the live decode batch mid-stream,
    finished rows exit per step and free their pages immediately. Same
    greedy tokens.

    The state the stream carries is the model's params (as stored, f32 at
    full width); the matmul weights are cast to the compute dtype once per
    params object. On ``device`` (CUDA unless a CPU device is named) the
    prefill runs the flash kernel and every decode step the decode kernel.
    The JAX app's compile counts have no counterpart.
    """

    def __init__(self, cfg, *, prompt_len: int = 32, gen_tokens: int = 8, batch: int = 4,
                 async_depth: int = 2, metrics: Any = None,
                 row_buckets: ShapeBuckets | None = None, mode: str = "lockstep",
                 n_pages: int = 256, page_size: int = 16,
                 device: torch.device | str = "cuda"):
        if mode not in ("lockstep", "continuous"):
            raise ValueError(f"mode must be 'lockstep' or 'continuous', got {mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.prompt_len = prompt_len
        self.gen_tokens = gen_tokens
        self.batch = batch
        self.mode = mode
        self.row_buckets = row_buckets or ShapeBuckets(min_size=batch, max_size=batch * 8)
        self._init_hotpath(async_depth=async_depth, metrics=metrics, name="lm_serve")
        self._params_src: Any = None
        self._params: Any = None
        self._batcher = None
        if mode == "continuous":
            self._batcher = ContinuousBatcher(
                self.model, n_pages=n_pages, page_size=page_size,
                max_queue=max(64, batch * 16), metrics=metrics, device=self.device)
            self._rid = 0
            self._now = 0.0

    def _compute_params(self, params):
        if params is not self._params_src:
            self._params_src = params
            self._params = self.model.compute_params(params)
        return self._params

    def _stack_requests(self, msgs) -> np.ndarray:
        """(sum_i b_i, prompt_len) int32: every message's requests in one
        batch, right-padded to prompt_len columns."""
        rows = []
        for m in msgs:
            t = np.asarray(m.value)[: self.batch, : self.prompt_len].astype(np.int32)
            if t.shape[1] < self.prompt_len:
                t = np.pad(t, [(0, 0), (0, self.prompt_len - t.shape[1])])
            rows.append(t)
        return np.concatenate(rows)

    def _serve_batch(self, params, msgs):
        """One stacked prefill + the decode loop for a whole micro-batch.
        Returns (seq (gen_tokens, B, 1) greedy tokens, n_req live rows)."""
        toks = self._stack_requests(msgs)
        n_req = toks.shape[0]
        tok_in = torch.from_numpy(pad_rows(toks, self.row_buckets.fit(n_req))).to(self.device)
        p = self._compute_params(params)
        logits, cache = self.model.prefill(p, {"tokens": tok_in},
                                           cache_len=self.prompt_len + self.gen_tokens)
        tok = first_argmax(logits[:, -1:], dim=-1).to(torch.int32)  # (B, 1)
        pos = torch.full((tok_in.shape[0],), self.prompt_len - 1, dtype=torch.int32,
                         device=self.device)
        seq = [tok]
        for _ in range(self.gen_tokens - 1):
            pos = pos + 1
            logits, cache = self.model.decode(p, cache, {"tokens": tok, "positions": pos})
            tok = first_argmax(logits, dim=-1).to(torch.int32)
            seq.append(tok)
        return torch.stack(seq), n_req

    def _serve_continuous(self, params, msgs) -> np.ndarray:
        """Route a micro-batch through the in-flight scheduler; returns
        (n_req, gen_tokens) greedy tokens in request order."""
        b = self._batcher
        b.params = params
        toks = self._stack_requests(msgs)
        rids = []
        for row in toks:
            r = Request(self._rid, self._now, tuple(int(t) for t in row), self.gen_tokens)
            self._rid += 1
            verdict = b.submit(r, self._now)
            if verdict == "reject":
                raise RuntimeError(f"request {r.rid} rejected: drop-in mode must not shed requests")
            rids.append(r.rid)
            self._now += b.step(self._now)
        self._now = b.drain(self._now)
        return np.array([b.results[r]["tokens"] for r in rids], np.int32)

    def process(self, state, msgs):
        params = state  # serving state = model params
        t0 = time.monotonic()
        if self.mode == "continuous":
            out = self._serve_continuous(params, msgs)
            n_req = out.shape[0]
        else:
            out, n_req = self._serve_batch(params, msgs)
        self.stats.messages += len(msgs)
        self.stats.items += n_req * self.gen_tokens
        self.stats.batches += 1
        self._submit(out, t0=t0)
        return params

    def generate_tokens(self, params, msgs) -> np.ndarray:
        """Greedy tokens for a message batch: (n_req, gen_tokens) int32.
        Convenience/inspection path; ``process`` is the streaming hot path."""
        if self.mode == "continuous":
            return self._serve_continuous(params, msgs)
        seq, n_req = self._serve_batch(params, msgs)
        return seq[:, :n_req, 0].T.cpu().numpy()


def _reconstruction(algorithm: str):
    """A ``ReconstructionApp`` factory for one algorithm; it names its
    ``device`` keyword, so the pipeline runner can place the app."""
    def factory(*, device: torch.device | str = "cuda", **kw) -> ReconstructionApp:
        return ReconstructionApp(algorithm, device=device, **kw)
    return factory


PROCESSORS = {
    "kmeans": StreamingKMeans,
    "gridrec": _reconstruction("gridrec"),
    "mlem": _reconstruction("mlem"),
    "lm_serve": LMServeApp,
}
