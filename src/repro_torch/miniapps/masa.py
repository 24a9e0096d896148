"""MASA — Mini-App for Streaming Analysis (paper §5).

Pluggable processors for the micro-batch engine:

* ``StreamingKMeans``   — score + decayed centroid update (paper Table 1)
* ``ReconstructionApp`` — GridRec / ML-EM per frame (paper §3.2.2, Fig. 9)
* ``LMTrainApp``        — streaming LM training (micro-batch train step)
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

import inspect
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.service import resolve_device
from repro_torch.kernels import kmeans as kmeans_ops
from repro_torch.kernels import tomo as tomo_ops
from repro_torch.launch.mesh import MeshSpec, RankGroup, RankPool, shared_host_copy
from repro_torch.models import build_model
from repro_torch.models.common import first_argmax
from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
from repro_torch.runtime.steps import TrainRank, build_train_step
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.streaming.dispatch import AsyncWindow, LatencyWindow, ShapeBuckets, pad_rows
from repro_torch.utils.tree import tree_bytes, tree_map_with_paths


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


class LMTrainApp(_HotPathApp):
    """Streaming LM training: consume token messages, run train steps.

    State = ``{"params", "opt"}`` on ``device`` (CUDA unless a CPU device is
    named). Each micro-batch's token rows are cut into steps of
    ``seqs_per_step`` rows (a short tail is padded with zero rows, as the
    JAX app pads it; a batch shorter than one step still takes one step),
    and each step updates the params and moments in place (the JAX app
    donates their buffers). The last step's loss is read back lazily at
    sync boundaries instead of forcing a device round trip per batch. On
    the card every attention forward, its remat recompute and its backward
    run the flash kernels. The JAX app's compile counts have no
    counterpart.

    With ``mesh`` (a :class:`~repro_torch.launch.mesh.MeshSpec`: a shape
    and one device a rank; ``device`` is then the first rank's) the app
    trains on a rank group of its own (``launch/mesh.py`` ``RankGroup``,
    started at first use): each rank keeps its tiles of the state and runs
    the mesh step (``runtime/steps.py`` ``TrainRank``) on every global
    batch, and the state the stream carries is a :class:`GroupState`, a
    handle on the group's state. The ranks are processes of the app's
    ``RankPool``: a rescale's new group takes the old one's processes of
    its devices, each having left the old process group. ``groups`` keeps
    a record of each group the app ran (shape, backend, start seconds,
    processes spawned for it, rank 0's step seconds, each rank's kernel
    launches, read when it stopped), ``rescales`` one of each move between
    placements. ``close()`` stops the group and ends the processes.

    A token stream trains every family whose batch is its tokens: the
    dense and MoE ones, RWKV6 and Zamba2. A VLM or an enc-dec model also
    needs patch or frame embeddings, which a token message does not carry:
    it is refused here (the JAX app fails at its first step) and trained
    through ``build_train_step`` with the embeddings in its batch.
    """

    def __init__(self, cfg, *, mesh: MeshSpec | None = None,
                 opt_cfg: OptimizerConfig | None = None, seqs_per_step: int = 8,
                 seq_len: int = 128, async_depth: int = 2, metrics: Any = None,
                 device: torch.device | str = "cuda"):
        if cfg.family in ("vlm", "encdec"):
            raise ValueError(
                f"{cfg.name}: a {cfg.family!r} model takes "
                f"{'patch' if cfg.family == 'vlm' else 'frame'} embeddings beside its tokens; "
                "LMTrainApp trains on token messages only: train it through "
                "repro_torch.runtime.steps.build_train_step with the embeddings in the batch")
        self.cfg = cfg
        self.model = build_model(cfg)
        self.shape = ShapeConfig("stream", seq_len, seqs_per_step, "train")
        self.opt_cfg = opt_cfg
        #: an app built with a mesh keeps a rank group whatever a rescale's
        #: devices are (so one card can drive it)
        self._keeps_group = mesh is not None
        self.mesh: MeshSpec | None = None
        self.group: RankGroup | None = None
        self._pool: RankPool | None = None
        self.groups: list[dict] = []
        self.rescales: list[dict] = []
        self._place(mesh, device)
        self._init_hotpath(async_depth=async_depth, metrics=metrics, name="lm_train")
        self._losses: list[float] = []

    def _place(self, mesh: MeshSpec | None, device) -> None:
        """Train on one device, or on a rank group over ``mesh`` (started
        at first use): the step function or the group's spec."""
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self.step_fn = build_train_step(self.model, self.shape, self.opt_cfg,
                                            device=self.device)
        else:
            for d in mesh.devices:
                resolve_device(d)
            self.device = mesh.devices[0]
            self.step_fn = None

    def _group(self) -> RankGroup:
        if self.group is None:
            if self._pool is None:
                self._pool = RankPool()
            self.group = RankGroup(self.mesh, TrainRank, (self.cfg, self.shape, self.opt_cfg),
                                   self._pool)
            self.groups.append({"shape": list(self.mesh.shape),
                                "devices": [str(d) for d in self.mesh.devices],
                                "backend": self.mesh.backend,
                                "start_s": self.group.start_seconds,
                                "spawned": self.group.spawned, "step_s": [], "launches": None})
        return self.group

    def _stop_group(self) -> None:
        """Stop the rank group, its ranks' kernel launches read first
        where it is sound."""
        group, self.group = self.group, None
        if group is None:
            return
        try:
            if group.error is None:
                self.groups[-1]["launches"] = group.call("launches")
        finally:
            group.stop()

    def close(self) -> None:
        """Land in-flight steps, stop the rank group, if any, and end the
        rank processes."""
        try:
            self.sync()
        finally:
            self._stop_group()
            if self._pool is not None:
                self._pool.close()
                self._pool = None

    def init_state(self, seed: int = 0):
        """Random params drawn from a ``torch.Generator`` seeded ``seed`` on
        the app's device (a group's: its first rank's), and zero optimizer
        state. As the JAX app does, the state is made for
        ``OptimizerConfig(name=cfg.optimizer)`` when no ``opt_cfg`` was
        given (the step's optimizer also reads the config's moment dtype and
        first-moment flag). A group app hands it to its group and returns
        the :class:`GroupState`."""
        params = self.model.init(torch.Generator(device=self.device).manual_seed(seed))
        opt = Optimizer(self.opt_cfg or OptimizerConfig(name=self.cfg.optimizer))
        state = {"params": params, "opt": opt.init(params)}
        return state if self.mesh is None else self.place_state(state)

    def place_state(self, state: dict):
        """A full train state (tensors on any device, such as
        ``train_state_from_jax``'s or a restored checkpoint's) as this app
        trains it: on its device, or handed to its rank group through
        shared host memory, each rank keeping its tiles; then the group's
        :class:`GroupState`."""
        if self.mesh is None:
            return tree_map_with_paths(lambda _, x: x.to(self.device), state)
        host = tree_map_with_paths(lambda _, x: shared_host_copy(x.detach()), state)
        group = self._group()
        group.call("load", host)
        return GroupState(group, int(host["opt"]["step"]))

    def restore(self, ckpt, step: int | None = None) -> tuple[Any, dict]:
        """(state, meta) of checkpoint ``step`` (the latest by default) of
        ``ckpt`` (a ``CheckpointManager``), placed as :meth:`place_state`
        places a state: on a group each rank reads its own tiles
        (``TrainRank.restore``), so a checkpoint saved from any placement
        restores onto any other."""
        if self.mesh is None:
            return ckpt.restore(self.init_state(), step)
        group = self._group()
        got = group.call("restore", ckpt.directory, step)[0]
        return GroupState(group, got["opt_step"]), got["meta"]

    def process(self, state, msgs):
        if state is None:
            state = self.init_state()
        elif self.mesh is not None and not (isinstance(state, GroupState)
                                            and state.group is self.group):
            state = self.place_state(state)
        toks = np.concatenate([np.asarray(m.value) for m in msgs])  # (n_seqs, S)
        B = self.shape.global_batch
        n_steps = len(toks) // B
        t0 = time.monotonic()
        for s in range(max(n_steps, 1)):
            batch = toks[s * B:(s + 1) * B]
            if len(batch) < B:  # pad the tail window
                width = batch.shape[1] if batch.size else self.shape.seq_len
                batch = np.concatenate([batch, np.zeros((B - len(batch), width), np.int32)])
            batch = batch.astype(np.int32)
            if self.mesh is None:
                params, opt, metrics = self.step_fn(state["params"], state["opt"],
                                                    {"tokens": batch})
                state = {"params": params, "opt": opt}
            else:
                reply = self.group.submit("step", batch)
                state = GroupState(self.group, state.step + 1)
        self.stats.messages += len(msgs)
        self.stats.items += int(len(toks)) * self.shape.seq_len
        self.stats.batches += 1
        if self.mesh is None:
            self._submit(metrics["loss"], t0=t0)
        else:  # the group's record takes rank 0's step seconds
            self._submit(reply, meta=self.groups[-1], t0=t0)
        return state

    def _on_complete(self, result, meta, dt):
        if meta is None:
            self._losses.append(float(result))
            return
        out = result.result()[0]
        self._losses.append(out["loss"])
        meta["step_s"].append(out["s"])

    @property
    def losses(self) -> list[float]:
        """Per-batch final-step losses (syncs in-flight work)."""
        self.sync()
        return self._losses

    def on_rescale(self, devices):
        """Elastic hook, the reference's rule: a ``(len(devices), 1)``
        ("data", "model") rank group over ``devices``, except that one
        device, or a list of one device repeated (the slots of one card),
        gives the one-device app with plain tensors, unless the app was
        built with a mesh: such an app keeps a group whatever the list
        holds (ROADMAP C17). In order: in-flight steps land; the full state
        comes to host memory (gathered from the old group's tiles, or as
        the one device holds it), with no checkpoint file; the old group
        stops; the new placement takes the state (a new group is started
        and handed it). ``rescales`` records each move that involves a
        group: its seconds by part and the host bytes moved."""
        target = _rescale_mesh(devices, keeps_group=self._keeps_group)

        def f(state):
            self.sync()  # in-flight steps must land before buffers move
            t0 = time.perf_counter()
            grouped = self.mesh is not None or target is not None
            before = self.mesh.shape if self.mesh is not None else str(self.device)
            if isinstance(state, GroupState):
                state = state.gather()
            moved = 0 if state is None else tree_bytes(state)
            t1 = time.perf_counter()
            self._stop_group()
            t2 = time.perf_counter()
            self._place(target, devices[0])
            if state is not None:
                state = self.place_state(state)
            if grouped:
                start = self.groups[-1]["start_s"] if self.group is not None else 0.0
                self.rescales.append({
                    "from": before, "to": target.shape if target else str(self.device),
                    "bytes": moved,
                    "seconds": time.perf_counter() - t0, "gather_s": t1 - t0,
                    "stop_s": t2 - t1, "start_s": start,
                    "load_s": time.perf_counter() - t2 - start})
            return state

        return f


def _rescale_mesh(devices, *, keeps_group: bool) -> MeshSpec | None:
    """The placement a rescale onto ``devices`` gives (``LMTrainApp
    .on_rescale``): None for the one-device app, else the group's mesh."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a rescale needs at least one device")
    if not keeps_group and len(set(devices)) == 1:
        return None
    return MeshSpec((len(devices), 1), devices)


class GroupState:
    """The train state a rank group holds, each rank its tiles: what the
    stream carries between batches in place of the tensors, so nothing
    large crosses per batch. ``step`` is the optimizer's step count;
    :meth:`gather` brings the full state into host memory (a checkpoint's
    save or a rescale). Pickled, it keeps its step only."""

    def __init__(self, group: RankGroup | None, step: int):
        self.group, self.step = group, step

    def gather(self) -> dict:
        if self.group is None:
            raise RuntimeError("this GroupState was pickled: its rank group is not here")
        return self.group.call("gather")[0]

    def __getstate__(self):
        return {"group": None, "step": self.step}

    def __repr__(self) -> str:
        shape = None if self.group is None else self.group.spec.shape
        return f"GroupState(group={shape}, step={self.step})"


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

    Lockstep serves every family that takes token prompts: the dense and
    MoE ones, RWKV6 and Zamba2. The prefill's ``cache_len`` grows only the
    self-attention K/V (the JAX app pads axis 2 of every cache leaf, which
    for the RWKV6 and Mamba2 states is not the sequence). Continuous
    batching takes the families with the paged (L, B, S, KV, hd) cache
    (dense and MoE). A VLM or an enc-dec model needs patch or frame
    embeddings beside its prompts, which a token stream does not carry: it
    is refused here (the JAX app fails at its first prefill) and driven
    through the model's ``prefill``/``decode`` instead.
    """

    def __init__(self, cfg, *, prompt_len: int = 32, gen_tokens: int = 8, batch: int = 4,
                 async_depth: int = 2, metrics: Any = None,
                 row_buckets: ShapeBuckets | None = None, mode: str = "lockstep",
                 n_pages: int = 256, page_size: int = 16,
                 device: torch.device | str = "cuda"):
        if mode not in ("lockstep", "continuous"):
            raise ValueError(f"mode must be 'lockstep' or 'continuous', got {mode!r}")
        if cfg.family in ("vlm", "encdec"):
            raise ValueError(
                f"{cfg.name}: a {cfg.family!r} model takes "
                f"{'patch' if cfg.family == 'vlm' else 'frame'} embeddings beside its tokens; "
                "LMServeApp serves token prompts only")
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
    """A ``ReconstructionApp`` factory for one algorithm, with the app's
    keywords as its signature (the pipeline runner places the app by its
    ``device``; ``Pipeline.validate`` checks stage options against it)."""
    def factory(**kw) -> ReconstructionApp:
        return ReconstructionApp(algorithm, **kw)
    sig = inspect.signature(ReconstructionApp.__init__)
    factory.__signature__ = sig.replace(parameters=[
        p for n, p in sig.parameters.items() if n not in ("self", "algorithm")])
    return factory


PROCESSORS = {
    "kmeans": StreamingKMeans,
    "gridrec": _reconstruction("gridrec"),
    "mlem": _reconstruction("mlem"),
    "lm_train": LMTrainApp,
    "lm_serve": LMServeApp,
}
