#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints the build seconds;
3. prints the host's CPU and launch rate (so runs on different hosts can
   be told apart), then holds every kernel against its plain PyTorch
   version at the main path's shapes, on the same inputs, with the
   tolerance printed (for the attention kernels per element, and shown to
   fail a mask off by one; ``kmeans_assign`` in each regime its plan
   chooses, narrow 80 000 x 3 x 10 and wide 65 536 x 128 x 1024, f32 and
   bf16, and the chunked regime at 4096 x 20 000 x 2 and 15, with the
   regime and the least kernel's time printed; ``kmeans_update`` at the
   wide stream's shape, masked and with every row on one label, against a
   float64 sum and bitwise across repeats; decode
   also, untimed, at the edges of the
   chunks it splits the cache into and bitwise across repeated calls and
   CUDA-graph replays, while its timed inputs have fixed positions and a
   generator of their own; for ``tomo_project`` also on sparse images and for
   ``tomo_backproject`` on sparse sinograms, where a dropped pixel or bin
   shows; flash attention also at B=1 S=2048, where the work is
   operations), and times kernel, plain version and (where one
   exists) a single PyTorch library call that computes the same function:
   by device time, replaying a CUDA graph of many calls, where a call is
   short (K-Means, attention at B = 1, 4 and 64; the host's per-call time
   is printed beside it as ``call_ms``, and beside decode's bound the
   device time of the least kernel, ``launch_floor_ms``), by CUDA events
   around calls for the projectors;
4. drives the main paths through the port's entry points: a
   ``PilotComputeService`` on the card with a ``kafka`` pilot (2 broker
   nodes) and a ``spark`` pilot, then (a) a K-Means cluster stream of
   5000 x 3 points per message into ``StreamingKMeans(10, 3)`` and a wide
   one, 4096 x 128 points per message, 16 messages per batch, into
   ``StreamingKMeans(1024, 128)``, (b) a
   light-source stream of 360 x 1448 sinograms reconstructed at n = 1448 by
   GridRec and by ML-EM, and (c) the LM serving stream: 16 messages of 4
   prompts of 128 tokens into ``LMServeApp`` on ``smollm-135m`` at full
   width (random weights from the seed), continuous batching over paged
   KV, 32 greedy tokens per request; every kernel's launch count is set to
   0 just before a path and read just after it;
5. re-scores every served sequence with the model's prefill and holds each
   generated token against that forward's argmax;
6. runs the pipeline phase: a ``PipelineSpec`` built by the port's ``Pipeline``
   (one kafka node; light-source frames at a stepped rate into an elastic
   ML-EM stage, the cluster stream into a K-Means stage) through
   ``spec.run(devices=4)``, four device slots of the card, until both
   streams have drained and the ML-EM stage has scaled up and back down;
   checks every message processed, the arbiter within the pool, every
   kernel of the stages launched, the apps on the card, K-Means inertia
   falling, the last reconstruction against the plain version, reverse-order
   teardown, and the CLI (``python -m repro_torch.pipeline validate``, in a
   fresh interpreter) accepting the spec and refusing a continuous stage
   with its ROADMAP A2 message; prints one ``path pipeline`` line;
7. prints one JSON line ``{"kernels": [...]}`` and, last, one JSON line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without printing the
last line. It refuses to run without CUDA or without the port's sources
beside it.
"""
from __future__ import annotations

import json
import math
import os
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, f32 rate outside
# the tensor cores, and the TF32 and bf16 tensor-core rates (dense). A
# kernel's operations are held against the peak for its inputs' type: f32
# for K-Means and the projectors, bf16 for the attention kernels at the
# serving path's width and the bf16 K-Means checks; the wide f32 K-Means
# check also against the TF32 rate for the 3 products its design issues
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 494.5e12
BF16_OPS_PER_S = 989e12
F32_EPS = 2.0 ** -23
BF16_STEP = 2.0 ** -7  # one bf16 step, relative (8 significant bits)
# the f32 sums of an attention kernel and its plain version, in two orders:
# the card tests hold them to 1e-5 on unit-scale f32 inputs; twice 2^-16 of
# the largest |v| covers that
ATTN_SUM_REL = 2.0 ** -15
# rows with at least this many live keys are where a mask off by one moves
# the output least; the checks show that it still fails them there
LONG_ROW = 64

# the light-source stream: one 360 x 1448 f32 sinogram per message,
# reconstructed at one pixel per detector bin; ML-EM at the app's default
FRAME_ANGLES, FRAME_BINS, RECON_N, MLEM_ITERS = 360, 1448, 1448, 4

# the wide K-Means stream: 1024 centres in 128 dimensions, 4096 points per
# message (f64, 4 MB), 16 messages per batch (N = 65 536, the wide check's
# shape), WIDE_BATCHES batches
WIDE_K, WIDE_D, WIDE_POINTS_PER_MSG, WIDE_MSGS_PER_BATCH, WIDE_BATCHES = 1024, 128, 4096, 16, 4

# the pipeline phase (a PipelineSpec built by the port's Pipeline and run
# by its runner): one kafka node; an elastic ML-EM stage on the light-source frames,
# whose source steps its rate (seconds, msgs/s) to about twice what the
# stage sustains and back to a sixth of it, and ends with the schedule (or
# as much later as its producer fell behind in the burst: near 225 of 250
# msgs/s of these 2.1 MB frames, while the stages run); a K-Means stage on the
# cluster stream; PIPE_SLOTS device slots of the one card. The ML-EM stage
# takes batches of 8 frames with the engine's rate control off, as the
# reference's elastic pipelines run: about 123 frames/s on the H100
# (tools/pipeline_capacity.py, PERF.md §4)
PIPE_SLOTS = 4
PIPE_RECON_BATCH, PIPE_RECON_RATE_CONTROL = 8, False
PIPE_FRAME_SCHEDULE = ((2.0, 10), (2.5, 250), (4.0, 20))
PIPE_FRAMES = int(sum(t * r for t, r in PIPE_FRAME_SCHEDULE))  # 725
PIPE_POINTS_RATE, PIPE_POINTS = 200, 2000
PIPE_TIMEOUT_S = 45  # the phase fails if it is not done by then (it takes 10-14 s)

# the serving stream: messages of SERVE_BATCH prompts, one message per
# micro-batch, as launch/serve.py runs it; smollm-135m's attention is
# 9 query heads over 3 KV heads of 64
SERVE_MSGS, SERVE_BATCH, PROMPT_LEN, GEN_TOKENS, PAGE_SIZE = 16, 4, 128, 32, 16
HEADS, KV_HEADS, HEAD_DIM = 9, 3, 64
# a served token must be the re-scoring forward's argmax wherever the top-2
# logit gap exceeds this: the decode path (decode kernel, cache written one
# token at a time) and the prefill path (flash kernel) round their bf16
# residual streams at different places over 30 layers
RESCORE_GAP = 0.05


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time on the card for the work (ms) and what sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls from the host
    (CUDA events, after ``warmup`` calls). For a call of well under a
    millisecond this is the host's rate of issuing it, not device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. The host issues
    one graph per replay, so a short call is timed by the card (its kernels
    plus the graph's gaps between them), not by the host's launch rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def host_probe(torch) -> dict:
    """What the host gives this run: its CPU model and cores, and the wall
    time per call of 2000 in-place adds to one CUDA float (the host's launch
    rate, with no device work to speak of). Runs on different hosts are
    told apart by these numbers."""
    model = platform.machine()  # x86 names its model; Arm cores give a part number
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():
        for line in cpuinfo.read_text().splitlines():
            if line.startswith(("model name", "CPU part")):
                model += " " + line.split(":", 1)[1].strip()
                break
    x = torch.zeros(1, device="cuda")
    for _ in range(200):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    torch.cuda.synchronize()
    launch_us = (time.perf_counter() - t0) / 2000 * 1e6
    t0 = time.perf_counter()
    sum(range(1_000_000))
    python_ms = (time.perf_counter() - t0) * 1e3
    return {"cpu": model, "cpus": os.cpu_count(), "launch_us": launch_us,
            "python_sum_1e6_ms": python_ms}


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def assign_inputs(torch, n: int, d: int, k: int, dtype, clustered: bool, gen):
    """Points (n, d) and centroids (k, d) on the card: standard normals, or
    the cluster source's data (centres in [-10, 10]^d, spread 0.5) with
    standard-normal centroids."""
    dev = torch.device("cuda", 0)
    if clustered:
        centers = torch.rand((k, d), generator=gen, device=dev) * 20 - 10
        idx = torch.randint(0, k, (n,), generator=gen, device=dev)
        points = centers[idx] + 0.5 * torch.randn((n, d), generator=gen, device=dev)
    else:
        points = torch.randn((n, d), generator=gen, device=dev)
    centroids = torch.randn((k, d), generator=gen, device=dev)
    return points.to(dtype).contiguous(), centroids.to(dtype).contiguous()


def assign_close(torch, kmeans, name: str, points, centroids, labels, dist) -> dict:
    """Hold (labels, dist) of ``points`` x ``centroids`` against the plain
    version; raises where they differ by more than f32 rounding allows."""
    n, d = points.shape
    k = centroids.shape[0]
    ref_labels, ref_dist = kmeans.assign_ref(points, centroids)
    torch.cuda.synchronize()
    # rounding of |p|^2 - 2 p.c + |c|^2 in f32, summed over D terms in two
    # orders: 8 (D + 2) eps_f32 (|p| + max|c|)^2 per point
    p, c = points.float(), centroids.float()
    scale = (p.norm(dim=1) + c.norm(dim=1).max()) ** 2
    tol = 8 * (d + 2) * 2.0 ** -24 * scale
    err = (dist - ref_dist).abs()
    if not bool(torch.isfinite(dist).all()) or bool((err > tol).any()):
        raise AssertionError(f"{name} {n}x{d}x{k} {points.dtype}: max err "
                             f"{float(err.max())}, worst err/tol {float((err / tol).max())}")
    # labels must agree wherever the best and second-best d^2 differ by
    # more than twice the tolerance
    d2 = (p * p).sum(1, keepdim=True) - 2 * p @ c.T + (c * c).sum(1)
    two = d2.topk(2, dim=1, largest=False).values if k > 1 else None
    clear = (two[:, 1] - two[:, 0] > 2 * tol) if two is not None else torch.ones_like(tol, dtype=torch.bool)
    bad = int(((labels != ref_labels) & clear).sum())
    if bad:
        raise AssertionError(f"{name} {n}x{d}x{k}: {bad} labels differ where the gap is clear")
    return {"max_abs_err": float(err.max()), "tol": "8 (D+2) 2^-24 (|p| + max|c|)^2 per point",
            "worst_err_over_tol": float((err / tol).max()),
            "labels_differing_in_near_ties": int((labels != ref_labels).sum())}


def check_assign(torch, kmeans, n: int, d: int, k: int, dtype, clustered: bool,
                 gen, timing: bool, floor_ms: float) -> dict:
    """``kmeans_assign`` in the regime ``assign_plan`` chooses for the shape,
    held to :func:`assign_close`; timed, with its bound (wide f32: also the
    bound of the 3 TF32 products its design issues) and ``floor_ms``, the
    least kernel's device time, beside it."""
    points, centroids = assign_inputs(torch, n, d, k, dtype, clustered, gen)
    labels, dist = kmeans.assign_cuda(points, centroids)
    plan = kmeans.assign_plan(d, k, dtype)
    out = {"regime": plan.regime, "launch_floor_ms": floor_ms,
           **assign_close(torch, kmeans, "kmeans_assign", points, centroids, labels, dist)}
    if timing:
        elem = points.element_size()
        n_bytes = n * d * elem + k * d * elem + n * 8
        n_ops = 2 * n * k * d + 3 * n * k + 2 * n * d
        out["bound_ms"], out["bound_by"] = bound(
            n_bytes, n_ops, BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S)
        if plan.regime == "wide" and dtype == torch.float32:
            out["tf32x3_bound_ms"], out["tf32x3_bound_by"] = bound(
                n_bytes, 3 * 2 * n * k * d, TF32_OPS_PER_S)
        out["ms"] = graph_ms(torch, lambda: kmeans.assign_cuda(points, centroids), 50)
        out["plain_ms"] = graph_ms(torch, lambda: kmeans.assign_ref(points, centroids), 20)
        out["library_ms"] = graph_ms(torch, lambda: torch.cdist(points, centroids).min(1), 20)
        out["call_ms"] = time_ms(torch, lambda: kmeans.assign_cuda(points, centroids), 50, 5)
    return out


def update_close(torch, kmeans, name: str, points, labels, k: int, mask=None) -> dict:
    """``kmeans_update`` against a float64 sum of the same (weighted) rows:
    every entry within 2^-20 of the sum of |x| over its rows, the counts
    exact, and bitwise the same over repeated calls and graph replays."""
    n, d = points.shape
    sums, counts = kmeans.update_cuda(points, labels, k, mask)
    w = (torch.ones(n, dtype=torch.float64, device=points.device) if mask is None
         else mask.double())
    idx = torch.where(w > 0, labels.long(), 0)
    x = points.double() * w[:, None]
    ref = torch.zeros((k, d), dtype=torch.float64, device=points.device).index_add_(0, idx, x)
    mag = torch.zeros_like(ref).index_add_(0, idx, x.abs())
    ref_counts = torch.zeros(k, dtype=torch.float64, device=points.device).index_add_(0, idx, w)
    torch.cuda.synchronize()
    err = (sums.double() - ref).abs()
    tol = 2.0 ** -20 * mag
    if not bool(torch.isfinite(sums).all()) or bool((err > tol).any()):
        raise AssertionError(f"{name}: max err {float(err.max())}, worst err/tol "
                             f"{float((err / tol.clamp_min(1e-300)).max())}")
    if not torch.equal(counts.double(), ref_counts):
        raise AssertionError(f"{name}: counts differ from the rows' count")

    def joined():
        s, c = kmeans.update_cuda(points, labels, k, mask)
        return torch.cat([s.flatten(), c])

    _bitwise_repeatable(torch, name, joined, torch.cat([sums.flatten(), counts]))
    return {"max_abs_err": float(err.max()), "tol_rule": "per entry 2^-20 sum|x| (float64 sum)",
            "worst_err_over_tol": float((err / tol.clamp_min(1e-300)).max()),
            "counts_exact": True, "bitwise_repeatable": True}


def check_update(torch, kmeans, n: int, d: int, k: int, gen, worst_cases: bool) -> dict:
    """``kmeans_update`` on N x D points with labels from ``kmeans_assign``
    on clustered points (the cluster source's data), held to
    :func:`update_close` and timed, with its bound, the plain version
    (``index_add_`` twice) and one ``index_add_`` of the sums; with
    ``worst_cases`` also masked (70 % of the rows weigh 1) and with every
    row on one label (timed)."""
    points, centroids = assign_inputs(torch, n, d, k, torch.float32, True, gen)
    labels, _ = kmeans.assign_cuda(points, centroids)
    out = update_close(torch, kmeans, "kmeans_update", points, labels, k)
    out["labels_used"] = int((torch.bincount(labels.long(), minlength=k) > 0).sum())
    out["bound_ms"], out["bound_by"] = bound(n * d * 4 + n * 4 + k * d * 4 + k * 4, n * d)
    out["ms"] = graph_ms(torch, lambda: kmeans.update_cuda(points, labels, k), 20)
    out["plain_ms"] = graph_ms(torch, lambda: kmeans.update_scatter_ref(points, labels, k), 20)
    idx = labels.long()
    zeros = torch.zeros((k, d), device=points.device)
    out["library_ms"] = graph_ms(torch, lambda: zeros.index_add_(0, idx, points), 20)
    out["call_ms"] = time_ms(torch, lambda: kmeans.update_cuda(points, labels, k), 50, 5)
    if worst_cases:
        mask = torch.rand(n, generator=gen, device=points.device) < 0.7
        out["masked"] = update_close(torch, kmeans, "kmeans_update masked", points, labels, k,
                                     mask)
        one = torch.full_like(labels, k // 2)
        out["one_label"] = update_close(torch, kmeans, "kmeans_update one label", points, one, k)
        out["one_label_ms"] = graph_ms(torch, lambda: kmeans.update_cuda(points, one, k), 20)
    return out


def check_tomo(torch, tomo, gen) -> tuple[dict, dict]:
    """Both projectors at the light-source path's shapes: 8 frames,
    360 angles, 1448 bins, n = 1448."""
    dev = torch.device("cuda", 0)
    b, a, n_det, n = 8, FRAME_ANGLES, FRAME_BINS, RECON_N
    angles = torch.from_numpy(tomo.angle_grid(a)).to(dev)
    cos_t, sin_t = tomo.trig(angles)
    sinos = torch.rand((b, a, n_det), generator=gen, device=dev)
    imgs = torch.rand((b, n, n), generator=gen, device=dev)

    bp = tomo.backproject_cuda(sinos, cos_t, sin_t, n)
    bp_ref = tomo.backproject_plain(sinos, cos_t, sin_t, n)
    fp = tomo.project_cuda(imgs, cos_t, sin_t, n_det)
    fp_ref = tomo.project_plain(imgs, cos_t, sin_t, n_det)
    torch.cuda.synchronize()
    results = []
    # inputs are non-negative, so max|ref| bounds the sum of |terms|; a sum
    # of m f32 terms in two orders differs by at most ~m eps_f32 of it
    for name, out, ref, terms in (("tomo_backproject", bp, bp_ref, a),
                                  ("tomo_project", fp, fp_ref, 4 * n)):
        err = float((out - ref).abs().max())
        tol = terms * F32_EPS * float(ref.abs().max())
        if not bool(torch.isfinite(out).all()) or err > tol:
            raise AssertionError(f"{name}: max err {err} > tol {tol}")
        results.append({"max_abs_err": err, "tol": tol,
                        "tol_rule": f"{terms} eps_f32 max|ref| (sum of {terms} terms)"})

    # adjointness on the card: <P x, y> = <x, B y>
    lhs = float((fp.double() * sinos.double()).sum())
    rhs = float((imgs.double() * bp.double()).sum())
    rel = abs(lhs - rhs) / abs(lhs)
    if rel > 1e-4:
        raise AssertionError(f"projectors not adjoint: <Px,y>={lhs} <x,By>={rhs} rel {rel}")
    results[0]["adjoint_rel_err"] = results[1]["adjoint_rel_err"] = rel

    # one interpolation per (frame, pixel, angle): 4 f32 operations, and 6
    # per (pixel, angle) for s, floor(s) and the two weights
    n_ops = b * n * n * a * 4 + n * n * a * 6
    trig_bytes = 2 * a * 4
    bp_bytes = b * a * n_det * 4 + trig_bytes + b * n * n * 4
    fp_bytes = b * n * n * 4 + trig_bytes + b * a * n_det * 4
    for res, bytes_, kern, plain, x in (
            (results[0], bp_bytes, tomo.backproject_cuda, tomo.backproject_plain, sinos),
            (results[1], fp_bytes, tomo.project_cuda, tomo.project_plain, imgs)):
        size = n if kern is tomo.backproject_cuda else n_det
        res["bound_ms"], res["bound_by"] = bound(bytes_, n_ops)
        res["ms"] = time_ms(torch, lambda: kern(x, cos_t, sin_t, size), 5, 1)
        res["plain_ms"] = time_ms(torch, lambda: plain(x, cos_t, sin_t, size), 2, 1)
        res["library_ms"] = None  # no single PyTorch call computes a projector
    return results[0], results[1]


def check_project_sparse(torch, tomo, gen) -> dict:
    """``tomo_project`` at the path's shapes on images that are zero but
    for unit pixels: 64 seeded ones per frame, the four corners, the centre,
    and pixels beside both diagonals and beside the image edges, which at
    the angles around 45 and 135 degrees (where the walk switches between
    rows and columns) lie at the ends of a line's candidate window. Each
    bin then sums a few terms, so a window that drops a pixel shows as an
    error of that pixel's weight: the tolerance, (lit pixels) eps_f32
    max|ref| per element, is what two orders of such a sum allow."""
    dev = torch.device("cuda", 0)
    b, a, n_det, n = 8, FRAME_ANGLES, FRAME_BINS, RECON_N
    cos_t, sin_t = tomo.trig(torch.from_numpy(tomo.angle_grid(a)).to(dev))
    imgs = torch.zeros((b, n, n), device=dev)
    i = torch.arange(1, n - 1, 97, device=dev)
    one, inner = torch.ones_like(i), torch.full_like(i, n - 2)
    # corners, centre; beside the diagonal, the anti-diagonal and the edges
    rows = [torch.tensor([0, 0, n - 1, n - 1, n // 2], device=dev), i, i, i, i, i, i, one, inner]
    cols = [torch.tensor([0, n - 1, 0, n - 1, n // 2], device=dev),
            i - 1, i + 1, n - 2 - i, n - i, one, inner, i, i]
    imgs[:, torch.cat(rows), torch.cat(cols)] = 1.0
    for f in range(b):
        lit = torch.randint(0, n * n, (64,), generator=gen, device=dev)
        imgs[f].view(-1)[lit] = 1.0
    lit = int((imgs > 0).flatten(1).sum(1).max())
    out = tomo.project_cuda(imgs, cos_t, sin_t, n_det)
    ref = tomo.project_plain(imgs, cos_t, sin_t, n_det)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    tol = lit * F32_EPS * float(ref.abs().max())
    if not bool(torch.isfinite(out).all()) or float(err.max()) > tol:
        raise AssertionError(f"tomo_project sparse images: max err {float(err.max())} > tol {tol}")
    return {"lit_pixels_per_frame": lit, "max_abs_err": float(err.max()), "tol": tol,
            "tol_rule": "lit eps_f32 max|ref| per element",
            "nonzero_bins": int((ref != 0).sum())}


def check_backproject_sparse(torch, tomo, gen) -> dict:
    """``tomo_backproject`` at the path's shapes on sinograms that are zero
    but for unit bins: 0, 1, the centre, n_det - 2, n_det - 1 and 8 seeded
    bins per row. A pixel then sums a few non-zero terms of non-negative
    weight, so the tolerance is per element, 2 A eps_f32 |ref| (a sum of up
    to 2 A such terms in two orders), and zero where the plain version is
    zero: a bin dropped from a tile's window, or staged at the wrong offset
    or frame, shows as an error of its weight."""
    dev = torch.device("cuda", 0)
    b, a, n_det, n = 8, FRAME_ANGLES, FRAME_BINS, RECON_N
    cos_t, sin_t = tomo.trig(torch.from_numpy(tomo.angle_grid(a)).to(dev))
    sinos = torch.zeros((b, a, n_det), device=dev)
    sinos[..., [0, 1, n_det // 2, n_det - 2, n_det - 1]] = 1.0
    sinos.scatter_(2, torch.randint(0, n_det, (b, a, 8), generator=gen, device=dev), 1.0)
    out = tomo.backproject_cuda(sinos, cos_t, sin_t, n)
    ref = tomo.backproject_plain(sinos, cos_t, sin_t, n)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    tol = 2 * a * F32_EPS * ref.abs()
    if not bool(torch.isfinite(out).all()) or bool((err > tol).any()):
        raise AssertionError(f"tomo_backproject sparse sinograms: max err {float(err.max())}, "
                             f"{int((err > tol).sum())} pixels over 2 A eps_f32 |ref|")
    return {"lit_bins_per_row": int((sinos > 0).sum(-1).max()), "max_abs_err": float(err.max()),
            "worst_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
            "tol_rule": "per element 2 A eps_f32 |ref|", "nonzero_pixels": int((ref != 0).sum())}


def check_quality(torch, tomo) -> dict:
    """The repo's own reconstruction check, on the card and through the
    kernels: on a small phantom ML-EM beats GridRec and stays within half
    the image's RMS."""
    dev = torch.device("cuda", 0)
    n, a = 48, 60
    img = tomo.shepp_logan(n).to(dev)
    angles = torch.from_numpy(tomo.angle_grid(a)).to(dev)
    sino = tomo.project(img, angles, n + 16)
    e_grid = float(((tomo.gridrec(sino, angles, n) - img) ** 2).mean().sqrt())
    e_mlem = float(((tomo.mlem(sino, angles, n, iters=16) - img) ** 2).mean().sqrt())
    rms = float((img ** 2).mean().sqrt())
    if not (e_mlem < e_grid and e_mlem < 0.5 * rms):
        raise AssertionError(f"quality ordering broken: mlem {e_mlem}, gridrec {e_grid}, rms {rms}")
    return {"rmse_gridrec": e_grid, "rmse_mlem": e_mlem, "rms_image": rms}


def _bf16_tol(torch, ref, v):
    """Per-element tolerance of a bf16 attention output: kernel and plain
    version both compute in f32 and round once to bf16, so they differ by
    one bf16 step of that element, 2^-7 |ref|, plus the order of their f32
    sums, ATTN_SUM_REL max|v|."""
    return BF16_STEP * ref.float().abs() + ATTN_SUM_REL * float(v.float().abs().max())


def _bf16_close(torch, name: str, out, ref, v) -> dict:
    tol = _bf16_tol(torch, ref, v)
    err = (out.float() - ref.float()).abs()
    if out.shape != ref.shape or out.dtype != ref.dtype or not bool(out.isfinite().all()) \
            or bool((err > tol).any()):
        raise AssertionError(f"{name}: max err {float(err.max())}, worst err/tol "
                             f"{float((err / tol).max())} (shape {tuple(out.shape)})")
    return {"max_abs_err": float(err.max()), "worst_err_over_tol": float((err / tol).max()),
            "tol_rule": "per element 2^-7 |ref| + 2^-15 max|v|"}


def _off_by_one(torch, attn, name: str, out, q, k, v, rows, pos) -> dict:
    """The check must fail a mask off by one where it is hardest to see:
    on rows with at least LONG_ROW live keys. ``out`` (n, 1, H, hd) are
    kernel outputs for query rows ``q`` (n, 1, H, hd) over caches ``k``,
    ``v`` (n, S, KV, hd) at ``pos`` (n,); the plain decode version at
    ``pos`` must pass every row, at ``pos - 1`` (a key missing) and at
    ``pos + 1`` (one too many) it must fail every row."""
    def worst_per_row(p):
        ref = attn.decode_attention_plain(q, k, v, p)
        return ((out.float() - ref.float()).abs() / _bf16_tol(torch, ref, v)).flatten(1).amax(1)

    right = worst_per_row(pos)
    wrong = torch.minimum(worst_per_row(pos - 1), worst_per_row(pos + 1))
    if bool((right > 1).any()) or bool((wrong <= 1).any()):
        raise AssertionError(f"{name}: the mask check is blind on rows {rows.tolist()}: "
                             f"right {right.tolist()}, off by one {wrong.tolist()}")
    return {"long_rows": len(rows), "worst_right_over_tol": float(right.max()),
            "least_off_by_one_over_tol": float(wrong.min())}


def launch_floor_ms(torch) -> float:
    """Device time of the least kernel: a one-element in-place add, timed
    as ``graph_ms`` times the short kernels. A kernel's time cannot fall
    below it, however small its bound."""
    x = torch.zeros(1, device="cuda")
    return graph_ms(torch, lambda: x.add_(1), 100)


def _bitwise_repeatable(torch, name: str, fn, out) -> None:
    """``fn()`` called again, then captured in a CUDA graph that is replayed
    three times: every result bitwise equal to ``out``."""
    again = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(captured.clone())
    torch.cuda.synchronize()
    if not all(torch.equal(out, r) for r in (again, *replays)):
        raise AssertionError(f"{name}: repeated calls or graph replays differ bitwise")


def decode_inputs(torch, b: int, s: int):
    """q, k, v (bf16, the serving path's head layout) and positions of a
    timed decode case, from a generator of their own (seeded SEED + b), so
    that no other check's draws shift them: the first rows at the last
    entry, 0, 15, 16, 127 and 128, the rest scattered. They do not follow
    any kernel's own tiling, so a kernel retuned later is timed on the same
    work."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + b)
    q = torch.randn((b, 1, HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, KV_HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, KV_HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    pos = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
    edges = torch.tensor([s - 1, 0, 15, 16, 127, 128], dtype=torch.int32, device=dev)[:b]
    pos[: len(edges)] = edges
    return q, k, v, pos


def check_decode_split(torch, attn, b: int, s: int, gen) -> dict:
    """``decode_attention`` (untimed) with rows at the edges of the chunks
    the split kernel takes at these sizes (C - 1, 2 C, C, C + 1 for its
    chunk C), the last entry, 0 and past the cache, the rest scattered:
    held to the per-element rule, and two more calls and three replays of
    a captured call must give bitwise the same output."""
    dev = torch.device("cuda", 0)
    q = torch.randn((b, 1, HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, KV_HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, KV_HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    pos = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
    chunk = attn.decode_chunk(attn.DECODE_LIB, dev, b, s, HEADS, KV_HEADS, HEAD_DIM, 1)
    edges = [min(p, s + 3) for p in (chunk - 1, 2 * chunk, chunk, chunk + 1, s - 1, 0, s + 3)]
    pos[: min(b, len(edges))] = torch.tensor(edges, dtype=torch.int32, device=dev)[:b]
    out = attn.decode_attention_cuda(q, k, v, pos)
    name = f"decode_attention split edges B={b} S={s}"
    res = _bf16_close(torch, name, out, attn.decode_attention_plain(q, k, v, pos), v)
    _bitwise_repeatable(torch, name, lambda: attn.decode_attention_cuda(q, k, v, pos), out)
    return {"chunk": chunk, "positions": pos[: len(edges)].tolist(), "bitwise_repeatable": True,
            **res}


def check_decode(torch, attn, b: int, s: int) -> dict:
    """``decode_attention`` on :func:`decode_inputs`, timed; where rows hold
    LONG_ROW or more keys, a mask off by one must fail the check."""
    dev = torch.device("cuda", 0)
    q, k, v, pos = decode_inputs(torch, b, s)
    out = attn.decode_attention_cuda(q, k, v, pos)
    name = f"decode_attention B={b} S={s}"
    res = _bf16_close(torch, name, out, attn.decode_attention_plain(q, k, v, pos), v)
    rows = torch.nonzero((pos >= LONG_ROW) & (pos <= s - 2)).flatten()
    if len(rows):
        res["off_by_one"] = _off_by_one(torch, attn, name, out[rows], q[rows], k[rows], v[rows],
                                        rows, pos[rows])
    res["chunk"] = attn.decode_chunk(attn.DECODE_LIB, dev, b, s, HEADS, KV_HEADS, HEAD_DIM, 1)
    live = int(torch.clamp(pos + 1, max=s).sum())  # cache entries the rows attend to
    n_bytes = 2 * live * KV_HEADS * HEAD_DIM * 2 + 2 * q.numel() * 2 + b * 4
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * live * HEADS * HEAD_DIM, BF16_OPS_PER_S)
    res["ms"] = graph_ms(torch, lambda: attn.decode_attention_cuda(q, k, v, pos), 100)
    res["plain_ms"] = graph_ms(torch, lambda: attn.decode_attention_plain(q, k, v, pos), 20)
    # SDPA with a boolean mask: K/V repeated to the 9 query heads and
    # everything put in (B, heads, S, hd) outside the timed call
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(HEADS // KV_HEADS, dim=1).contiguous()
              for x in (k, v))
    mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_ms"] = graph_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask), 100)
    res["call_ms"] = time_ms(torch, lambda: attn.decode_attention_cuda(q, k, v, pos), 200, 10)
    return res


def check_flash(torch, attn, b: int, s: int, gen, timing: bool) -> dict:
    """``flash_attention``, causal, Sq = Skv = s, at the serving path's head
    layout, bf16. Query row i of a causal prefill is a decode over keys
    0..i, so a sample of rows with LONG_ROW or more keys goes through the
    off-by-one check against the plain decode version."""
    dev = torch.device("cuda", 0)
    q = torch.randn((b, s, HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, KV_HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, KV_HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    out = attn.flash_attention_cuda(q, k, v, causal=True)
    name = f"flash_attention B={b} S={s}"
    res = _bf16_close(torch, name, out, attn.flash_attention_plain(q, k, v, causal=True), v)
    rows = torch.arange(LONG_ROW, s - 1, 8, device=dev)  # query rows i, keys 0..i
    n = len(rows)

    def expand(x):  # (b, s, KV, hd) -> one cache per sampled row, (b * n, s, KV, hd)
        return x[:, None].expand(b, n, *x.shape[1:]).reshape(b * n, *x.shape[1:])

    res["off_by_one"] = _off_by_one(
        torch, attn, name, out[:, rows].reshape(b * n, 1, HEADS, HEAD_DIM),
        q[:, rows].reshape(b * n, 1, HEADS, HEAD_DIM), expand(k), expand(v),
        rows.repeat(b), rows.repeat(b).to(torch.int32))
    if timing:
        pairs = s * (s + 1) // 2  # causal (query, key) pairs per head
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * b * HEADS * HEAD_DIM * pairs,
                                                 BF16_OPS_PER_S)
        res["ms"] = graph_ms(torch, lambda: attn.flash_attention_cuda(q, k, v, causal=True), 50)
        res["plain_ms"] = graph_ms(
            torch, lambda: attn.flash_attention_plain(q, k, v, causal=True), 10)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).repeat_interleave(HEADS // KV_HEADS, dim=1).contiguous()
                  for x in (k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = graph_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True), 50)
        res["call_ms"] = time_ms(torch, lambda: attn.flash_attention_cuda(q, k, v, causal=True),
                                 100, 5)
    return res


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def drive(stream, source, n_batches: int, timeout: float) -> float:
    t0 = time.monotonic()
    stream.start()
    source.start()
    try:
        stream.await_batches(n_batches, timeout=timeout)
    finally:
        stream.stop()
        source.stop()
    return time.monotonic() - t0


def report(name: str, app, stream, wall: float) -> dict:
    lat = app.stats.latency
    out = {"path": name, "batches": stream.stats.batches, "messages": app.stats.messages,
           "wall_s": wall, "msgs_per_s": app.stats.messages / wall,
           "latency_p50_s": lat.p50, "latency_p99_s": lat.p99}
    print("path " + json.dumps(out))
    return out


def kmeans_path(torch, kernels, miniapps, cluster, ctx, device) -> dict:
    inertias: list[float] = []

    class TracedKMeans(miniapps.StreamingKMeans):
        def _on_complete(self, result, meta, dt):
            super()._on_complete(result, meta, dt)
            inertias.append(self._inertia)

    cluster.create_topic("points", 8)
    source = miniapps.KMeansClusterSource(
        cluster, miniapps.SourceConfig("points", total_messages=640, n_producers=4, seed=SEED),
        n_clusters=10, dim=3, points_per_msg=5000)
    app = TracedKMeans(10, 3, seed=SEED, device=device)
    stream = ctx.stream(cluster, "points", group="kmeans", process_fn=app.process,
                        batch_interval=0.05, max_batch_records=16)
    kernels.reset_launches()
    wall = drive(stream, source, 20, 300)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    centroids = stream.state
    if not bool(torch.isfinite(centroids).all()) or centroids.shape != (10, 3):
        raise AssertionError(f"bad centroids {centroids}")
    if not inertias[-1] < inertias[0]:
        raise AssertionError(f"inertia did not fall: {inertias}")
    out = report("kmeans", app, stream, wall)
    out["inertia_first"], out["inertia_last"] = inertias[0], inertias[-1]
    return {"report": out, "launches": launches}


def kmeans_wide_path(torch, kernels, miniapps, cluster, ctx, device) -> dict:
    """The K-Means stream at 1024 centres in 128 dimensions: every message
    is in the log before the stream starts, so each batch takes
    WIDE_MSGS_PER_BATCH messages (N = 65 536, the wide regime)."""
    inertias: list[float] = []
    sizes: list[int] = []

    class TracedKMeans(miniapps.StreamingKMeans):
        def _on_complete(self, result, meta, dt):
            super()._on_complete(result, meta, dt)
            inertias.append(self._inertia)
            sizes.append(meta[1])

    n_msgs = WIDE_MSGS_PER_BATCH * WIDE_BATCHES
    cluster.create_topic("points_wide", 4)
    source = miniapps.KMeansClusterSource(
        cluster, miniapps.SourceConfig("points_wide", total_messages=n_msgs, n_producers=4,
                                       seed=SEED),
        n_clusters=WIDE_K, dim=WIDE_D, points_per_msg=WIDE_POINTS_PER_MSG)
    app = TracedKMeans(WIDE_K, WIDE_D, seed=SEED, device=device)
    stream = ctx.stream(cluster, "points_wide", group="kmeans_wide", process_fn=app.process,
                        batch_interval=0.5, max_batch_records=WIDE_MSGS_PER_BATCH,
                        backpressure=False)
    source.start()
    source.join(300)
    if source.sent_records != n_msgs:
        raise AssertionError(f"wide source sent {source.sent_records} of {n_msgs} messages")
    kernels.reset_launches()
    t0 = time.monotonic()
    stream.start()
    try:
        stream.await_batches(WIDE_BATCHES, timeout=300)
    finally:
        stream.stop()
        source.stop()
    wall = time.monotonic() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    centroids = stream.state
    if not bool(torch.isfinite(centroids).all()) or centroids.shape != (WIDE_K, WIDE_D):
        raise AssertionError(f"wide K-Means: bad centroids {tuple(centroids.shape)}")
    if sizes != [WIDE_MSGS_PER_BATCH * WIDE_POINTS_PER_MSG] * WIDE_BATCHES:
        raise AssertionError(f"wide K-Means batch sizes {sizes}")
    if not inertias[-1] < inertias[0]:
        raise AssertionError(f"wide K-Means inertia did not fall: {inertias}")
    if launches["kmeans_assign"] != stream.stats.batches:
        raise AssertionError(f"kmeans_assign launched {launches['kmeans_assign']} times for "
                             f"{stream.stats.batches} batches")
    out = report("kmeans_wide", app, stream, wall)
    out["inertia_first"], out["inertia_last"] = inertias[0], inertias[-1]
    return {"report": out, "launches": launches}


def recon_path(torch, kernels, miniapps, tomo, cluster, ctx, device) -> dict:
    a, n_det, n = FRAME_ANGLES, FRAME_BINS, RECON_N
    kernels.reset_launches()
    reports, states = [], {}
    payload = None
    for algo in ("gridrec", "mlem"):
        topic = f"frames_{algo}"
        cluster.create_topic(topic, 4)
        source = miniapps.LightsourceTemplateSource(
            cluster, miniapps.SourceConfig(topic, total_messages=32, n_producers=2, seed=SEED),
            n_angles=a, n_det=n_det)
        payload = source._payload
        app = miniapps.ReconstructionApp(algo, n=n, mlem_iters=MLEM_ITERS, device=device)
        # backpressure off: every micro-batch fills to 8 frames
        stream = ctx.stream(cluster, topic, group=algo, process_fn=app.process,
                            batch_interval=0.5, max_batch_records=8, backpressure=False)
        wall = drive(stream, source, 4, 600)
        state = stream.state
        if state.shape != (n, n) or not bool(torch.isfinite(state).all()):
            raise AssertionError(f"{algo}: bad reconstruction {tuple(state.shape)}")
        states[algo] = state
        reports.append(report(algo, app, stream, wall))
    launches = {k.name: k.launches for k in kernels.KERNELS}

    # hold the last reconstructions (every frame is the template payload)
    # against the plain versions on the same frame
    checks = {algo: recon_vs_plain(torch, tomo, algo, states[algo], payload, device)
              for algo in ("gridrec", "mlem")}
    print("recon_vs_plain " + json.dumps(checks))
    return {"reports": reports, "launches": launches}


def recon_vs_plain(torch, tomo, algo: str, state, payload, device) -> dict:
    """Hold a reconstruction of the template frame ``payload`` at n =
    RECON_N against the plain versions' reconstruction of the same frame;
    raises past the tolerance."""
    a, n_det, n = FRAME_ANGLES, FRAME_BINS, RECON_N
    sino = torch.from_numpy(payload).to(device)[None]
    angles = torch.from_numpy(tomo.angle_grid(a)).to(device)
    cos_t, sin_t = tomo.trig(angles)
    if algo == "gridrec":
        # one backprojection of signed terms, one per angle
        filtered = tomo.ramp_filter(sino)
        scale = math.pi / (2 * a)
        ref = tomo.backproject_plain(filtered, cos_t, sin_t, n)[0] * scale
        grid_abs = tomo.backproject_plain(filtered.abs(), cos_t, sin_t, n)[0] * scale
        tol = a * F32_EPS * float(grid_abs.max())
    else:
        # ML-EM: its projections and backprojections of ratio updates
        # compound the per-pass rounding; 1e-3 of the peak
        x = torch.ones((1, n, n), device=device)
        norm = tomo.backproject_plain(torch.ones_like(sino), cos_t, sin_t, n) + 1e-6
        for _ in range(MLEM_ITERS):
            fp = tomo.project_plain(x, cos_t, sin_t, n_det)
            x = x * tomo.backproject_plain(sino / fp.clamp_min(1e-6), cos_t, sin_t, n) / norm
        ref, tol = x[0], 1e-3 * float(x.abs().max())
    if state.shape != (n, n) or not bool(torch.isfinite(state).all()):
        raise AssertionError(f"{algo}: bad reconstruction {tuple(state.shape)}")
    err = float((state - ref).abs().max())
    if err > tol:
        raise AssertionError(f"{algo} reconstruction vs plain: max err {err} > tol {tol}")
    return {"max_abs_err": err, "tol": tol}


def serve_path(torch, kernels, miniapps, cluster, ctx, device, n_msgs: int = SERVE_MSGS) -> dict:
    """The LM serving stream at smollm-135m's full width, ``n_msgs``
    messages; returns the path's report and launches, the params and every
    served (prompts, tokens)."""
    from repro_torch.configs import get_arch

    served: list = []

    class TracedServe(miniapps.LMServeApp):
        def _serve_continuous(self, params, msgs):
            out = super()._serve_continuous(params, msgs)
            served.append((self._stack_requests(msgs), out))
            return out

    cfg = get_arch("smollm-135m")
    app = TracedServe(cfg, mode="continuous", prompt_len=PROMPT_LEN, gen_tokens=GEN_TOKENS,
                      batch=SERVE_BATCH, page_size=PAGE_SIZE, device=device)
    params = app.model.init(torch.Generator(device=device).manual_seed(SEED))
    cluster.create_topic("requests", 2)
    source = miniapps.TokenSource(
        cluster, miniapps.SourceConfig("requests", total_messages=n_msgs, seed=SEED),
        vocab_size=cfg.vocab_size, seq_len=PROMPT_LEN, seqs_per_msg=SERVE_BATCH)
    stream = ctx.stream(cluster, "requests", group="server", process_fn=app.process,
                        state=params, batch_interval=0.1, max_batch_records=1)
    kernels.reset_launches()
    wall = drive(stream, source, n_msgs, 600)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    requests = sum(len(out) for _, out in served)
    tokens = sum(out.size for _, out in served)
    if requests != n_msgs * SERVE_BATCH or any(
            out.shape != (SERVE_BATCH, GEN_TOKENS) or out.min() < 0 or out.max() >= cfg.vocab_size
            for _, out in served):
        raise AssertionError(f"served {requests} requests, shapes {[o.shape for _, o in served]}")
    lat = app.stats.latency
    out = {"path": "serve", "batches": stream.stats.batches, "requests": requests,
           "generated_tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "latency_p50_s": lat.p50, "latency_p99_s": lat.p99}
    print("path " + json.dumps(out))
    return {"report": out, "launches": launches, "app": app, "params": params, "served": served}


def rescore(torch, serve: dict) -> dict:
    """Every generated token against one prefill of its context (prompt +
    the tokens served before it), batched: row t of a request is the
    sequence with ``last_pos = PROMPT_LEN - 1 + t``. That prefill runs the
    flash kernel; the served tokens came through the decode kernel."""
    import numpy as np

    from repro_torch.models.common import first_argmax

    model = serve["app"].model
    p = model.compute_params(serve["params"])
    device = serve["params"]["embed"].device
    checked = agree = 0
    worst = 0.0  # the largest top-2 gap at which a served token differed
    for prompts, out in serve["served"]:
        seqs = torch.from_numpy(np.concatenate([prompts, out], axis=1)).to(device)
        toks = seqs.repeat_interleave(GEN_TOKENS, dim=0)  # (B * T, P + T)
        last = (PROMPT_LEN - 1 + torch.arange(GEN_TOKENS, device=device)).repeat(len(out))
        logits, _ = model.prefill(p, {"tokens": toks, "last_pos": last})
        logits = logits[:, 0]
        top2 = logits.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = first_argmax(logits, dim=-1) == torch.from_numpy(out).to(device).reshape(-1).long()
        clear = gap > RESCORE_GAP
        bad = clear & ~same
        if bool(bad.any()):
            raise AssertionError(f"{int(bad.sum())} served tokens differ from the prefill argmax "
                                 f"where the top-2 gap exceeds {RESCORE_GAP}")
        checked += int(clear.sum())
        agree += int(same.sum())
        if not bool(same.all()):
            worst = max(worst, float(gap[~same].max()))
    total = sum(out.size for _, out in serve["served"])
    if checked < total // 4:
        raise AssertionError(f"only {checked} of {total} positions had a clear top-2 gap")
    res = {"positions": total, "checked": checked, "agree": agree,
           "largest_gap_where_differing": worst, "gap_tol": RESCORE_GAP}
    print("rescore " + json.dumps(res))
    return res


def pipeline_spec(pipeline):
    """The pipeline phase's spec, built by the port's ``Pipeline``."""
    return (pipeline.Pipeline.named("smoke")
            .broker(nodes=1)
            .topic("frames", partitions=4).topic("points", partitions=8)
            .source("frames", kind="lightsource", seed=SEED, total_messages=PIPE_FRAMES,
                    rate_msgs_per_s=PIPE_FRAME_SCHEDULE[0][1],
                    rate_schedule=list(PIPE_FRAME_SCHEDULE),
                    n_angles=FRAME_ANGLES, n_det=FRAME_BINS)
            .source("points", kind="cluster", seed=SEED, total_messages=PIPE_POINTS,
                    rate_msgs_per_s=PIPE_POINTS_RATE, n_clusters=10, dim=3, points_per_msg=5000)
            .stage("recon", topic="frames", processor="mlem", n=RECON_N, mlem_iters=MLEM_ITERS,
                   max_batch_records=PIPE_RECON_BATCH, batch_interval=0.05,
                   backpressure=PIPE_RECON_RATE_CONTROL)
            .stage("kmeans", topic="points", processor="kmeans", n_clusters=10, dim=3, seed=SEED,
                   max_batch_records=16, batch_interval=0.05)
            .elastic("recon", policy="threshold", high_lag=24, low_lag=4, min_devices=1,
                     max_devices=4, interval=0.2, cooldown=1.0)
            .build())


def pipeline_cli(pipeline) -> dict:
    """``python -m repro_torch.pipeline validate`` in a fresh interpreter:
    0 on the phase's spec written as JSON, 1 with the ROADMAP A2 refusal on
    the same spec with a continuous K-Means stage (built as data:
    ``Pipeline.build`` refuses it)."""
    import dataclasses

    spec = pipeline_spec(pipeline)
    bad = dataclasses.replace(spec, stages=tuple(
        dataclasses.replace(st, engine="continuous") if st.name == "kmeans" else st
        for st in spec.stages))
    out_dir = ROOT / "build" / "pipeline_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}
    for name, sp, want in (("valid", spec, 0), ("continuous", bad, 1)):
        path = out_dir / f"{name}.json"
        path.write_text(sp.to_json(indent=1))
        proc = subprocess.run([sys.executable, "-m", "repro_torch.pipeline", "validate", str(path)],
                              capture_output=True, text=True, timeout=300, cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        if proc.returncode != want:
            raise AssertionError(f"pipeline CLI validate {name}: exit {proc.returncode}, want "
                                 f"{want}\n{proc.stdout}{proc.stderr}")
        if want == 1 and "engine='continuous' waits for the port's continuous engine " \
                         "(ROADMAP A2)" not in proc.stderr:
            raise AssertionError(f"pipeline CLI: no A2 refusal in {proc.stderr!r}")
        res[name] = {"exit": proc.returncode,
                     "said": (proc.stdout + proc.stderr).strip().splitlines()[-1]}
    return res


def pipeline_path(torch, kernels, pipeline, kmeans, tomo) -> dict:
    """The pipeline phase: :func:`pipeline_spec` through ``spec.run(devices=
    PIPE_SLOTS)`` on the card until both streams have drained and the ML-EM
    stage has scaled up and down again (or PIPE_TIMEOUT_S, which fails the
    run). Checks every message processed, the arbiter within the pool, the
    kernels launched, the apps on the card, K-Means inertia falling, the
    last reconstruction against the plain version, and the teardown in
    reverse start order with no errors."""
    import numpy as np

    spec = pipeline_spec(pipeline)
    run = spec.run(devices=PIPE_SLOTS)
    kernels.reset_launches()
    t0 = time.monotonic()
    # every 0.25 s: [t, ML-EM slots, its lag, frames sent, frames processed]
    timeline: list[list] = []
    with run:
        ctl = run.controller("recon")
        frames, recon = run.source("frames"), run.stream("recon")
        while True:
            now = time.monotonic() - t0
            if not timeline or now - timeline[-1][0] >= 0.25:
                timeline.append([round(now, 3), ctl.devices, run.lag("recon"),
                                 frames.sent_records, recon.stats.records])
            drained = run.sources_finished and all(
                run.lag(st) == 0 and run.stream(st).stats.records
                == run.source(spec.stage(st).topic).sent_records for st in ("recon", "kmeans"))
            if drained and ctl.events.of("scale_up") and ctl.events.of("scale_down"):
                break
            if now > PIPE_TIMEOUT_S:
                print("pipeline_timeline " + json.dumps(timeline))
                raise AssertionError(
                    f"pipeline phase: not done after {PIPE_TIMEOUT_S} s: drained {drained}, "
                    f"events {[(e.action, e.devices_after) for e in ctl.events]}, lag "
                    f"{ {st: run.lag(st) for st in ('recon', 'kmeans')} }, controller error "
                    f"{ctl._last_error!r}")
            time.sleep(0.05)
        wall = time.monotonic() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if run.errors:
        raise AssertionError(f"pipeline teardown errors: {run.errors!r}")
    started = ["service", "arbiter"] + [f"stream:{st.name}" for st in spec.stages] + [
        "controller:recon", "source:frames", "scenario:frames", "source:points"]
    if run.teardown_log != started[::-1]:
        raise AssertionError(f"pipeline teardown order {run.teardown_log}, want {started[::-1]}")
    free = [v for _, v in run.bus.series("scheduler.free")]
    if not free or min(free) < 0:
        raise AssertionError(f"scheduler.free left the pool: {free}")
    if max(e.devices_after for e in ctl.events) > PIPE_SLOTS:
        raise AssertionError(f"recon held more slots than the pool: {list(ctl.events)}")
    for name in ("kmeans_assign", "kmeans_update", "tomo_project", "tomo_backproject"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched in the pipeline phase")
    km_app, rc_app = run.processor("kmeans"), run.processor("recon")
    km_state, rc_state = run.stream("kmeans").state, run.stream("recon").state
    for name, x in (("kmeans app", km_app.device), ("kmeans state", km_state.device),
                    ("recon app", rc_app.device), ("recon state", rc_state.device)):
        if x.type != "cuda":
            raise AssertionError(f"pipeline phase: {name} on {x}, not the card")

    # inertia of the initial and the final centroids on one fresh message
    # of the cluster stream: the stream's updates must have lowered it
    pts = torch.from_numpy(run.source("points").make_message(
        np.random.default_rng(SEED + 1), 0).astype(np.float32)).to(km_state.device)
    inertia = [float(kmeans.assign(pts, c.contiguous())[1].mean())
               for c in (km_app.centroids, km_state)]
    if not inertia[1] < inertia[0]:
        raise AssertionError(f"pipeline K-Means inertia did not fall: {inertia}")
    vs_plain = recon_vs_plain(torch, tomo, "mlem", rc_state, run.source("frames")._payload,
                              rc_state.device)

    stages = {}
    for st in ("recon", "kmeans"):
        lat = run.processor(st).stats.latency
        records = run.stream(st).stats.records
        stages[st] = {"records": records, "sent": run.source(spec.stage(st).topic).sent_records,
                      "batches": run.stream(st).stats.batches, "msgs_per_s": records / wall,
                      "latency_p50_s": lat.p50, "latency_p99_s": lat.p99}
    out = {"path": "pipeline", "slots": PIPE_SLOTS, "wall_s": wall, "stages": stages,
           "events": [[round(e.t - t0, 3), e.action, e.devices_after] for e in ctl.events],
           "scheduler_free_min": min(free), "inertia_first_last": inertia,
           "recon_vs_plain": vs_plain, "launches": launches,
           "timeline_t_slots_lag_sent_processed": timeline}
    print("path " + json.dumps(out))
    out["cli"] = pipeline_cli(pipeline)
    print("pipeline_cli " + json.dumps(out["cli"]))
    return {"report": out, "launches": launches}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels, miniapps, pipeline
    from repro_torch.core import PilotComputeService
    from repro_torch.kernels import attention, kmeans, tomo

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print("host " + json.dumps(host_probe(torch)))

    build_s = kernels.build_all()
    print(f"build: {build_s:.1f} s for {len(kernels.KERNELS)} kernels")
    for lib in dict.fromkeys(k.library for k in kernels.KERNELS):
        if lib.log_path.exists():  # per library: its kernels' most registers and all spills
            log = lib.log_path.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
            spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
            print(f"ptxas {lib.source.name}: {len(regs)} kernels, at most {max(regs, default=0)} "
                  f"registers, {spills} bytes of spill stores and loads")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the short kernels' bounds lie below any launch: the least kernel's time beside them
    floor = launch_floor_ms(torch)
    for n, d, k, dtype, clustered, timing in (
            (80_000, 3, 10, torch.float32, True, True), (65_536, 128, 1024, torch.float32, False, True),
            (80_000, 3, 10, torch.bfloat16, True, False),
            (65_536, 128, 1024, torch.bfloat16, False, True)):
        res = check_assign(torch, kmeans, n, d, k, dtype, clustered, gen, timing, floor)
        if (n, d, dtype) == (80_000, 3, torch.float32):
            assign_main = res
        name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
        print(f"check kmeans_assign {n}x{d}x{k} {name} " + json.dumps(res))
    # rows too long for one centroid in 48 KB, below wide's K = 16: the
    # chunked regime (K = 2 timed)
    for k in (2, 15):
        res = check_assign(torch, kmeans, 4096, 20_000, k, torch.float32, False, gen, k == 2, floor)
        print(f"check kmeans_assign 4096x20000x{k} f32 " + json.dumps(res))
    # the update at the K-Means streams' shape (batches of up to 16 messages
    # of 5000 points over 10 labels: nearly every launch on the main path)
    # and at the wide stream's, where the worst cases are checked too
    update_main = check_update(torch, kmeans, 80_000, 3, 10, gen, False)
    print("check kmeans_update 80000x3x10 f32 " + json.dumps(update_main))
    print(f"check kmeans_update 65536x{WIDE_D}x{WIDE_K} f32 "
          + json.dumps(check_update(torch, kmeans, 65_536, WIDE_D, WIDE_K, gen, True)))
    bp, fp = check_tomo(torch, tomo, gen)
    print("check tomo_backproject 8x360x1448 n=1448 " + json.dumps(bp))
    print("check tomo_project 8x1448x1448 A=360 " + json.dumps(fp))
    print("check tomo_backproject sparse 8x360x1448 n=1448 "
          + json.dumps(check_backproject_sparse(torch, tomo, gen)))
    print("check tomo_project sparse 8x1448x1448 A=360 "
          + json.dumps(check_project_sparse(torch, tomo, gen)))
    print("check quality " + json.dumps(check_quality(torch, tomo)))
    decode_main = check_decode(torch, attention, SERVE_BATCH, 256)
    decode_main["launch_floor_ms"] = floor
    print(f"check decode_attention B={SERVE_BATCH} S=256 bf16 " + json.dumps(decode_main))
    for b in (1, 64):
        print(f"check decode_attention B={b} S=256 bf16 "
              + json.dumps(check_decode(torch, attention, b, 256)))
    for b in (1, SERVE_BATCH, 64):
        print(f"check decode_attention split edges B={b} S=256 bf16 "
              + json.dumps(check_decode_split(torch, attention, b, 256, gen)))
    flash_main = check_flash(torch, attention, 1, PROMPT_LEN, gen, True)
    print(f"check flash_attention B=1 S={PROMPT_LEN} causal bf16 " + json.dumps(flash_main))
    for b, s in ((4, 128), (4, 512), (1, 2048)):
        print(f"check flash_attention B={b} S={s} causal bf16 "
              + json.dumps(check_flash(torch, attention, b, s, gen, True)))

    svc = PilotComputeService()
    try:
        broker = svc.submit_pilot({"number_of_nodes": 2, "type": "kafka"})
        spark = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"})
        cluster, ctx = broker.get_context(), spark.get_context()
        device = ctx.devices[0]
        km = kmeans_path(torch, kernels, miniapps, cluster, ctx, device)
        kw = kmeans_wide_path(torch, kernels, miniapps, cluster, ctx, device)
        rc = recon_path(torch, kernels, miniapps, tomo, cluster, ctx, device)
        sv = serve_path(torch, kernels, miniapps, cluster, ctx, device)
    finally:
        svc.cancel()
    rescore(torch, sv)
    pl = pipeline_path(torch, kernels, pipeline, kmeans, tomo)
    paths = {"kmeans_path": km["launches"], "kmeans_wide_path": kw["launches"],
             "lightsource_path": rc["launches"], "serve_path": sv["launches"],
             "pipeline_path": pl["launches"]}
    launches = {k.name: sum(p[k.name] for p in paths.values()) for k in kernels.KERNELS}
    print("launches " + json.dumps(paths))
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    if km["launches"]["kmeans_assign"] < 1:
        raise AssertionError("kmeans_assign was not launched on the K-Means stream")

    src = "src/repro_torch/kernels/csrc/"
    rows = [
        ("kmeans_assign", src + "kmeans_assign.cu", "src/repro/kernels/kmeans/kernel.py:45", assign_main),
        # no TPU kernel: the reference's update is a jnp scatter (update_scatter)
        ("kmeans_update", src + "kmeans_update.cu", "src/repro/kernels/kmeans/ref.py:38", update_main),
        ("tomo_backproject", src + "tomo.cu", "src/repro/kernels/tomo/kernel.py:86", bp),
        ("tomo_project", src + "tomo.cu", "src/repro/kernels/tomo/kernel.py:107", fp),
        ("flash_attention", src + "flash_attention.cu", "src/repro/kernels/attention/kernel.py:81",
         flash_main),
        ("decode_attention", src + "decode_attention.cu",
         "src/repro/kernels/attention/decode_kernel.py:79", decode_main),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, source, replaces, r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
