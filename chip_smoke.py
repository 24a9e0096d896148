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
   fail a mask off by one; for ``tomo_project`` also on sparse images,
   where a dropped pixel shows; flash attention also at B=1 S=2048, where
   the work is operations), and times kernel, plain version and (where one
   exists) a single PyTorch library call that computes the same function:
   by device time, replaying a CUDA graph of many calls, where a call is
   short (K-Means, attention; the host's per-call time is printed beside
   it as ``call_ms``), by CUDA events around calls for the projectors;
4. drives the main paths through the port's entry points: a
   ``PilotComputeService`` on the card with a ``kafka`` pilot (2 broker
   nodes) and a ``spark`` pilot, then (a) a K-Means cluster stream of
   5000 x 3 points per message into ``StreamingKMeans(10, 3)``, (b) a
   light-source stream of 360 x 1448 sinograms reconstructed at n = 1448 by
   GridRec and by ML-EM, and (c) the LM serving stream: 16 messages of 4
   prompts of 128 tokens into ``LMServeApp`` on ``smollm-135m`` at full
   width (random weights from the seed), continuous batching over paged
   KV, 32 greedy tokens per request; every kernel's launch count is set to
   0 just before a path and read just after it;
5. re-scores every served sequence with the model's prefill and holds each
   generated token against that forward's argmax;
6. prints one JSON line ``{"kernels": [...]}`` and, last, one JSON line
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
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, f32 rate outside
# the tensor cores, and the bf16 tensor-core rate. A kernel's operations are
# held against the peak for its inputs' type: f32 for K-Means and the
# projectors, bf16 for the attention kernels at the serving path's width.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
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


def check_assign(torch, kmeans, n: int, d: int, k: int, dtype, clustered: bool,
                 gen, timing: bool) -> dict:
    dev = torch.device("cuda", 0)
    if clustered:  # the cluster source's data: 10 centres in [-10, 10]^3, spread 0.5
        centers = torch.rand((k, d), generator=gen, device=dev) * 20 - 10
        idx = torch.randint(0, k, (n,), generator=gen, device=dev)
        points = centers[idx] + 0.5 * torch.randn((n, d), generator=gen, device=dev)
    else:
        points = torch.randn((n, d), generator=gen, device=dev)
    centroids = torch.randn((k, d), generator=gen, device=dev)
    points, centroids = points.to(dtype).contiguous(), centroids.to(dtype).contiguous()

    labels, dist = kmeans.assign_cuda(points, centroids)
    ref_labels, ref_dist = kmeans.assign_ref(points, centroids)
    torch.cuda.synchronize()
    # rounding of |p|^2 - 2 p.c + |c|^2 in f32, summed over D terms in two
    # orders: 8 (D + 2) eps_f32 (|p| + max|c|)^2 per point
    p, c = points.float(), centroids.float()
    scale = (p.norm(dim=1) + c.norm(dim=1).max()) ** 2
    tol = 8 * (d + 2) * 2.0 ** -24 * scale
    err = (dist - ref_dist).abs()
    if not bool(torch.isfinite(dist).all()) or bool((err > tol).any()):
        raise AssertionError(f"kmeans_assign {n}x{d}x{k} {dtype}: max err "
                             f"{float(err.max())}, worst err/tol {float((err / tol).max())}")
    # labels must agree wherever the best and second-best d^2 differ by
    # more than twice the tolerance
    d2 = (p * p).sum(1, keepdim=True) - 2 * p @ c.T + (c * c).sum(1)
    two = d2.topk(2, dim=1, largest=False).values if k > 1 else None
    clear = (two[:, 1] - two[:, 0] > 2 * tol) if two is not None else torch.ones_like(tol, dtype=torch.bool)
    bad = int(((labels != ref_labels) & clear).sum())
    if bad:
        raise AssertionError(f"kmeans_assign {n}x{d}x{k}: {bad} labels differ where the gap is clear")
    out = {"max_abs_err": float(err.max()), "tol": "8 (D+2) 2^-24 (|p| + max|c|)^2 per point",
           "worst_err_over_tol": float((err / tol).max()),
           "labels_differing_in_near_ties": int((labels != ref_labels).sum())}
    if timing:
        elem = points.element_size()
        n_bytes = n * d * elem + k * d * elem + n * 8
        n_ops = 2 * n * k * d + 3 * n * k + 2 * n * d
        out["bound_ms"], out["bound_by"] = bound(n_bytes, n_ops)
        out["ms"] = graph_ms(torch, lambda: kmeans.assign_cuda(points, centroids), 50)
        out["plain_ms"] = graph_ms(torch, lambda: kmeans.assign_ref(points, centroids), 20)
        out["library_ms"] = graph_ms(torch, lambda: torch.cdist(points, centroids).min(1), 20)
        out["call_ms"] = time_ms(torch, lambda: kmeans.assign_cuda(points, centroids), 50, 5)
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


def check_decode(torch, attn, b: int, s: int, gen, timing: bool) -> dict:
    """``decode_attention`` at the serving path's head layout, bf16: rows at
    scattered positions, chunk edges (0, 15, 16, 127, 128) and the last
    entry among them; where rows hold LONG_ROW or more keys, a mask off by
    one must fail the check."""
    dev = torch.device("cuda", 0)
    q = torch.randn((b, 1, HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, KV_HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, KV_HEADS, HEAD_DIM), generator=gen, device=dev).bfloat16()
    pos = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
    edges = torch.tensor([s - 1, 0, 15, 16, 127, 128], dtype=torch.int32, device=dev)[:b]
    pos[: len(edges)] = edges
    out = attn.decode_attention_cuda(q, k, v, pos)
    name = f"decode_attention B={b} S={s}"
    res = _bf16_close(torch, name, out, attn.decode_attention_plain(q, k, v, pos), v)
    rows = torch.nonzero((pos >= LONG_ROW) & (pos <= s - 2)).flatten()
    if len(rows):
        res["off_by_one"] = _off_by_one(torch, attn, name, out[rows], q[rows], k[rows], v[rows],
                                        rows, pos[rows])
    if timing:
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
    sino = torch.from_numpy(payload).to(device)[None]
    angles = torch.from_numpy(tomo.angle_grid(a)).to(device)
    cos_t, sin_t = tomo.trig(angles)
    filtered = tomo.ramp_filter(sino)
    scale = math.pi / (2 * a)
    grid_ref = tomo.backproject_plain(filtered, cos_t, sin_t, n)[0] * scale
    grid_abs = tomo.backproject_plain(filtered.abs(), cos_t, sin_t, n)[0] * scale
    x = torch.ones((1, n, n), device=device)
    norm = tomo.backproject_plain(torch.ones_like(sino), cos_t, sin_t, n) + 1e-6
    for _ in range(MLEM_ITERS):
        fp = tomo.project_plain(x, cos_t, sin_t, n_det)
        x = x * tomo.backproject_plain(sino / fp.clamp_min(1e-6), cos_t, sin_t, n) / norm
    checks = {}
    for algo, ref, tol in (
            # GridRec: one backprojection of signed terms, one per angle
            ("gridrec", grid_ref, a * F32_EPS * float(grid_abs.max())),
            # ML-EM: its projections and backprojections of ratio
            # updates compound the per-pass rounding; 1e-3 of the peak
            ("mlem", x[0], 1e-3 * float(x.abs().max()))):
        err = float((states[algo] - ref).abs().max())
        if err > tol:
            raise AssertionError(f"{algo} reconstruction vs plain: max err {err} > tol {tol}")
        checks[algo] = {"max_abs_err": err, "tol": tol}
    print("recon_vs_plain " + json.dumps(checks))
    return {"reports": reports, "launches": launches}


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels, miniapps
    from repro_torch.core import PilotComputeService
    from repro_torch.kernels import attention, kmeans, tomo

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print("host " + json.dumps(host_probe(torch)))

    build_s = kernels.build_all()
    print(f"build: {build_s:.1f} s for {len(kernels.KERNELS)} kernels")
    for lib in dict.fromkeys(k.library for k in kernels.KERNELS):
        if lib.log_path.exists():
            for line in lib.log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {lib.source.name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    assign_main = check_assign(torch, kmeans, 80_000, 3, 10, torch.float32, True, gen, True)
    print("check kmeans_assign 80000x3x10 f32 " + json.dumps(assign_main))
    wide = check_assign(torch, kmeans, 65_536, 128, 1024, torch.float32, False, gen, True)
    print("check kmeans_assign 65536x128x1024 f32 " + json.dumps(wide))
    bf16 = check_assign(torch, kmeans, 80_000, 3, 10, torch.bfloat16, True, gen, False)
    print("check kmeans_assign 80000x3x10 bf16 " + json.dumps(bf16))
    bp, fp = check_tomo(torch, tomo, gen)
    print("check tomo_backproject 8x360x1448 n=1448 " + json.dumps(bp))
    print("check tomo_project 8x1448x1448 A=360 " + json.dumps(fp))
    print("check tomo_project sparse 8x1448x1448 A=360 "
          + json.dumps(check_project_sparse(torch, tomo, gen)))
    print("check quality " + json.dumps(check_quality(torch, tomo)))
    decode_main = check_decode(torch, attention, SERVE_BATCH, 256, gen, True)
    print(f"check decode_attention B={SERVE_BATCH} S=256 bf16 " + json.dumps(decode_main))
    for b in (1, 64):
        print(f"check decode_attention B={b} S=256 bf16 "
              + json.dumps(check_decode(torch, attention, b, 256, gen, b == 64)))
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
        rc = recon_path(torch, kernels, miniapps, tomo, cluster, ctx, device)
        sv = serve_path(torch, kernels, miniapps, cluster, ctx, device)
    finally:
        svc.cancel()
    rescore(torch, sv)
    launches = {"kmeans_assign": km["launches"]["kmeans_assign"],
                "tomo_backproject": rc["launches"]["tomo_backproject"],
                "tomo_project": rc["launches"]["tomo_project"],
                "flash_attention": sv["launches"]["flash_attention"],
                "decode_attention": sv["launches"]["decode_attention"]}
    print("launches " + json.dumps({"kmeans_path": km["launches"], "lightsource_path": rc["launches"],
                                    "serve_path": sv["launches"]}))
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    src = "src/repro_torch/kernels/csrc/"
    rows = [
        ("kmeans_assign", src + "kmeans_assign.cu", "src/repro/kernels/kmeans/kernel.py:45", assign_main),
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
