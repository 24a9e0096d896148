#!/usr/bin/env python3
"""Tile sizes of flash attention (bf16) and its backward, both projectors,
the split decode kernel, the K-Means assignment's regimes and the K-Means
update's, side by side on one GPU.

    python3 tools/tile_sweep.py [flash] [bwd] [project] [backproject] [decode] [assign] [update]
        [--parent-decode OTHER/decode_attention.cu]
        [--parent-assign OTHER/kmeans_assign.cu]
        [--parent-update OTHER/kmeans_update.cu]

(all seven parts without arguments). ``bwd`` builds
``flash_attention_bwd.cu`` as it is (the dK/dV kernel's 2 key warps and 4
warp groups a block) and with other choices of both (``-DBWD_KEY_WARPS``,
``-DBWD_GROUPS``), holds each build's dk and dv to the plain backward
(``chip_smoke``'s per-element rule) and times its ``flash_attention_bwd_dkdv``
in turns, beside ``flash_attention_bwd_dq``, at ``chip_smoke``'s backward
checks' shapes: B=8 S=128 and B=1 S=2048 at 9 heads over 3 KV heads of
64, B=1 S=512 at kimi-k2's 64 over 8 of 112 and phi3.5-moe's 32 over 8 of
128, and at B=8 S=1024 (a grid of many blocks), causal bf16. Builds ``flash_attention.cu`` as it is
(rows per block chosen per launch) and with 32 and with 64 packed query
rows per block fixed (``-DFLASH_ROWS``); ``tomo.cu`` with several (frames
per ``tomo_project`` thread, adjacent angles per block) pairs
(``-DTOMO_FRAMES``, ``-DTOMO_ANGLES``) and several (frames per thread, tile
columns x rows, angles per staged chunk) of ``tomo_backproject``
(``-DTOMO_BP_FRAMES``, ``-DTOMO_BP_TILE_X``, ``-DTOMO_BP_TILE_Y``,
``-DTOMO_BP_ANGLES``); ``decode_attention.cu`` as it is (chunk chosen per
launch) and with fixed chunks (``-DDECODE_CHUNK``), and, with
``--parent-decode``, another checkout's ``decode_attention.cu`` that has
the one-kernel C interface (no workspace, no chunk argument) of the
kernel before the split — all at once, and points the wrappers at each
build in turn (the other checkout's kernel is called through that
interface). Every variant is first held
against the plain version (``chip_smoke``'s per-element rule for
attention, its sum rule for the projectors), then timed at the main
paths' shapes in the order a, b, ..., b, a: flash attention causal bf16, 9
heads over 3 KV heads of 64, at B=1 and S = 64 to 2048 (the slope over S
is the time per 64-key tile of the longest blocks) and at B=4 S=512, and
decode at B = 1, 4 and 64 over S = 256 on ``chip_smoke.decode_inputs``
(the inputs ``chip_smoke.py`` times: fixed positions, a generator of
their own), by device time from a replayed CUDA graph (``chip_smoke.graph_ms``); the
projectors at 8 x 1448^2 <-> 8 x 360 x 1448 by CUDA events around
back-to-back calls (``chip_smoke.time_ms``, the transpose included).
``assign`` first sets the regime thresholds of ``kmeans_assign``: at
shapes around them (f32 and bf16) it runs every regime the entry point takes
for the shape (``assign_cuda`` with a forced ``AssignPlan``), and marks the
one ``assign_plan`` chooses; then it times the builds of
``kmeans_assign.cu`` with other tile sizes (``-DKM_NARROW_PPT``,
``-DKM_NARROW_THREADS``, ``-DKM_WIDE_STAGES``) at the narrow (80 000 x 3 x
10) and wide (65 536 x 128 x 1024) checks' shapes and inputs
(``chip_smoke.assign_inputs``), with ``--parent-assign`` also another
checkout's ``kmeans_assign.cu`` that has the one-regime C interface (no
regime or tile arguments), all by ``graph_ms``, each held to
``chip_smoke.assign_close`` first. ``update`` times ``kmeans_update``: with
``--parent-update``, another checkout's ``kmeans_update.cu`` of the
sorted-input interface (its caller runs ``torch.sort``) in phases, its
launches kept by bits of ``-DPARENT_PHASES`` in a patched copy under
``build/``; then the update's own launches at the checks' shapes (the call
stopped after each, ``update_launch(stop_after=i)``), the partials
regime's block sizes at the K-Means batches' 80 000 x 3 x 10, at
625 000 x 3 x 10 and at two shapes of K*D = 256, and every regime the
entry point takes (and the parent's kernel, with the sorted regime's sums
compared to its bitwise) at (D, K) shapes around ``PARTIALS_MAX_KD``, f32 and bf16,
each held to ``chip_smoke.update_close`` first.
Prints the card line, then one JSON line per (kernel, variant, shape) with
both timings of the variant.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FLASH_ROWS = ("chosen", 32, 64)  # rows per block: the launcher's choice, or fixed
# dK/dV builds: the source's (2 key warps, 4 warp groups), or (key warps,
# warp groups) set; at most 8 warps a block (256 threads: the 255 registers
# hd 128 needs) and at most 4 groups (8 groups' stages at hd 112 pass the
# 227 KB of shared memory)
BWD_VARIANTS = ("chosen", (4, 1), (4, 2), (2, 2), (1, 2), (1, 4))
# (B, S, heads): the backward checks' shapes, and a grid of many blocks
BWD_SHAPES = ((8, 128, (9, 3, 64)), (1, 2048, (9, 3, 64)), (1, 512, (64, 8, 112)),
              (1, 512, (32, 8, 128)), (8, 1024, (9, 3, 64)))
TOMO_VARIANTS = ((8, 1), (4, 4), (8, 4), (8, 8))  # (frames, angles)
FLASH_SHAPES = ((1, 64), (1, 128), (1, 256), (1, 512), (1, 1024), (1, 2048), (4, 512))
# (frames per thread, tile columns, tile rows, angles per staged chunk)
BP_VARIANTS = ((8, 32, 16, 16), (8, 16, 16, 16), (8, 32, 8, 16), (8, 32, 16, 8), (8, 32, 32, 16),
               (4, 32, 16, 16))
# decode builds: the launcher's choice, fixed chunks (256: no split at S=256)
DECODE_VARIANTS = (("chosen", ()), ("chunk=64", ("-DDECODE_CHUNK=64",)),
                   ("chunk=128", ("-DDECODE_CHUNK=128",)), ("chunk=256", ("-DDECODE_CHUNK=256",)))
DECODE_BATCHES = (1, 4, 64)
_P, _I = ctypes.c_void_p, ctypes.c_int
# decode_attention(q, k, v, pos, out, B, S, H, KV, hd, dtype, stream) before the split
PARENT_DECODE_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
# kmeans_assign builds: (name, -D flags, narrow points per block: threads / lanes per group x
# points per group)
ASSIGN_VARIANTS = (("chosen", (), 256), ("narrow ksplit=1", ("-DKM_NARROW_KSPLIT=1",), 512),
                   ("narrow ksplit=4", ("-DKM_NARROW_KSPLIT=4",), 128),
                   ("narrow ppt=2", ("-DKM_NARROW_PPT=2",), 128),
                   ("narrow ppt=8", ("-DKM_NARROW_PPT=8",), 512),
                   ("narrow threads=256", ("-DKM_NARROW_THREADS=256",), 512),
                   ("wide stages=2", ("-DKM_WIDE_STAGES=2",), 256),
                   ("wide chunk=256", ("-DKM_WIDE_CHUNK=256",), 256),
                   ("wide 2 blocks/SM", ("-DKM_WIDE_MIN_BLOCKS=2", "-DKM_WIDE_STAGES=2"), 256))
# (N, D, K) around the regime thresholds (narrow D <= 16 and K*D <= 1024;
# wide D >= 32 and K >= 64), the two checks' shapes, and the chunked
# checks' (D = 20 000, below wide's K = 16)
ASSIGN_THRESHOLD_SHAPES = ((80_000, 3, 10), (80_000, 16, 16), (80_000, 8, 128), (80_000, 16, 64),
                           (80_000, 4, 256), (65_536, 4, 1024), (65_536, 8, 256),
                           (65_536, 16, 128), (65_536, 16, 256), (65_536, 24, 64),
                           (65_536, 24, 128), (65_536, 32, 32), (65_536, 32, 64),
                           (65_536, 64, 32), (65_536, 64, 64), (65_536, 128, 16),
                           (65_536, 128, 32), (65_536, 128, 64), (65_536, 32, 1024),
                           (65_536, 128, 1024), (4096, 20_000, 2), (4096, 20_000, 15))
ASSIGN_TILE_SHAPES = ((80_000, 3, 10, "f32", True), (65_536, 128, 1024, "f32", False),
                      (65_536, 128, 1024, "bf16", False))
# kmeans_assign(points, centroids, labels, dist, n, k, d, dtype, stream) before the regimes
PARENT_ASSIGN_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
# kmeans_update(points, sorted_labels, order, weights, starts, part, sums, counts, n, k, d,
# dtype, seg_rows, stream) before the counting sort: its caller sorted the labels
PARENT_UPDATE_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
# the parent's three launches; a patched copy keeps launch i where bit i of -DPARENT_PHASES is set
PARENT_UPDATE_LAUNCHES = ("run_starts<<<", "segment_sums<T><<<", "merge_runs<<<")
# (N, D, K, clustered): the chip_smoke checks' shapes (labels from kmeans_assign; the wide one
# on standard normals here, on clustered points there)
UPDATE_CHECK_SHAPES = ((80_000, 3, 10, True), (65_536, 128, 1024, False))
# (D, K) around the update's regime threshold (partials takes K*D <= 256), at N = 65 536
UPDATE_THRESHOLD_SHAPES = ((3, 10), (3, 32), (3, 64), (3, 85), (3, 86), (3, 256), (3, 1024),
                           (1, 64), (1, 256), (1, 1024), (8, 8), (8, 32), (8, 64), (16, 4),
                           (16, 16), (16, 64), (32, 8), (64, 4), (128, 2), (128, 8), (128, 64),
                           (128, 1024))
# partials block sizes: (least rows a block, most blocks)
UPDATE_PARTIALS_SIZES = ((256, 256), (640, 1024), (320, 2048), (1280, 512), (640, 128),
                         (2560, 256))
# (N, D, K) the partials block sizes are timed at: the K-Means batches (16 messages of 5000
# points), 125 such messages (five times a continuous window's 25), and K*D = 256 (one group)
UPDATE_PARTIALS_SHAPES = ((80_000, 3, 10), (625_000, 3, 10), (65_536, 1, 256),
                          (65_536, 16, 16))


@contextmanager
def swapped(module, name: str, kernel):
    """``module.name`` replaced by ``kernel`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, kernel)
    try:
        yield
    finally:
        setattr(module, name, old)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("tile_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as attn
    from repro_torch.kernels import kmeans, tomo
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.kmeans import ops as kmeans_ops
    from repro_torch.kernels.tomo import ops as tomo_ops

    ap = argparse.ArgumentParser(description="tile sizes of the port's kernels, side by side")
    ap.add_argument("parts", nargs="*",
                    choices=("flash", "bwd", "project", "backproject", "decode", "assign",
                             "update"))
    ap.add_argument("--parent-decode", type=Path, help="another checkout's decode_attention.cu "
                    "with the one-kernel interface, timed beside the decode builds")
    ap.add_argument("--parent-assign", type=Path, help="another checkout's kmeans_assign.cu "
                    "with the one-regime interface, timed beside the assign builds")
    ap.add_argument("--parent-update", type=Path, help="another checkout's kmeans_update.cu "
                    "with the sorted-input interface, timed in phases beside the update")
    args = ap.parse_args()
    parts = set(args.parts) or {"flash", "bwd", "project", "backproject", "decode", "assign",
                                "update"}
    print(cs.card_line())
    flash = {r: _build.CudaKernel(f"flash_attention[rows={r}]", _build.CudaLibrary(
        "flash_attention.cu", attn_ops.FLASH_LIB.signatures,
        () if r == "chosen" else (f"-DFLASH_ROWS={r}",)), "flash_attention") for r in FLASH_ROWS}
    bwd = {var: _build.CudaKernel(f"flash_attention_bwd_dkdv[{var}]", _build.CudaLibrary(
        "flash_attention_bwd.cu", attn_ops.FLASH_BWD_LIB.signatures,
        () if var == "chosen" else (f"-DBWD_KEY_WARPS={var[0]}", f"-DBWD_GROUPS={var[1]}")),
        "flash_attention_bwd_dkdv") for var in BWD_VARIANTS}
    project = {(f, a): _build.CudaKernel(f"tomo_project[frames={f},angles={a}]", _build.CudaLibrary(
        "tomo.cu", tomo_ops.TOMO_LIB.signatures, (f"-DTOMO_FRAMES={f}", f"-DTOMO_ANGLES={a}")),
        "tomo_project") for f, a in TOMO_VARIANTS}
    backproject = {var: _build.CudaKernel(f"tomo_backproject[{var}]", _build.CudaLibrary(
        "tomo.cu", tomo_ops.TOMO_LIB.signatures,
        tuple(f"-DTOMO_BP_{k}={x}" for k, x in zip(("FRAMES", "TILE_X", "TILE_Y", "ANGLES"), var))),
        "tomo_backproject") for var in BP_VARIANTS}
    decode = {name: _build.CudaKernel(f"decode_attention[{name}]", _build.CudaLibrary(
        "decode_attention.cu", attn_ops.DECODE_LIB.signatures, flags), "decode_attention")
        for name, flags in DECODE_VARIANTS}
    if args.parent_decode:
        decode["parent"] = _build.CudaKernel("decode_attention[parent]", _build.CudaLibrary(
            str(args.parent_decode.resolve()), {"decode_attention": PARENT_DECODE_ARGS}),
            "decode_attention")
    assign = {name: _build.CudaKernel(f"kmeans_assign[{name}]", _build.CudaLibrary(
        "kmeans_assign.cu", kmeans_ops.KMEANS_LIB.signatures, flags), "kmeans_assign")
        for name, flags, _ in ASSIGN_VARIANTS}
    if args.parent_assign:
        assign["parent"] = _build.CudaKernel("kmeans_assign[parent]", _build.CudaLibrary(
            str(args.parent_assign.resolve()), {"kmeans_assign": PARENT_ASSIGN_ARGS}),
            "kmeans_assign")
    parent_update = (_parent_update_kernels(args.parent_update.resolve())
                     if args.parent_update and "update" in parts else {})
    libs = [k.library for part, kernels in (("flash", flash), ("bwd", bwd), ("project", project),
                                              ("backproject", backproject), ("decode", decode),
                                              ("assign", assign), ("update", parent_update))
            if part in parts for k in kernels.values()]
    if "update" in parts:
        libs.append(kmeans_ops.KMEANS_UPDATE_LIB)
    for lib, proc in [(lib, lib.start_build()) for lib in libs]:
        lib.finish_build(proc)
    for part, kernels in (("assign", assign), ("bwd", bwd)):  # registers and spills (ptxas -v)
        if part not in parts:
            continue
        for name, kernel in kernels.items():
            log = kernel.library.log_path.read_text()
            print(json.dumps({"kernel": kernel.name, "part": "ptxas", "variant": str(name),
                              "max_registers": max(map(int, re.findall(r"Used (\d+) registers", log))),
                              "spill_bytes": sum(map(int, re.findall(r"(\d+) bytes spill", log)))}))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    if "flash" in parts:
        sweep_flash(torch, cs, attn, attn_ops, flash, gen)
    if "bwd" in parts:
        sweep_bwd(torch, cs, attn, attn_ops, bwd, gen)
    if "decode" in parts:
        sweep_decode(torch, cs, attn, attn_ops, decode)
    if "assign" in parts:
        sweep_assign_regimes(torch, cs, kmeans, kmeans_ops, assign["chosen"], gen)
        sweep_assign_builds(torch, cs, kmeans, kmeans_ops, assign, gen)
    if "update" in parts:
        if parent_update:
            sweep_update_parent(torch, cs, kmeans, parent_update, gen)
        sweep_update_phases(torch, cs, kmeans, kmeans_ops, gen)
        sweep_update_sizes(torch, cs, kmeans, kmeans_ops, gen)
        sweep_update_regimes(torch, cs, kmeans, kmeans_ops, parent_update.get(7), gen)
    a, n_det, n = cs.FRAME_ANGLES, cs.FRAME_BINS, cs.RECON_N
    cos_t, sin_t = tomo.trig(torch.from_numpy(tomo.angle_grid(a)).to(dev))
    if "project" in parts:
        imgs = torch.rand((8, n, n), generator=gen, device=dev)
        sweep_tomo(torch, cs, tomo_ops, "TOMO_PROJECT", project,
                   lambda: tomo_ops.project_cuda(imgs, cos_t, sin_t, n_det),
                   tomo.project_plain(imgs, cos_t, sin_t, n_det), 4 * n,
                   ("frames_per_thread", "angles_per_block"))
    if "backproject" in parts:
        sinos = torch.rand((8, a, n_det), generator=gen, device=dev)
        sweep_tomo(torch, cs, tomo_ops, "TOMO_BACKPROJECT", backproject,
                   lambda: tomo_ops.backproject_cuda(sinos, cos_t, sin_t, n),
                   tomo.backproject_plain(sinos, cos_t, sin_t, n), a,
                   ("frames_per_thread", "tile_x", "tile_y", "angles_per_chunk"))


def sweep_flash(torch, cs, attn, attn_ops, flash, gen) -> None:
    dev = torch.device("cuda", 0)
    for b, s in FLASH_SHAPES:
        q = torch.randn((b, s, cs.HEADS, cs.HEAD_DIM), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, s, cs.KV_HEADS, cs.HEAD_DIM), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, s, cs.KV_HEADS, cs.HEAD_DIM), generator=gen, device=dev).bfloat16()
        ref = attn.flash_attention_plain(q, k, v, causal=True)
        run = lambda: attn_ops.flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
        res = {}
        for r in FLASH_ROWS:
            with swapped(attn_ops, "FLASH_ATTENTION", flash[r]):
                res[r] = cs._bf16_close(torch, f"flash rows={r} B={b} S={s}", run(), ref, v)
                res[r]["ms"] = []
        for r in (*FLASH_ROWS, *reversed(FLASH_ROWS)):
            with swapped(attn_ops, "FLASH_ATTENTION", flash[r]):
                res[r]["ms"].append(cs.graph_ms(torch, run, 50))
        for r in FLASH_ROWS:
            print(json.dumps({"kernel": "flash_attention", "rows_per_block": r, "B": b, "S": s,
                              **res[r]}))


def sweep_bwd(torch, cs, attn, attn_ops, bwd, gen) -> None:
    """Each dK/dV build at the backward checks' shapes: dk and dv held to the
    plain backward per element (on the delta the chosen dq kernel wrote),
    then every build's dkdv timed in turns, and the dq kernel once."""
    dev = torch.device("cuda", 0)
    for b, s, (H, KV, hd) in BWD_SHAPES:
        q, dout = (torch.randn((b, s, H, hd), generator=gen, device=dev).bfloat16()
                   for _ in range(2))
        k, v = (torch.randn((b, s, KV, hd), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        lse = torch.empty((b, H, s), dtype=torch.float32, device=dev)
        out = attn_ops.flash_attention_cuda(q, k, v, causal=True, lse=lse)
        dq, _, _ = attn_ops.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        ref = attn.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True)
        delta = torch.empty((b, H, s), dtype=torch.float32, device=dev)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        sizes = (b, s, s, H, KV, hd, 1, 0, 1)  # causal, q_offset 0, bf16

        def run_dq():
            attn_ops.FLASH_BWD_DQ.launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *sizes,
                torch.cuda.current_stream().cuda_stream)

        run_dq()
        runs = {var: (lambda kernel=kernel: kernel.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *sizes,
            torch.cuda.current_stream().cuda_stream)) for var, kernel in bwd.items()}
        res = {}
        for var, run in runs.items():
            run()
            torch.cuda.synchronize()
            res[var] = cs._grads_worst(torch, (dq, dk, dv), ref)
            if max(res[var].values()) > 1:
                raise AssertionError(f"bwd {var} B={b} S={s} hd={hd}: worst err/tol {res[var]}")
        reps = 20 if s <= 512 else 10
        ms = _time_in_turns(cs, torch, runs, reps)
        dq_ms = cs.graph_ms(torch, run_dq, reps)
        for var in runs:
            print(json.dumps({"kernel": "flash_attention_bwd_dkdv", "variant": str(var), "B": b,
                              "S": s, "heads": [H, KV, hd], "worst_err_over_tol": res[var],
                              "ms": ms[var], "dq_ms": dq_ms}))


def sweep_decode(torch, cs, attn, attn_ops, decode) -> None:
    """Each decode build at B = 1, 4, 64 over S = 256, on the inputs
    ``chip_smoke.py`` times: held to the per-element rule, then timed in
    turns."""
    dev = torch.device("cuda", 0)
    s = 256
    for b in DECODE_BATCHES:
        q, k, v, pos = cs.decode_inputs(torch, b, s)
        ref = attn.decode_attention_plain(q, k, v, pos)
        runs = {}
        for name, kernel in decode.items():
            if name == "parent":
                runs[name] = lambda kernel=kernel: _parent_decode(torch, kernel, q, k, v, pos)
            else:
                runs[name] = lambda kernel=kernel: _with_kernel(
                    attn_ops, kernel, lambda: attn_ops.decode_attention_cuda(q, k, v, pos))
        res = {}
        for name, run in runs.items():
            res[name] = cs._bf16_close(torch, f"decode {name} B={b}", run(), ref, v)
            if name != "parent":
                res[name]["chunk"] = attn_ops.decode_chunk(decode[name].library, dev, b, s,
                                                           cs.HEADS, cs.KV_HEADS, cs.HEAD_DIM, 1)
            res[name]["ms"] = []
        for name in (*runs, *reversed(runs)):
            res[name]["ms"].append(cs.graph_ms(torch, runs[name], 100))
        for name in runs:
            print(json.dumps({"kernel": "decode_attention", "variant": name, "B": b, "S": s,
                              "positions": pos[:6].tolist(), **res[name]}))


def _with_kernel(module, kernel, fn):
    with swapped(module, "DECODE_ATTENTION", kernel):
        return fn()


def _parent_decode(torch, kernel, q, k, v, pos):
    """The kernel before the split, through its own C interface."""
    B, _, H, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(), B,
                  k.shape[1], H, k.shape[2], hd, 1, stream)
    return out


def _assign_plans(k_ops, d: int, k: int, dtype, narrow_points: int = ASSIGN_VARIANTS[0][2]) -> dict:
    """Every regime the entry point takes for (D, K), with the default tile
    sizes but ``narrow_points`` per narrow block (the entry point checks
    ``tile_n`` alone of the narrow plan's sizes)."""
    plans = {"wide": k_ops.AssignPlan(
        "wide", k_ops.WIDE_THREADS, k_ops.WIDE_POINTS, k_ops.WIDE_CENTROIDS,
        k_ops.WIDE_CHUNK_BYTES // (2 if dtype == "bf16" else 4))}
    if d <= k_ops.NARROW_MAX_D and k * d <= k_ops.NARROW_MAX_CD:
        plans["narrow"] = k_ops.AssignPlan("narrow", k_ops.NARROW_THREADS, narrow_points, k, d,
                                           k_ops.NARROW_POINTS_PER_THREAD, k_ops.NARROW_K_SPLIT)
    tile_k = min(k, k_ops.GENERIC_SMEM_BYTES // ((d + 1) * 4))
    if tile_k >= 1:
        plans["generic"] = k_ops.AssignPlan("generic", k_ops.GENERIC_THREADS,
                                            k_ops.GENERIC_THREADS, tile_k, d)
    else:  # no centroid row fits 48 KB: the chunked regime, wide beside it
        import torch

        plans["chunked"] = k_ops.assign_plan(d, k, torch.float32 if dtype == "f32"
                                             else torch.bfloat16)
    return plans


def _time_in_turns(cs, torch, runs: dict, reps: int) -> dict:
    """``graph_ms`` of each run in the order a, b, ..., b, a."""
    ms = {name: [] for name in runs}
    for name in (*runs, *reversed(runs)):
        ms[name].append(cs.graph_ms(torch, runs[name], reps))
    return ms


def sweep_assign_regimes(torch, cs, kmeans, k_ops, kernel, gen) -> None:
    """Each regime the entry point takes, at shapes around the thresholds."""
    for n, d, k in ASSIGN_THRESHOLD_SHAPES:
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            points, centroids = cs.assign_inputs(torch, n, d, k, dtype, False, gen)
            plans = _assign_plans(k_ops, d, k, name)
            runs, res = {}, {}
            with swapped(k_ops, "KMEANS_ASSIGN", kernel):
                for regime, plan in plans.items():
                    runs[regime] = lambda plan=plan: k_ops.assign_cuda(points, centroids, plan)
                    res[regime] = cs.assign_close(torch, kmeans, f"kmeans_assign {regime}", points,
                                                  centroids, *runs[regime]())
                ms = _time_in_turns(cs, torch, runs, 20)
            chosen = k_ops.assign_plan(d, k, dtype).regime
            for regime in plans:
                print(json.dumps({"kernel": "kmeans_assign", "part": "regimes", "N": n, "D": d,
                                  "K": k, "dtype": name, "regime": regime,
                                  "chosen": regime == chosen, "ms": ms[regime],
                                  "worst_err_over_tol": res[regime]["worst_err_over_tol"]}))


def sweep_assign_builds(torch, cs, kmeans, k_ops, builds: dict, gen) -> None:
    """Each build of ``kmeans_assign.cu`` (and the parent's) at the checks'
    shapes and inputs, in the regime ``assign_plan`` chooses."""
    narrow_points = {name: pts for name, _, pts in ASSIGN_VARIANTS}
    for n, d, k, name, clustered in ASSIGN_TILE_SHAPES:
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[name]
        points, centroids = cs.assign_inputs(torch, n, d, k, dtype, clustered, gen)
        regime = k_ops.assign_plan(d, k, dtype).regime
        runs, res = {}, {}
        for var, kernel in builds.items():
            if var == "parent":
                runs[var] = lambda kernel=kernel: _parent_assign(torch, kernel, points, centroids)
            else:
                plan = _assign_plans(k_ops, d, k, name, narrow_points[var])[regime]
                runs[var] = lambda kernel=kernel, plan=plan: _with_assign(
                    k_ops, kernel, lambda: k_ops.assign_cuda(points, centroids, plan))
            res[var] = cs.assign_close(torch, kmeans, f"kmeans_assign[{var}]", points, centroids,
                                       *runs[var]())
        ms = _time_in_turns(cs, torch, runs, 50)
        if regime == "narrow":  # what moving these bytes costs at all, beside the least kernel
            copy = torch.empty_like(points)
            refs = {"launch_floor": cs.launch_floor_ms(torch),
                    "copy_points": cs.graph_ms(torch, lambda: copy.copy_(points), 50),
                    "sum_points_dim1": cs.graph_ms(torch, lambda: points.sum(1), 50)}
            print(json.dumps({"kernel": "kmeans_assign", "part": "reference", "N": n, "D": d,
                              "dtype": name, **refs}))
        for var in runs:
            print(json.dumps({"kernel": "kmeans_assign", "part": "builds", "variant": var, "N": n,
                              "D": d, "K": k, "dtype": name, "regime": regime, "ms": ms[var],
                              "worst_err_over_tol": res[var]["worst_err_over_tol"]}))


def _with_assign(k_ops, kernel, fn):
    with swapped(k_ops, "KMEANS_ASSIGN", kernel):
        return fn()


def _parent_assign(torch, kernel, points, centroids):
    """The kernel before the regimes, through its own C interface."""
    n, d = points.shape
    labels = torch.empty((n,), dtype=torch.int32, device=points.device)
    dist = torch.empty((n,), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    kernel.launch(points.data_ptr(), centroids.data_ptr(), labels.data_ptr(), dist.data_ptr(), n,
                  centroids.shape[0], d, 1 if points.dtype == torch.bfloat16 else 0, stream)
    return labels, dist


def _parent_update_kernels(source: Path) -> dict:
    """The parent's ``kmeans_update.cu``, copied under ``build/`` with each
    launch behind a bit of ``PARENT_PHASES``, built with the first launch,
    the first two and all three."""
    from repro_torch.kernels import _build

    text = source.read_text()
    for i, launch in enumerate(PARENT_UPDATE_LAUNCHES):
        if text.count(launch) != 1:
            raise ValueError(f"{source}: want one '{launch}', found {text.count(launch)}")
        text = text.replace(launch, f"if (PARENT_PHASES & {1 << i}) {launch}")
    copy = ROOT / "build" / "parent_update" / "kmeans_update_phases.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text)
    return {phases: _build.CudaKernel(
        f"kmeans_update[parent, phases {phases}]", _build.CudaLibrary(
            str(copy), {"kmeans_update": PARENT_UPDATE_ARGS}, (f"-DPARENT_PHASES={phases}",)),
        "kmeans_update") for phases in (1, 3, 7)}


def _parent_update(torch, kernel, points, labels, k: int, pre=None):
    """The parent's update through its own C interface: ``torch.sort`` of the
    labels (or ``pre``, a sort made before), then its launches."""
    n, d = points.shape
    sorted_labels, order = pre if pre is not None else torch.sort(labels, stable=True)
    cols = 1
    while cols < d and cols < 32:
        cols *= 2
    seg_rows = 8 * (256 // cols)
    dev = points.device
    starts = torch.empty((k + 1,), dtype=torch.int32, device=dev)
    part = torch.empty((2 * max(-(-n // seg_rows), 1), d + 1), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    kernel.launch(points.data_ptr(), sorted_labels.data_ptr(), order.data_ptr(), 0,
                  starts.data_ptr(), part.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, k, d,
                  1 if points.dtype == torch.bfloat16 else 0, seg_rows,
                  torch.cuda.current_stream(dev).cuda_stream)
    return sums, counts


def _update_plans(k_ops, d: int, k: int, dtype) -> dict:
    """Every regime the entry point takes for (D, K): ``sorted`` always,
    ``partials`` where K*D <= 256."""
    regimes = ("sorted", "partials") if k * d <= k_ops.UPDATE_THREADS else ("sorted",)
    return {regime: k_ops.update_plan(d, k, dtype, regime) for regime in regimes}


def _update_labels(torch, cs, kmeans, n, d, k, dtype, clustered, gen):
    """Points and their ``kmeans_assign`` labels, as ``chip_smoke.check_update`` makes them."""
    points, centroids = cs.assign_inputs(torch, n, d, k, dtype, clustered, gen)
    return points, kmeans.assign_cuda(points, centroids)[0]


def sweep_update_regimes(torch, cs, kmeans, k_ops, parent, gen) -> None:
    """Each regime the entry point takes (and the parent's kernel, where
    given) at shapes around the threshold, f32 and bf16, held to
    ``chip_smoke.update_close`` and timed in turns; ``chosen`` marks
    ``update_plan``'s pick: this sets ``PARTIALS_MAX_KD``."""
    for d, k in UPDATE_THRESHOLD_SHAPES:
        n = 80_000 if (d, k) == (3, 10) else 65_536
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            points, labels = _update_labels(torch, cs, kmeans, n, d, k, dtype, d <= 16, gen)
            runs = {regime: lambda plan=plan: k_ops.update_launch(points, labels, k, plan=plan)
                    for regime, plan in _update_plans(k_ops, d, k, dtype).items()}
            if parent is not None:
                runs["parent"] = lambda: _parent_update(torch, parent, points, labels, k)
            res = {var: cs.update_close(torch, f"kmeans_update {var}", run, points, labels, k)
                   for var, run in runs.items()}
            if parent is not None:  # the sorted regime keeps the parent's order of every sum
                sums, counts = runs["sorted"]()
                p_sums, p_counts = runs["parent"]()
                res["sorted"]["bitwise_parent"] = bool(torch.equal(sums, p_sums)
                                                       and torch.equal(counts, p_counts))
            ms = _time_in_turns(cs, torch, runs, 20)
            chosen = k_ops.update_plan(d, k, dtype).regime
            for var in runs:
                print(json.dumps({"kernel": "kmeans_update", "part": "regimes", "N": n, "D": d,
                                  "K": k, "dtype": name, "regime": var, "chosen": var == chosen,
                                  "ms": ms[var], **res[var]}))


def sweep_update_sizes(torch, cs, kmeans, k_ops, gen) -> None:
    """The partials regime's block sizes (least rows a block, most blocks)
    at ``UPDATE_PARTIALS_SHAPES``, f32 and bf16, each held to
    ``chip_smoke.update_close`` and timed in turns."""
    import dataclasses

    for n, d, k in UPDATE_PARTIALS_SHAPES:
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            points, labels = _update_labels(torch, cs, kmeans, n, d, k, dtype, True, gen)
            plan = k_ops.update_plan(d, k, dtype)
            variants = {(rows, blocks): dataclasses.replace(plan, min_rows=rows,
                                                            max_blocks=blocks)
                        for rows, blocks in UPDATE_PARTIALS_SIZES}
            runs = {key: lambda var=var: k_ops.update_launch(points, labels, k, plan=var)
                    for key, var in variants.items()}
            res = {key: cs.update_close(torch, f"kmeans_update {key}", run, points, labels, k)
                   for key, run in runs.items()}
            ms = _time_in_turns(cs, torch, runs, 50)
            for (rows, blocks), var in variants.items():
                print(json.dumps({"kernel": "kmeans_update", "part": "partials sizes", "N": n,
                                  "D": d, "K": k, "dtype": name, "min_rows": rows,
                                  "max_blocks": blocks, "block_rows": var.block_rows(n),
                                  "ms": ms[(rows, blocks)], "worst_err_over_tol":
                                  res[(rows, blocks)]["worst_err_over_tol"]}))


def sweep_update_phases(torch, cs, kmeans, k_ops, gen) -> None:
    """The update in phases at the checks' shapes (f32), in the regime
    ``update_plan`` chooses (``chip_smoke.update_phase_ms``: the call
    stopped after each launch, less the call stopped before it)."""
    for n, d, k, clustered in UPDATE_CHECK_SHAPES:
        points, labels = _update_labels(torch, cs, kmeans, n, d, k, torch.float32, clustered,
                                        gen)
        phases = cs.update_phase_ms(torch, kmeans, points, labels, k)
        print(json.dumps({"kernel": "kmeans_update", "part": "phases", "N": n, "D": d, "K": k,
                          "dtype": "f32", "regime": k_ops.update_plan(d, k, torch.float32).regime,
                          "phase_ms": phases, "call_ms": cs.graph_ms(
                              torch, lambda: k_ops.update_cuda(points, labels, k), 20)}))


def sweep_update_parent(torch, cs, kmeans, kernels: dict, gen) -> None:
    """The parent's update in phases at the checks' shapes (f32): its
    ``torch.sort`` alone; the whole call built with its first launch
    (``run_starts``), its first two (+ ``segment_sums``) and all three (+
    ``merge_runs``), with the sort and with the sort made before; the
    full build held to ``chip_smoke.update_close`` first. Beside them the
    launch floor and one ``index_add_``."""
    floor = cs.launch_floor_ms(torch)
    for n, d, k, clustered in UPDATE_CHECK_SHAPES:
        points, labels = _update_labels(torch, cs, kmeans, n, d, k, torch.float32, clustered,
                                        gen)
        full = kernels[7]
        res = cs.update_close(torch, "kmeans_update[parent]",
                              lambda: _parent_update(torch, full, points, labels, k),
                              points, labels, k)
        pre = torch.sort(labels, stable=True)
        runs = {"sort": lambda: torch.sort(labels, stable=True)}
        for phases, kernel in kernels.items():
            runs[f"call {phases}"] = lambda kernel=kernel: _parent_update(
                torch, kernel, points, labels, k)
            runs[f"kernels {phases}"] = lambda kernel=kernel: _parent_update(
                torch, kernel, points, labels, k, pre)
        ms = _time_in_turns(cs, torch, runs, 20)
        idx, zeros = labels.long(), torch.zeros((k, d), device=points.device)
        library = cs.graph_ms(torch, lambda: zeros.index_add_(0, idx, points), 20)
        mean = {name: sum(v) / len(v) for name, v in ms.items()}
        print(json.dumps({
            "kernel": "kmeans_update", "part": "parent phases", "N": n, "D": d, "K": k,
            "dtype": "f32", "ms": ms, "sort_ms": mean["sort"],
            "run_starts_ms": mean["kernels 1"],
            "segment_sums_ms": mean["kernels 3"] - mean["kernels 1"],
            "merge_runs_ms": mean["kernels 7"] - mean["kernels 3"],
            "call_ms": mean["call 7"], "launch_floor_ms": floor, "index_add_ms": library,
            "worst_err_over_tol": res["worst_err_over_tol"]}))


def sweep_tomo(torch, cs, tomo_ops, attr: str, kernels: dict, run, ref, terms: int,
               keys: tuple[str, ...]) -> None:
    """Each build of one projector held to the sum rule (``terms`` f32 terms
    in two orders) against ``ref``, then timed in turns."""
    tol = terms * cs.F32_EPS * float(ref.abs().max())
    res = {}
    for var, kernel in kernels.items():
        with swapped(tomo_ops, attr, kernel):
            err = float((run() - ref).abs().max())
            if err > tol:
                raise AssertionError(f"{kernel.name}: max err {err} > tol {tol}")
            res[var] = {"max_abs_err": err, "tol": tol, "ms": []}
    for var in (*kernels, *reversed(kernels)):
        with swapped(tomo_ops, attr, kernels[var]):
            res[var]["ms"].append(cs.time_ms(torch, run, 5, 1))
    for var in kernels:
        print(json.dumps({"kernel": attr.lower(), **dict(zip(keys, var)), "B": 8,
                          "n": cs.RECON_N, **res[var]}))


if __name__ == "__main__":
    main()
