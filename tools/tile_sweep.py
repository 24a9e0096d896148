#!/usr/bin/env python3
"""Tile sizes of flash attention (bf16), both projectors, the split
decode kernel and the K-Means assignment's regimes, side by side on one GPU.

    python3 tools/tile_sweep.py [flash] [project] [backproject] [decode] [assign]
        [--parent-decode OTHER/decode_attention.cu]
        [--parent-assign OTHER/kmeans_assign.cu]

(all five parts without arguments). Builds ``flash_attention.cu`` as it is
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
``chip_smoke.assign_close`` first.
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
                    choices=("flash", "project", "backproject", "decode", "assign"))
    ap.add_argument("--parent-decode", type=Path, help="another checkout's decode_attention.cu "
                    "with the one-kernel interface, timed beside the decode builds")
    ap.add_argument("--parent-assign", type=Path, help="another checkout's kmeans_assign.cu "
                    "with the one-regime interface, timed beside the assign builds")
    args = ap.parse_args()
    parts = set(args.parts) or {"flash", "project", "backproject", "decode", "assign"}
    print(cs.card_line())
    flash = {r: _build.CudaKernel(f"flash_attention[rows={r}]", _build.CudaLibrary(
        "flash_attention.cu", attn_ops.FLASH_LIB.signatures,
        () if r == "chosen" else (f"-DFLASH_ROWS={r}",)), "flash_attention") for r in FLASH_ROWS}
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
    libs = [k.library for part, kernels in (("flash", flash), ("project", project),
                                              ("backproject", backproject), ("decode", decode),
                                              ("assign", assign))
            if part in parts for k in kernels.values()]
    for lib, proc in [(lib, lib.start_build()) for lib in libs]:
        lib.finish_build(proc)
    if "assign" in parts:  # registers and spills of each build's kernels (ptxas -v)
        for name, kernel in assign.items():
            log = kernel.library.log_path.read_text()
            print(json.dumps({"kernel": "kmeans_assign", "part": "ptxas", "variant": name,
                              "max_registers": max(map(int, re.findall(r"Used (\d+) registers", log))),
                              "spill_bytes": sum(map(int, re.findall(r"(\d+) bytes spill", log)))}))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    if "flash" in parts:
        sweep_flash(torch, cs, attn, attn_ops, flash, gen)
    if "decode" in parts:
        sweep_decode(torch, cs, attn, attn_ops, decode)
    if "assign" in parts:
        sweep_assign_regimes(torch, cs, kmeans, kmeans_ops, assign["chosen"], gen)
        sweep_assign_builds(torch, cs, kmeans, kmeans_ops, assign, gen)
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
