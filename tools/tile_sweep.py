#!/usr/bin/env python3
"""Tile sizes of flash attention (bf16) and the forward projector, side by
side on one GPU.

    python3 tools/tile_sweep.py

Builds ``flash_attention.cu`` as it is (rows per block chosen per launch)
and with 32 and with 64 packed query rows per block fixed
(``-DFLASH_ROWS``), and ``tomo.cu`` with several (frames per
``tomo_project`` thread, adjacent angles per block) pairs (``-DTOMO_FRAMES``,
``-DTOMO_ANGLES``), all at once, and points the
wrappers at each build in turn. Every variant is first held against the
plain version (``chip_smoke``'s per-element rule for attention, its sum
rule for the projector), then timed at the main paths' shapes in the order
a, b, ..., b, a: flash attention causal bf16, 9 heads over 3 KV heads of 64, at
B=1 and S = 64 to 2048 (the slope over S is the time per 64-key tile of
the longest blocks) and at B=4 S=512, by device time from a replayed CUDA
graph (``chip_smoke.graph_ms``); ``tomo_project`` at 8 x 1448^2 -> 8 x 360
x 1448 by CUDA events around back-to-back calls (``chip_smoke.time_ms``,
the transpose included). Prints the card line, then one JSON line per
(kernel, variant, shape) with both timings of the variant.
"""
from __future__ import annotations

import json
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FLASH_ROWS = ("chosen", 32, 64)  # rows per block: the launcher's choice, or fixed
TOMO_VARIANTS = ((8, 1), (4, 4), (8, 4), (8, 8))  # (frames, angles)
FLASH_SHAPES = ((1, 64), (1, 128), (1, 256), (1, 512), (1, 1024), (1, 2048), (4, 512))


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
    from repro_torch.kernels import tomo
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.tomo import ops as tomo_ops

    print(cs.card_line())
    flash = {r: _build.CudaKernel(f"flash_attention[rows={r}]", _build.CudaLibrary(
        "flash_attention.cu", attn_ops.FLASH_LIB.signatures,
        () if r == "chosen" else (f"-DFLASH_ROWS={r}",)), "flash_attention") for r in FLASH_ROWS}
    project = {(f, a): _build.CudaKernel(f"tomo_project[frames={f},angles={a}]", _build.CudaLibrary(
        "tomo.cu", tomo_ops.TOMO_LIB.signatures, (f"-DTOMO_FRAMES={f}", f"-DTOMO_ANGLES={a}")),
        "tomo_project") for f, a in TOMO_VARIANTS}
    libs = [k.library for k in (*flash.values(), *project.values())]
    for lib, proc in [(lib, lib.start_build()) for lib in libs]:
        lib.finish_build(proc)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
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

    a, n_det, n = cs.FRAME_ANGLES, cs.FRAME_BINS, cs.RECON_N
    cos_t, sin_t = tomo.trig(torch.from_numpy(tomo.angle_grid(a)).to(dev))
    imgs = torch.rand((8, n, n), generator=gen, device=dev)
    ref = tomo.project_plain(imgs, cos_t, sin_t, n_det)
    tol = 4 * n * cs.F32_EPS * float(ref.abs().max())
    run = lambda: tomo_ops.project_cuda(imgs, cos_t, sin_t, n_det)  # noqa: E731
    res = {}
    for var in TOMO_VARIANTS:
        with swapped(tomo_ops, "TOMO_PROJECT", project[var]):
            err = float((run() - ref).abs().max())
            if err > tol:
                raise AssertionError(f"tomo_project {var}: max err {err} > tol {tol}")
            res[var] = {"max_abs_err": err, "tol": tol, "ms": []}
    for var in (*TOMO_VARIANTS, *reversed(TOMO_VARIANTS)):
        with swapped(tomo_ops, "TOMO_PROJECT", project[var]):
            res[var]["ms"].append(cs.time_ms(torch, run, 5, 1))
    for (f, a) in TOMO_VARIANTS:
        print(json.dumps({"kernel": "tomo_project", "frames_per_thread": f, "angles_per_block": a,
                          "B": 8, "n": n, **res[(f, a)]}))


if __name__ == "__main__":
    main()
