"""Dry run of the production meshes: trace one rank's step of every
(arch x shape x mesh) cell, with no card and no compiler.

Own counterpart of the JAX package's ``launch/dryrun.py``. The reference
compiles each cell for 256 (single pod, 16 x 16 ("data", "model")) or 512
(2 x 16 x 16 ("pod", "data", "model")) fake CPU devices and reads the
compiled program's memory and HLO. Here each traced rank is this process:
a ``fake`` process group (``torch.testing._internal.distributed.fake_pg``,
whose collectives return at once and stage nothing through host memory) of
the mesh's world size, at that rank, the mesh built over it by
``launch/mesh.py``'s ``make_mesh``, the step built by ``runtime/steps.py``'s
``build_step`` and run once under fake tensors and the cost counter
(``runtime/cost_analysis.py``). For each cell it proves, without hardware,
that the step's tiles split and its collectives line up, and records:

* ``memory`` and ``peak_bytes_per_device``: the rank's inputs, outputs and
  most live tensor storage (does it fit one 80 GB card?);
* ``cost_analysis`` and ``hlo``: the traced FLOPs, bytes and collectives
  (what bounds the step: compute, HBM or collectives, ``launch/roofline.py``).

Two ranks are traced a cell: the mesh's origin and the last rank of
"model", the lightest and the heaviest causal shard; both are recorded
(``ranks``) and the cell's numbers are the heavier one's (the one with
more FLOPs), since the step waits for the slowest rank. The process group
is process-wide, so the dry run owns its process, as the reference's owns
its process through ``XLA_FLAGS``; callers run it in a subprocess.

``cell_supported``'s skips come first (long_500k's quadratic archs); any
failure of a cell is an error and ``main`` exits 1.

The Mini-App streams are cells too (:data:`MINIAPP_CELLS`, in ``--all``
after the LM grid, or by ``--arch`` and ``--shape``): one batch of each
stream's processing as ``chip_smoke.py`` drives it, on one device (mesh
``1``), traced the same way: a K-Means batch (``minibatch_update``: the
``kmeans_assign`` and ``kmeans_update`` ops and the decayed centroids),
narrow (16 messages of 5000 x 3 points, 10 centres) and wide (16 of 4096 x
128, 1024 centres); a GridRec and an ML-EM batch (``gridrec_batch``,
``mlem_batch`` at the app's 4 iterations: the ``tomo_backproject`` and
``tomo_project`` ops) of 8 frames of 360 x 1448 into 1448 x 1448 images.
Each record states the batch's FLOPs (the kernels' formulas), bytes and
peak live bytes on the device, under the LM cells' keys, with ``kind``
``stream`` and the kernels' compute ``dtype``.

It traces the card's path (fake ``cuda`` tensors) unless ``--device cpu``
is given. It never touches a GPU, but indexing a fake ``cuda`` tensor needs
a PyTorch built with CUDA: on a CPU-only build pass ``--device cpu``, which
traces the same code on fake CPU tensors (only the peak's rounding to the
CUDA allocator's 512-byte blocks differs).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mlem --shape 360x1448 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out out.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch.configs.registry import all_cells, cell_supported, get_arch, get_shape
from repro_torch.models import build_model
from repro_torch.runtime.steps import build_step

PRODUCTION = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def mesh_name(shape: tuple) -> str:
    return "x".join(str(s) for s in shape)


def trace_rank(model, shape, mesh_shape: tuple, axes: tuple, rank: int,
               device: str = "cuda") -> dict:
    """One rank's step of the cell under a fake process group: its record
    entries."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    from repro_torch.launch.mesh import make_mesh

    world = 1
    for s in mesh_shape:
        world *= s
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        mesh = make_mesh(mesh_shape, axes, device=device)
        bundle = build_step(model, shape, mesh=mesh)
        _, cost = bundle.trace(device=device)
    finally:
        dist.destroy_process_group()
    alias = cost.alias_bytes
    memory = {
        "argument_bytes": int(cost.input_bytes),
        "output_bytes": int(cost.output_bytes),
        "temp_bytes": int(cost.peak_bytes - cost.input_bytes - cost.output_bytes + alias),
        "alias_bytes": int(alias),
    }
    return {
        "rank": rank,
        "coords": mesh.coords(),
        "memory": memory,
        "peak_bytes_per_device": int(cost.peak_bytes),
        "cost_analysis": {"flops": cost.flops, "bytes_accessed": cost.bytes_moved},
        "hlo": cost.record(),
        "trace_s": round(cost.seconds, 2),
        "ops": cost.ops,
    }


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool, verbose: bool = True,
             attn: str | None = None, overrides: dict | None = None, device: str = "cuda",
             cfg=None, mesh_shape: tuple | None = None, shape=None) -> dict:
    """Trace one cell; returns the dry-run record. ``cfg``, ``mesh_shape``
    (with the production mesh's axis names for its length) and ``shape``
    stand in for the registry's config, the production mesh and the
    registry's shape (the tests' small cells)."""
    cfg = cfg or get_arch(arch_name)
    if attn:
        cfg = cfg.replace(attention_impl=attn)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape or get_shape(shape_name)
    dims, axes = PRODUCTION[multi_pod]
    if mesh_shape is not None:
        dims, axes = tuple(mesh_shape), axes[-len(mesh_shape):]
    model = build_model(cfg)
    chips = 1
    for s in dims:
        chips *= s
    rec: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name(dims),
                 "chips": chips, "kind": shape.kind, "device": device}
    n_model = dims[axes.index("model")]
    t0 = time.time()
    ranks = []
    for r in dict.fromkeys((0, n_model - 1)):  # the origin and the last rank of "model"
        ranks.append(trace_rank(model, shape, dims, axes, r, device))
    heavy = max(ranks, key=lambda e: (e["hlo"]["flops_per_device"], e["peak_bytes_per_device"]))
    rec.update({k: heavy[k] for k in ("memory", "peak_bytes_per_device", "cost_analysis",
                                      "hlo")})
    rec["peak_bytes_per_device"] = max(e["peak_bytes_per_device"] for e in ranks)
    rec["heavier_rank"] = heavy["rank"]
    rec["ranks"] = ranks
    rec["trace_s"] = round(time.time() - t0, 2)
    if verbose:
        h = rec["hlo"]
        print(f"[dryrun] {arch_name} x {shape_name} ({rec['mesh']}): trace {rec['trace_s']}s, "
              f"peak/device {rec['peak_bytes_per_device'] / 2**30:.2f} GiB, "
              f"flops/device {h['flops_per_device']:.3e}, "
              f"coll bytes/device {h['collective_bytes_per_device']:.3e}")
        sys.stdout.flush()
    return rec


#: the Mini-App streams' cells: (app, shape) -> one batch's sizes, those of
#: ``chip_smoke.py``'s streams (batches of 16 messages; 8 frames; ML-EM at
#: ``ReconstructionApp``'s 4 iterations)
MINIAPP_CELLS = {
    ("kmeans", "narrow"): {"points": 16 * 5000, "dim": 3, "k": 10},
    ("kmeans", "wide"): {"points": 16 * 4096, "dim": 128, "k": 1024},
    ("gridrec", "360x1448"): {"frames": 8, "angles": 360, "bins": 1448, "n": 1448},
    ("mlem", "360x1448"): {"frames": 8, "angles": 360, "bins": 1448, "n": 1448, "iters": 4},
}


def dry_run_cells() -> list[tuple[str, str]]:
    """``--all``'s cells: the LM grid (arch x shape), then the Mini-App streams'."""
    return all_cells() + list(MINIAPP_CELLS)


def miniapp_batch(app: str, shape: str):
    """(fn, args, kernel FLOPs) of one batch of a Mini-App cell: ``fn(*args)``
    is the stream's processing on the device, ``args`` ``meta`` structs (and
    the angles), the FLOPs those of its kernels' formulas."""
    from repro_torch.kernels import kmeans, tomo

    size = MINIAPP_CELLS[(app, shape)]
    meta = torch.device("meta")
    if app == "kmeans":
        n, d, k = size["points"], size["dim"], size["k"]
        args = (torch.empty((n, d), device=meta), torch.empty((k, d), device=meta))
        return (kmeans.minibatch_update, args,
                kmeans.ops.assign_flops(n, d, k) + kmeans.ops.update_flops(n, d))
    b, a, n_det, n = size["frames"], size["angles"], size["bins"], size["n"]
    args = (torch.empty((b, a, n_det), device=meta), torch.from_numpy(tomo.angle_grid(a)), n)
    one = tomo.ops.projector_flops(b, a, n)
    if app == "gridrec":
        return tomo.gridrec_batch, args, one
    iters = size["iters"]
    return (lambda sinos, angles, n: tomo.mlem_batch(sinos, angles, n, iters=iters), args,
            (2 * iters + 1) * one)


def run_miniapp_cell(app: str, shape: str, *, device: str = "cuda",
                     verbose: bool = True) -> dict:
    """Trace one batch of a Mini-App cell on one device; its dry-run record."""
    from repro_torch.runtime.cost_analysis import trace_cost

    fn, args, kernel_flops = miniapp_batch(app, shape)
    t0 = time.time()
    _, cost = trace_cost(fn, *args, device=device)
    alias = cost.alias_bytes
    rec = {"arch": app, "shape": shape, "mesh": "1", "chips": 1, "kind": "stream",
           "device": device, "dtype": "float32", "batch": MINIAPP_CELLS[(app, shape)],
           "memory": {"argument_bytes": int(cost.input_bytes),
                      "output_bytes": int(cost.output_bytes),
                      "temp_bytes": int(cost.peak_bytes - cost.input_bytes - cost.output_bytes
                                        + alias),
                      "alias_bytes": int(alias)},
           "peak_bytes_per_device": int(cost.peak_bytes),
           "cost_analysis": {"flops": cost.flops, "bytes_accessed": cost.bytes_moved},
           "hlo": cost.record(), "kernel_flops": kernel_flops, "ops": cost.ops,
           "trace_s": round(time.time() - t0, 2)}
    if cost.flops != kernel_flops:
        raise AssertionError(f"{app} x {shape}: traced FLOPs {cost.flops} != the kernels' "
                             f"formulas' {kernel_flops}")
    if verbose:
        h = rec["hlo"]
        print(f"[dryrun] {app} x {shape} (1 device): trace {rec['trace_s']}s, "
              f"peak/device {rec['peak_bytes_per_device'] / 2**30:.3f} GiB, "
              f"flops/device {h['flops_per_device']:.3e}, "
              f"fused bytes/device {h['bytes_fused_per_device']:.3e}")
        sys.stdout.flush()
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--attn", default=None, help="override attention impl (blockwise|flash|ring)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (cuda: the card's path)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.backends.cuda.is_built():
        ap.error("this PyTorch is built without CUDA: fake cuda tensors cannot be indexed; "
                 "pass --device cpu to trace the same code on fake CPU tensors")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = dry_run_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records, failures = [], []
    for arch, shape in cells:
        if (arch, shape) in MINIAPP_CELLS:  # one device: no mesh
            try:
                records.append(run_miniapp_cell(arch, shape, device=args.device))
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                failures.append((arch, shape, None, repr(e)))
                records.append({"arch": arch, "shape": shape, "mesh": "1", "error": repr(e)})
            continue
        ok, why = cell_supported(arch, shape)
        if not ok:
            records.append({"arch": arch, "shape": shape, "skipped": why})
            print(f"[dryrun] SKIP {arch} x {shape}: {why}")
            continue
        for mp in meshes:
            try:
                records.append(run_cell(arch, shape, multi_pod=mp, attn=args.attn,
                                        device=args.device))
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                failures.append((arch, shape, mp, repr(e)))
                records.append({"arch": arch, "shape": shape,
                                "mesh": mesh_name(PRODUCTION[mp][0]), "error": repr(e)})

    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    for rec in records:
        if "hlo" in rec:
            print("[dryrun] record " + json.dumps({k: v for k, v in rec.items() if k != "ranks"}))
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", f_)
        sys.exit(1)
    print(f"[dryrun] all {len(records)} cells OK")


if __name__ == "__main__":
    main()
