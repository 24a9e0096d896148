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

It traces the card's path (fake ``cuda`` tensors) unless ``--device cpu``
is given. It never touches a GPU, but indexing a fake ``cuda`` tensor needs
a PyTorch built with CUDA: on a CPU-only build pass ``--device cpu``, which
traces the same code on fake CPU tensors (only the peak's rounding to the
CUDA allocator's 512-byte blocks differs).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
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

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records, failures = [], []
    for arch, shape in cells:
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
