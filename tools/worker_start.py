#!/usr/bin/env python3
"""Where a spawned worker's start-up goes, on the GPU machine.

    python3 tools/worker_start.py [--workers N]

The mp executor spawns the worker of an owner on the card (a forked child
cannot use CUDA once the parent has), and the supervisor watches it only
from its first beat. This starts N children with the ``spawn`` method, one
after another, each stamping the steps a worker takes before that beat:
the interpreter and the spawn preparation, ``import torch``, the port's
worker and kernel modules, the CUDA context, loading the kernels'
libraries (built by the parent, never in the child), and unpickling the
continuous phase's window processor (``chip_smoke.KMeansWindows``, which
runs one warm-up window on the card). Then it starts N workers through the
runtime's own path (``WorkerSupervisor`` with a spawn context) and prints
their ``start_seconds``. Seconds are from ``Process.start()`` in the
parent. Needs a CUDA card; builds the kernels first if they are not built.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _child(q, device: str, blob: bytes) -> None:
    stamps = [("spawned", time.monotonic())]
    import torch

    stamps.append(("import_torch", time.monotonic()))
    from repro_torch.kernels import _build
    from repro_torch.workers import worker  # noqa: F401

    stamps.append(("import_port", time.monotonic()))
    torch.cuda.set_device(torch.device(device))
    torch.zeros(1, device=device)
    stamps.append(("cuda_context", time.monotonic()))
    _build.forbid_builds()
    _build.load_all()
    stamps.append(("load_libraries", time.monotonic()))
    import pickle

    pickle.loads(blob)
    torch.cuda.synchronize()
    stamps.append(("window_processor", time.monotonic()))
    q.put(stamps)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=3)
    args = ap.parse_args()

    import multiprocessing as mp
    import pickle

    import torch

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.core.failure import HeartbeatMonitor
    from repro_torch.workers import WorkerSupervisor

    if not torch.cuda.is_available():
        sys.exit("tools/worker_start.py needs a CUDA card")
    print(cs.card_line())
    kernels.build_all()
    device = "cuda:0"
    torch.zeros(1, device=device)  # the parent holds a context, as the smoke's does
    blob = pickle.dumps(cs.KMeansWindows(device).process)
    ctx = mp.get_context("spawn")
    for i in range(args.workers):
        q = ctx.Queue()
        p = ctx.Process(target=_child, args=(q, device, blob))
        t0 = time.monotonic()
        p.start()
        stamps = q.get(timeout=120)
        p.join(30)
        steps, last = {}, t0
        for name, t in stamps:
            steps[name] = t - last
            last = t
        print("worker_start_steps " + json.dumps({"worker": i, "total_s": last - t0,
                                                  "steps_s": steps}))

    monitor = HeartbeatMonitor(0.1, 2.0)
    sups = [WorkerSupervisor(i, i, blob, monitor=monitor, ctx=ctx, device=device)
            for i in range(args.workers)]
    try:
        t0 = time.monotonic()
        for sup in sups:
            sup.spawn(wait=False)
        for sup in sups:
            sup.await_start()
        print("worker_start_supervised " + json.dumps({
            "workers": args.workers, "started_side_by_side_s": time.monotonic() - t0,
            "start_seconds": [s.start_seconds[0] for s in sups],
            "card_used_mib": (lambda f, t: (t - f) / 2**20)(*torch.cuda.mem_get_info())}))
    finally:
        for sup in sups:
            sup.stop()
        monitor.close()


if __name__ == "__main__":
    main()
