#!/usr/bin/env python3
"""Where the time goes on the port's main paths, on one GPU.

    python3 tools/trace_path.py [kmeans] [lightsource] [serve]

Runs the K-Means, light-source and LM serving paths of ``chip_smoke.py``
(all three unless some are named) once to warm up (kernel build, cuFFT
plans, cuBLAS, allocator) and once more under ``torch.profiler``, each on a
fresh ``PilotComputeService`` (the serving path with 4 of its 16 messages,
which keeps the profiler's event list small). For every path it
prints one JSON line: the
wall-clock seconds of the profiled run (service start and stop, the
streams, and for the light-source path the checks against the plain
versions), each stream's own wall-clock seconds, the
device-busy seconds (the union of all kernel and copy intervals on the
card), the busy share of the run's wall clock, and the device seconds of
the top operations by name. Numbers are taken with the profiler on;
``chip_smoke.py`` gives the untraced rates.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def busy_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start_us, end_us) intervals, in seconds."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total * 1e-6


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("trace_path: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch import kernels, miniapps
    from repro_torch.core import PilotComputeService
    from repro_torch.kernels import tomo

    paths = sys.argv[1:] or ["kmeans", "lightsource", "serve"]
    unknown = set(paths) - {"kmeans", "lightsource", "serve"}
    if unknown:
        sys.exit(f"trace_path: unknown paths {sorted(unknown)}")
    print(cs.card_line())
    kernels.build_all()

    def run(path: str):
        svc = PilotComputeService()
        try:
            cluster = svc.submit_pilot({"number_of_nodes": 2, "type": "kafka"}).get_context()
            ctx = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"}).get_context()
            if path == "kmeans":
                return cs.kmeans_path(torch, kernels, miniapps, cluster, ctx, ctx.devices[0])
            if path == "serve":  # 4 of the smoke run's 16 messages: ~140 decode steps
                return cs.serve_path(torch, kernels, miniapps, cluster, ctx, ctx.devices[0],
                                     n_msgs=4)
            return cs.recon_path(torch, kernels, miniapps, tomo, cluster, ctx, ctx.devices[0])
        finally:
            svc.cancel()

    for path in paths:
        run(path)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            out = run(path)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = busy_seconds([(e.time_range.start, e.time_range.end) for e in device])
        by_name: dict[str, float] = {}
        for e in device:
            key = e.name[:80]
            by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        reports = out["reports"] if "reports" in out else [out["report"]]
        print("trace " + json.dumps({
            "path": path, "wall_s": wall,
            "stream_wall_s": {r["path"]: r["wall_s"] for r in reports},
            "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_events": len(device), "top_device_s": dict(top)}))


if __name__ == "__main__":
    main()
