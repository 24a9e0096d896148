#!/usr/bin/env python3
"""What the pipeline phase's ML-EM stage sustains on the card, by batch
size and with the engine's rate control on or off.

    python3 tools/pipeline_capacity.py

Runs ``chip_smoke.pipeline_path`` (the pipeline phase: its spec, runner
and checks) with a short burst of frames far above what the stage takes,
once per setting, and reads from its timeline the rate at which the stage
worked the backlog off after the burst (frames processed per second while
the lag exceeded 10 messages). ``chip_smoke.py`` chooses its burst rate
from these numbers (PERF.md §4). Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

# (frames per batch, rate control on), each at a (seconds, msgs/s) schedule
SETTINGS = ((8, False, ((1.0, 10), (1.5, 300), (6.0, 5))),
            (2, False, ((1.0, 10), (1.5, 300), (6.0, 5))),
            (8, True, ((1.0, 10), (1.0, 300), (3.0, 5))))


def drain_rate(timeline: list, burst_end: float) -> float | None:
    """Frames per second processed between the first and the last sample
    after ``burst_end`` whose lag exceeds 10 messages."""
    busy = [row for row in timeline if row[0] >= burst_end and row[2] > 10]
    if len(busy) < 2:
        return None
    (t0, _, _, _, done0), (t1, _, _, _, done1) = busy[0], busy[-1]
    return (done1 - done0) / (t1 - t0)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("pipeline_capacity: needs a CUDA card")
    from repro_torch import kernels, pipeline
    from repro_torch.kernels import kmeans, tomo

    print(cs.card_line())
    kernels.build_all()
    cs.PIPE_TIMEOUT_S = 120
    for batch, rate_control, schedule in SETTINGS:
        cs.PIPE_RECON_BATCH, cs.PIPE_RECON_RATE_CONTROL = batch, rate_control
        cs.PIPE_FRAME_SCHEDULE = schedule
        cs.PIPE_FRAMES = int(sum(t * r for t, r in schedule))
        report = cs.pipeline_path(torch, kernels, pipeline, kmeans, tomo)["report"]
        recon = report["stages"]["recon"]
        print("capacity " + json.dumps({
            "frames_per_batch": batch, "rate_control": rate_control, "schedule": schedule,
            "drain_frames_per_s": drain_rate(report["timeline_t_slots_lag_sent_processed"],
                                             schedule[0][0] + schedule[1][0]),
            "records": recon["records"], "batches": recon["batches"],
            "events": report["events"]}), flush=True)


if __name__ == "__main__":
    main()
