#!/usr/bin/env python3
"""The serving-shape flash forward of two checkouts, timed in turns.

    python3 tools/flash_ab.py PARENT_DIR CHANGE_DIR [--rounds 2]

Each checkout (unpacked with ``git archive`` under ``build/``) is timed in
a process of its own, so each imports its own ``repro_torch`` and builds its
own ``flash_attention.cu`` into its own ``build/kernels/``: the order is
parent, change, change, parent, repeated ``--rounds`` times, and each
process runs its checkout's ``chip_smoke.check_flash`` at the serving path's
shape (B = 1, Sq = Skv = 128, 9 heads over 3 KV heads of 64, causal, bf16)
three times, printing the graph-replay ms of each. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

CHILD = """
import json, sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as cs
from repro_torch.kernels import attention
attention.FLASH_ATTENTION.library.load()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
print(json.dumps([cs.check_flash(torch, attention, 1, cs.PROMPT_LEN, gen, True)["ms"]
                  for _ in range(3)]))
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            out = subprocess.run([sys.executable, "-c", CHILD, getattr(args, side)],
                                 capture_output=True, text=True, check=True, timeout=900)
            print(json.dumps({"checkout": side,
                              "flash_serving_ms": json.loads(out.stdout.splitlines()[-1])}))


if __name__ == "__main__":
    main()
