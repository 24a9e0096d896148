#!/usr/bin/env python3
"""Faults planted in the state families' decode path, against the checks
``chip_smoke.py`` holds rwkv6-3b and zamba2-1.2b to, on one GPU.

    python3 tools/state_faults.py [--models rwkv6-3b zamba2-1.2b]

Each model is drawn once at full width and depth (bf16, random weights from
``chip_smoke.SEED`` on the card), then served by ``chip_smoke``'s families
stream (``family_stream_serve``: ``LMServeApp`` lockstep, 2 messages of 4
prompts of 128 tokens, 65 tokens) and checked as the families phase checks
it (``state_replay``; the bf16 ``rescore`` at 192 tokens, read, not held):
once as the port is, then under each fault. A fault is planted in memory,
for its run only, by wrapping the model class's ``decode``, so that the
serving, the bf16 replay and the f32 replay all run it and the prefill
does not; no file changes:

* ``state_to_next_layer``: each layer's new WKV (RWKV6) or SSD (Mamba2)
  state lands in the next layer's slot;
* ``shift_one_token_late``: the token-shift states (RWKV6) or the conv
  window (Mamba2) are read one token stale;
* ``state_in_compute_dtype``: the WKV or SSD state is rounded to the
  compute dtype after every step, the reference's f32 state left out (in
  the f32 replay that rounding is to f32: nothing).

Prints a ``fault`` JSON line per run: the readings, the rules of
``state_replay`` the run broke, and the bf16 re-score's clear-gap
differences. Exits non-zero if the sound run breaks a rule; a fault that
breaks none is printed as such.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FAULTS = ("state_to_next_layer", "shift_one_token_late", "state_in_compute_dtype")
#: per model: the cache paths of its recurrent states, of its shift/conv states
LEAVES = {"rwkv6-3b": ((("wkv",),), (("tm_shift",), ("cm_shift",))),
          "zamba2-1.2b": ((("mamba", "ssd"),), (("mamba", "conv"),))}


def _leaf(cache: dict, path: tuple):
    for key in path:
        cache = cache[key]
    return cache


@contextlib.contextmanager
def planted(cls, fault: str | None, states: tuple, shifts: tuple):
    """``cls.decode`` with ``fault`` planted (as it is for None)."""
    decode = cls.decode
    lag = {"cache": None, "prev": None}  # the shift states one step back, per cache

    def faulty(self, params, cache, batch):
        if fault == "shift_one_token_late":
            now = [_leaf(cache, p).clone() for p in shifts]
            if lag["cache"] is cache:
                for p, prev in zip(shifts, lag["prev"]):
                    _leaf(cache, p).copy_(prev)
            lag["cache"], lag["prev"] = cache, now
        out = decode(self, params, cache, batch)
        for p in states:
            leaf = _leaf(cache, p)
            if fault == "state_to_next_layer":
                leaf.copy_(leaf.roll(1, dims=0))
            elif fault == "state_in_compute_dtype":
                leaf.copy_(leaf.to(self.compute_dtype))
        return out

    if fault is not None:
        cls.decode = faulty
    try:
        yield
    finally:
        cls.decode = decode


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=list(LEAVES), choices=list(LEAVES))
    args = ap.parse_args()

    import gc

    import torch

    if not torch.cuda.is_available():
        sys.exit("state_faults: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch import kernels, miniapps
    from repro_torch.configs import get_arch
    from repro_torch.core import PilotComputeService
    from repro_torch.models import build_model

    sound_broken = []
    for name in args.models:
        model = build_model(get_arch(name))
        device = torch.device("cuda", 0)
        params = model.init(torch.Generator(device=device).manual_seed(cs.SEED))
        states, shifts = LEAVES[name]
        for fault in (None, *FAULTS):
            svc = PilotComputeService()  # a fresh broker: each run's topic is new
            try:
                broker = svc.submit_pilot({"number_of_nodes": 2, "type": "kafka"})
                spark = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"})
                cluster, ctx = broker.get_context(), spark.get_context()
                with planted(type(model), fault, states, shifts):
                    res = cs.family_stream_serve(torch, kernels, miniapps, cluster, ctx, device,
                                                 model, params)
                    check = cs.state_replay(torch, model, params, res["served"])
                    bf16 = cs.rescore(torch, model, params, res["served"],
                                      steps=[cs.FAM_STATE_GEN - 1], enforce=False)
            finally:
                svc.cancel()
            print("fault " + json.dumps({
                "model": name, "fault": fault or "none", "wall_s": res["wall_s"],
                **{k: v for k, v in check.items() if k != "failed"},
                "broken": check["failed"],
                "bf16_rescore": {k: bf16[k] for k in ("checked", "agree", "met",
                                                      "clear_gap_differences")}}), flush=True)
            if fault is None and check["failed"]:
                sound_broken.append(name)
            del res
            gc.collect()
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    if sound_broken:
        sys.exit(f"state_faults: the sound run broke a rule: {sound_broken}")


if __name__ == "__main__":
    main()
