#!/usr/bin/env python3
"""Three measurements of the model families' training on one GPU, beside
``chip_smoke.py``'s families training phase (its sizes, seeds and steps):

    python3 tools/train_families_probe.py [--only select lr steps]

* ``select``: what indexing the stacked (L, ...) leaves costs a train step
  of llava-next at FAM_LLAVA_LAYERS layers, full width, bf16 params
  (``select_cost``). Prints one ``select_backward`` JSON line.
* ``lr``: each family's FAM_TRAIN_STEPS full-width steps of the phase
  (``family_train_stub`` / ``family_train_stream``, the first two on one
  batch) from the same drawn state and batches at each of LRS. Whether the
  losses' rise after a few steps follows the learning rate. One ``lr`` JSON
  line per family and learning rate.
* ``steps``: each family at ``family_check``'s size in f32, card against
  CPU (``train_check_step``) carried through STEPS steps instead of
  TRAIN_CHECK_STEPS: whether the card's updates stay the CPU's while the
  losses rise. One ``steps`` JSON line per family, with the ``TRAIN_*``
  tolerances' verdict (a reading here, not a check).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LRS = (3e-4, 3e-5)
STEPS = 6


def select_cost(torch, module, step_fn, state: dict, batch: dict) -> dict:
    """One step each way on the same state and batch, in turns (as is,
    unbound, unbound, as is): as is, ``module.layer_params`` takes layer i's
    leaves as ``v[i]``, whose backward (autograd's select_backward) writes a
    zero tensor of the whole stack for every layer and adds it into the
    leaf's gradient; unbound, the stacks' slices are bound once a step with
    ``unbind`` (whose backward stacks the L slices' gradients once). The
    step's wall (host clock, synchronized) and the card's peak memory."""
    original = module.layer_params

    def unbound():
        memo: dict = {}

        def layer_params(stack, i):
            if id(stack) not in memo:
                parts = {k: v.unbind(0) for k, v in stack.items()}
                n = len(next(iter(parts.values())))
                memo[id(stack)] = [{k: parts[k][j] for k in stack} for j in range(n)]
            return memo[id(stack)][i]

        return layer_params

    walls: dict = {"select": [], "unbind": []}
    peaks: dict = {"select": [], "unbind": []}
    try:
        for mode in ("select", "unbind", "unbind", "select"):
            module.layer_params = original if mode == "select" else unbound()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, _, met = step_fn(state["params"], state["opt"], batch)
            float(met["loss"])
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            peaks[mode].append(torch.cuda.max_memory_allocated() / 2 ** 30)
    finally:
        module.layer_params = original
    return {"step_wall_s": walls, "peak_gib": peaks,
            "select_minus_unbind_s": (sum(walls["select"]) - sum(walls["unbind"])) / 2,
            "select_minus_unbind_gib": max(peaks["select"]) - max(peaks["unbind"])}


def probe_select(torch, cs, device) -> None:
    import numpy as np

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model, transformer
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_train_step

    cfg = get_arch("llava-next-mistral-7b").replace(n_layers=cs.FAM_LLAVA_LAYERS)
    model = build_model(cfg)
    opt_cfg = OptimizerConfig(name=cfg.optimizer, learning_rate=cs.TRAIN_LR,
                              warmup_steps=cs.TRAIN_WARMUP, total_steps=10)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    params = model.init(gen)
    state = {"params": params, "opt": Optimizer(opt_cfg).init(params)}
    step = build_train_step(model, ShapeConfig("stream", cs.TRAIN_SEQ, cs.TRAIN_BATCH, "train"),
                            opt_cfg, device=device)
    tokens = np.minimum(np.random.default_rng(cs.SEED).zipf(
        1.3, size=(cs.TRAIN_BATCH, cs.TRAIN_SEQ)) - 1, cfg.vocab_size - 1).astype(np.int32)
    stub = torch.randn((cs.TRAIN_BATCH, cfg.n_patches, cfg.d_model), generator=gen,
                       device=device).to(model.compute_dtype)
    batch = cs._stub_batch(cfg, tokens, stub)
    params, opt, met = step(state["params"], state["opt"], batch)  # the first step's imports
    float(met["loss"])
    state = {"params": params, "opt": opt}
    print("select_backward " + json.dumps({"model": cfg.name, "layers": cfg.n_layers,
                                           **select_cost(torch, transformer, step, state, batch)}),
          flush=True)


def probe_lr(torch, cs, kernels, device) -> None:
    from repro_torch.configs import get_arch

    for name in cs.FAMILIES:
        for lr in LRS:
            gc.collect()
            torch.cuda.empty_cache()
            if get_arch(name).family in ("vlm", "encdec"):
                res = cs.family_train_stub(torch, kernels, name, device, lr=lr)
            else:
                res = cs.family_train_stream(torch, kernels, name, lr=lr)
            del res["state"]
            print("lr " + json.dumps({"model": name, "lr": lr, "layers": res["layers"],
                                      "losses": res["losses"],
                                      "repeated_batch_losses": res["repeated_batch_losses"]}),
                  flush=True)
            del res


def probe_steps(torch, cs, device) -> None:
    for name in cs.FAMILIES:
        cfg, _ = cs.family_check(name, "float32")
        n_stub = cfg.n_patches if cfg.family == "vlm" else 2 * cs.FAM_TCHECK_TOKENS
        batches = cs.train_batches(cfg, cs.FAM_TCHECK_BATCH, cs.FAM_TCHECK_TOKENS, STEPS, n_stub)
        try:
            res, within = cs.train_check_step(torch, device, cfg, batches), True
        except AssertionError as e:  # the reading is the point here
            res, within = str(e), False
        print("steps " + json.dumps({"model": name, "steps": STEPS, "within_train_tol": within,
                                     "result": res}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=["select", "lr", "steps"])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch import kernels

    if not torch.cuda.is_available():
        raise SystemExit("train_families_probe: needs a CUDA card")
    print(cs.card_line(), flush=True)
    kernels.build_all()
    device = torch.device("cuda")
    if "select" in args.only:
        probe_select(torch, cs, device)
    if "lr" in args.only:
        probe_lr(torch, cs, kernels, device)
    if "steps" in args.only:
        probe_steps(torch, cs, device)


if __name__ == "__main__":
    main()
