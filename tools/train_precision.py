#!/usr/bin/env python3
"""How closely a train step of each model family on the card agrees with the
same step on the host CPU, in bf16 and in f32 compute, on one GPU, and
where a bf16 evaluation departs from the f32 one.

    python3 tools/train_precision.py [--models NAME ...] [--spread N] [--trained]
                                     [--flag-off]

Each family at ``chip_smoke.py``'s card-against-CPU size
(``chip_smoke.family_check``: full width, TRAIN_CHECK_LAYERS layers, f32
params, weights and batches from ``chip_smoke.SEED``):
the loss and every gradient from the same weights on both devices (step 1),
then one AdamW step on each device with its own gradients and the next
batch's gradients again (step 2). Prints one ``precision`` JSON line per
family and compute dtype: both losses, their relative difference, and per
step the largest relative L2 difference of a leaf's gradient (card against
CPU over the CPU's norm) with its leaf. Two evaluations that round at other
places agree to what the step's arithmetic allows: this says which compute
dtype a card-against-CPU check of a family can hold to a tolerance.

Then ``departure`` JSON lines per family: step 1 once more with
``remat="none"`` on the CPU and the card in each compute dtype, every
evaluation against the CPU's f32 one: the loss, the grad norm, each leaf's
gradient (median and worst relative L2), and, in the order the forward and
the backward reach them, the value and the gradient of every traced
intermediate (each RMSNorm's input and output, each attention's output;
RWKV6's WKV inputs r, k, v, w and output, and its GroupNorm's output;
Mamba2's conv and SSD outputs). The first intermediate whose distance
jumps is where rounding is amplified; one that departs on the card alone
is a fault of the card's path.

The card's evaluations run with ``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction`` as torch sets it (on: cuBLAS may
then sum a bf16 product's split-K partials in bf16, rounding it twice) and,
with ``--flag-off``, once more with it off (summed in f32 and rounded once,
as the reference's products are): one ``departure`` line for each, the
flag's state in every line (the CPU's evaluations, which the flag does not
touch, are the same in both).

With ``--spread N`` (on the CPU, and on the card when there is one; no
card needed): instead, N copies of each family's ``family_check`` weights,
each leaf times (1 + SPREAD_REL x a unit normal draw seeded by the copy's
index), each evaluated in f32 and in bf16 as in ``departure``. A relative
change of SPREAD_REL moves an f32 evaluation by about as much, but changes
which way some bf16 roundings go: the spread of the bf16 evaluations'
distance from f32 over the copies (the loss's and each leaf gradient's) is
what a bf16 evaluation of this step can come out at on one device. One
``spread`` JSON line per family and device, and on the card per state of
the flag that is run.

With ``--trained`` (needs the card): ``departure`` and ``--spread`` start
from each family's trained weights instead of the drawn ones, at
``chip_smoke.py``'s trained phase (``chip_smoke.train_family``: full width,
FAM_TCHECK_LAYERS layer, TRAINED_STEPS f32 steps on the card from SEED),
and evaluate ``family_check``'s batch at that depth; the ``precision``
lines are left out.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SPREAD_REL = 2.0 ** -12  # a sixteenth of a bf16 ulp


class Tracer:
    """Records, per call in order, the value of each traced function's
    output (and of some of its inputs) and, through a tensor hook, its
    gradient. ``install`` wraps the functions in the model modules'
    namespaces; ``remove`` puts them back."""

    def __init__(self):
        self.values: dict = {}
        self.order: list = []
        self.saved: list = []

    def tag(self, name, t):
        import torch

        if not isinstance(t, torch.Tensor):
            return
        key = f"{name}#{sum(1 for k in self.order if k.split('#')[0] == name)}"
        self.order.append(key)
        self.values[key] = t.detach().double().cpu()
        if t.requires_grad:
            t.register_hook(lambda g, key=key: self.values.__setitem__(
                "d" + key, g.detach().double().cpu()))

    def wrap(self, fn, name, inputs=()):
        def traced(*args, **kw):
            for i, label in inputs:
                self.tag(f"{name}.{label}", args[i])
            out = fn(*args, **kw)
            self.tag(f"{name}.out", out[0] if isinstance(out, tuple) else out)
            return out
        return traced

    def install(self):
        from repro_torch.models import encdec, mamba2, rwkv6, transformer, zamba

        plan = [(m, "rms_norm", "rms_norm", ((0, "in"),)) for m in
                (rwkv6, mamba2, zamba, transformer, encdec) if hasattr(m, "rms_norm")]
        plan += [(transformer.attn_lib, "blockwise_attention", "attention", ()),
                 (rwkv6, "wkv6_chunked", "wkv",
                  ((0, "r"), (1, "k"), (2, "v"), (3, "w"))),
                 (rwkv6, "group_norm", "group_norm", ()),
                 (mamba2, "conv1d_causal", "conv", ()),
                 (mamba2, "ssd_chunked", "ssd", ((0, "x"), (1, "dt")))]
        for module, attr, name, inputs in plan:
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))
            setattr(module, attr, self.wrap(fn, name, inputs))

    def remove(self):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)
        self.saved.clear()


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="*", default=None)
    ap.add_argument("--spread", type=int, default=0)
    ap.add_argument("--trained", action="store_true",
                    help="start departure and --spread from the trained phase's weights (card)")
    ap.add_argument("--flag-off", action="store_true",
                    help="evaluate on the card also with allow_bf16_reduced_precision_reduction off")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.utils import tree_flatten_with_paths, tree_map_with_paths

    if not torch.cuda.is_available() and (args.trained or not args.spread):
        raise SystemExit("train_precision: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.cuda.is_available():
        print(cs.card_line())
        kernels.build_all()
    flags = tuple(dict.fromkeys(
        (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,)
        + ((False,) if args.flag_off else ())))

    def grads(model, params, batch, device):
        flat = tree_flatten_with_paths(params)
        leaves = [x.requires_grad_(True) for _, x in flat]
        loss, _ = model.loss(params, {k: torch.as_tensor(v).to(device) for k, v in batch.items()})
        got = torch.autograd.grad(loss, leaves)
        for x in leaves:
            x.requires_grad_(False)
        return float(loss.detach()), {path: g for (path, _), g in zip(flat, got)}

    def worst(cpu: dict, card: dict) -> dict:
        rel = {k: float((cpu[k].double() - card[k].cpu().double()).norm()
                        / cpu[k].double().norm().clamp_min(1e-30)) for k in cpu}
        leaf = max(rel, key=rel.get)
        return {"worst_leaf_rel_l2": rel[leaf], "worst_leaf": leaf,
                "median_leaf_rel_l2": sorted(rel.values())[len(rel) // 2]}

    def weights(name: str, compute: str, start):
        """The model at the check's depth (FAM_TCHECK_LAYERS from trained
        weights, else TRAIN_CHECK_LAYERS), its first batch, and its weights
        on the CPU: ``start``, or drawn from SEED."""
        layers = cs.FAM_TCHECK_LAYERS if start is not None else cs.TRAIN_CHECK_LAYERS
        cfg, batches = cs.family_check(name, compute, layers)
        model = build_model(cfg.replace(remat="none"))
        if start is None:
            start = model.init(torch.Generator().manual_seed(cs.SEED))
        return model, batches[0], start

    def departure(name: str, start=None) -> list:
        """One line for each state of the flag in ``flags``: every evaluation
        against the CPU's f32 one (the CPU's run once, the card's under each
        state)."""

        def evaluate(where, compute):
            model, batch, base = weights(name, compute, start)
            params = tree_map_with_paths(lambda _, x: x.to(where, copy=True), base)
            tracer = Tracer()
            tracer.install()
            try:
                loss, g = grads(model, params, batch, where)
            finally:
                tracer.remove()
            return loss, {k: v.double().cpu() for k, v in g.items()}, tracer

        cpu = {("cpu", c): evaluate("cpu", c) for c in ("float32", "bfloat16")}
        loss0, g0, t0 = cpu["cpu", "float32"]
        keys = t0.order + ["d" + k for k in reversed(t0.order) if "d" + k in t0.values]
        lines = []
        for allow in flags:
            with cs.reduction(torch, allow):
                runs = {**cpu, **{("cuda", c): evaluate("cuda", c)
                                  for c in ("float32", "bfloat16")}}
            out = {"model": name, "weights": "drawn" if start is None else "trained",
                   "allow_bf16_reduced_precision_reduction": allow, "reference": "cpu float32",
                   "grad_norm_reference": float(sum(x.norm() ** 2 for x in g0.values()) ** 0.5)}
            for (where, compute), (loss, g, tracer) in runs.items():
                if (where, compute) == ("cpu", "float32"):
                    continue
                leaf = {k: rel(g[k], g0[k]) for k in g0}
                out[f"{where} {compute}"] = {
                    "loss_rel": abs(loss - loss0) / abs(loss0),
                    "grad_norm": float(sum(x.norm() ** 2 for x in g.values()) ** 0.5),
                    "median_leaf_rel_l2": sorted(leaf.values())[len(leaf) // 2],
                    "worst_leaf": max(leaf, key=leaf.get),
                    "worst_leaf_rel_l2": max(leaf.values()), "leaf_rel_l2": leaf,
                    "traced_rel_l2": {k: rel(tracer.values[k], t0.values[k]) for k in keys
                                      if k in tracer.values}}
            lines.append(out)
            del runs
        return lines

    def spread(name: str, where: str, n: int, start=None) -> dict:
        samples = []
        for i in range(n):
            gen = torch.Generator().manual_seed(i)
            g, loss = {}, {}
            for compute in ("float32", "bfloat16"):
                model, batch, base = weights(name, compute, start)
                if i:  # copy 0 is the weights as they are
                    base = tree_map_with_paths(lambda _, x: x * (1 + SPREAD_REL * torch.randn(
                        x.shape, generator=gen)), base)
                params = tree_map_with_paths(lambda _, x: x.to(where, copy=True), base)
                loss[compute], got = grads(model, params, batch, where)
                g[compute] = {k: v.double().cpu() for k, v in got.items()}
                del params, base
            leaf = {k: rel(g["bfloat16"][k], g["float32"][k]) for k in g["float32"]}
            samples.append({
                "loss_rel": abs(loss["bfloat16"] - loss["float32"]) / abs(loss["float32"]),
                "grad_norm_f32": float(sum(x.norm() ** 2 for x in g["float32"].values()) ** 0.5),
                "grad_norm_bf16": float(sum(x.norm() ** 2 for x in g["bfloat16"].values()) ** 0.5),
                "median_leaf_rel_l2": sorted(leaf.values())[len(leaf) // 2],
                "worst_leaf": max(leaf, key=leaf.get), "worst_leaf_rel_l2": max(leaf.values())})
        return {"model": name, "device": where,
                "weights": "drawn" if start is None else "trained",
                "allow_bf16_reduced_precision_reduction":
                    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                "rel": SPREAD_REL, "samples": samples}

    def trained(name: str):
        """The trained phase's weights of ``name``, on the CPU."""
        from repro_torch import miniapps
        from repro_torch.core import PilotComputeService

        dev = torch.device("cuda", 0)
        svc = PilotComputeService(devices=[dev])
        try:
            cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
            ctx = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"}).get_context()
            params, report, _ = cs.train_family(torch, kernels, miniapps, cluster, ctx, name, dev)
        finally:
            svc.cancel()
        print("trained " + json.dumps(report), flush=True)
        params = tree_map_with_paths(lambda _, x: x.cpu(), params)
        torch.cuda.empty_cache()
        return params

    names = args.models or (cs.FAM_TCHECK_F32 if args.trained else cs.FAMILIES)
    if args.trained or args.spread:
        for name in names:
            start = trained(name) if args.trained else None
            if not args.spread:
                for line in departure(name, start):
                    print("departure " + json.dumps(line), flush=True)
                continue
            print("spread " + json.dumps(spread(name, "cpu", args.spread, start)), flush=True)
            if torch.cuda.is_available():
                for allow in flags:
                    with cs.reduction(torch, allow):
                        line = spread(name, "cuda", args.spread, start)
                    print("spread " + json.dumps(line), flush=True)
            torch.cuda.empty_cache()
        return

    opt_cfg = OptimizerConfig(learning_rate=cs.TRAIN_LR, warmup_steps=cs.TRAIN_WARMUP,
                              total_steps=cs.TRAIN_STEPS)
    for name in names:
        for compute in ("bfloat16", "float32"):
            cfg, batches = cs.family_check(name, compute)
            model = build_model(cfg)
            start = model.init(torch.Generator().manual_seed(cs.SEED))
            side = {}
            for where in ("cpu", "cuda"):
                params = tree_map_with_paths(lambda _, x: x.to(where, copy=True), start)
                loss1, g1 = grads(model, params, batches[0], where)
                opt = Optimizer(opt_cfg)
                opt.update(tree_map_with_paths(lambda path, _: g1[path], params), opt.init(params),
                           params)
                loss2, g2 = grads(model, params, batches[1], where)
                side[where] = (loss1, g1, loss2, g2)
                del params
            (c1, cg1, c2, cg2), (d1, dg1, d2, dg2) = side["cpu"], side["cuda"]
            print("precision " + json.dumps({
                "model": name, "compute_dtype": compute,
                "allow_bf16_reduced_precision_reduction":
                    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                "loss_cpu": [c1, c2], "loss_card": [d1, d2],
                "loss_rel": [abs(d1 - c1) / abs(c1), abs(d2 - c2) / abs(c2)],
                "step1": worst(cg1, dg1), "step2": worst(cg2, dg2)}), flush=True)
            del side
            torch.cuda.empty_cache()
        for line in departure(name):
            print("departure " + json.dumps(line), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
