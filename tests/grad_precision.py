#!/usr/bin/env python3
"""How far each package's f32 gradients lie from an f64 evaluation of the
same model, per leaf, at ``tests/test_torch_train_families.py``'s inputs
(the ``reduced()`` config, the JAX model's weights, the test's batch), on
the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/grad_precision.py [--steps | --bf16] [ARCH ...]

The f64 evaluation is the port's model with every float32 of its modules
read as float64 (their norms, scans and losses cast to float32 by name) and
f64 params and compute; nothing else changes. Prints one line per leaf,
each error over the leaf's largest |f64 gradient|: the port's f32 against
f64, the JAX package's f32 against f64, and the two packages against each
other, then each arch's worst of the three. It sets the per-family
gradient tolerances of that test (``GRAD_TOL``): two packages each that far
from the same f64 value may differ by the sum.

With ``--steps``: three chained train steps (no grad accumulation) of
``tests/test_torch_train_families_steps.py`` from the JAX package's state,
in each package in f32 and in the port in f64 (its step and optimizer read
the same way). Per step: the loss's and the grad norm's relative distance,
and the worst leaf's update distance (over the JAX update's norm, on the
elements that test holds: moment above ``GRAD_TOL`` of the leaf's largest)
and moment distance (over the leaf's largest |moment|), for the port
against f64, the JAX package against f64 and the two against each other.
It sets that test's chained-step tolerances (``STEP_TOL``).

With ``--bf16``: how far a bf16 evaluation of the loss and its gradients
lies from the f32 one in each package, at ``chip_smoke.py``'s card-against-
CPU size and inputs (``family_check``: full width, 2 layers, f32 params drawn
by the port from ``chip_smoke.SEED``, the first batch), on the CPU: the
JAX package's bf16 and f32 and the port's bf16 against the port's f32, as
``tools/train_precision.py`` reads the card's (its ``departure`` lines).
Tens of GB of host memory at these widths: run one arch a process.

It imports both packages, as the tests do, so it lives beside them (pytest
does not collect it).
"""
from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_torch_train_families as fam  # noqa: E402  (the test's inputs)
from repro.utils.tree import tree_flatten_with_paths as jax_paths  # noqa: E402
from repro_torch.models import common, encdec, ffn, mamba2, params_from_jax  # noqa: E402
from repro_torch.models import rwkv6, transformer, zamba  # noqa: E402
from repro_torch.runtime import optimizer, steps  # noqa: E402
from repro_torch.utils import tree_flatten_with_paths, tree_map_with_paths  # noqa: E402

MODULES = (common, encdec, ffn, mamba2, rwkv6, transformer, zamba, optimizer, steps)


class _F64Torch:
    """``torch`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


def _grads(model, params, batch, dtype):
    p = tree_map_with_paths(lambda _, x: x.detach().to(dtype).clone().requires_grad_(True),
                            params)
    b = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in fam._torch(batch).items()}
    loss, _ = model.loss(p, b)
    loss.backward()
    return {path: x.grad.double() for path, x in tree_flatten_with_paths(p)}


def main(archs: list[str]) -> None:
    torch.set_num_threads(4)
    for arch in archs:
        jm, jp, tm = fam._jax_pair(arch)
        batch = fam._batch(tm.cfg, 1)
        _, jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, fam._jax(batch))
        jg = {p: torch.from_numpy(np.asarray(g, np.float64)) for p, g in
              jax_paths(jax.tree.map(np.asarray, jg))}
        params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        g32 = _grads(tm, params, batch, torch.float32)
        saved = [m.torch for m in MODULES]
        try:
            for m in MODULES:
                m.torch = _F64Torch()
            tm.compute_dtype = torch.float64
            g64 = _grads(tm, params, batch, torch.float64)
        finally:
            for m, t in zip(MODULES, saved):
                m.torch = t
        worst = [0.0, 0.0, 0.0]
        for path in g32:
            scale = float(g64[path].abs().max())
            errs = [float((a - b).abs().max()) / scale for a, b in
                    ((g32[path], g64[path]), (jg[path], g64[path]), (g32[path], jg[path]))]
            worst = [max(w, e) for w, e in zip(worst, errs)]
            print(f"{arch} {path:28s} port-f64 {errs[0]:.2e}  jax-f64 {errs[1]:.2e}  "
                  f"port-jax {errs[2]:.2e}")
        print(f"{arch} worst: port-f64 {worst[0]:.2e}  jax-f64 {worst[1]:.2e}  "
              f"port-jax {worst[2]:.2e}")


def _chain(fn, params, opt, batches, flat):
    """A step of ``fn`` on each of ``batches`` from (params, opt): per step the
    metrics, the params before and after, and the first moments, as dicts
    of f64 numpy arrays by path (``flat`` lists a tree's (path, leaf))."""
    def host(tree):
        return {p: np.array(np.asarray(x.detach() if isinstance(x, torch.Tensor) else x),
                            np.float64) for p, x in flat(tree)}

    out = []
    for batch in batches:
        before = host(params)
        params, opt, met = fn(params, opt, batch)
        out.append(({k: float(v) for k, v in met.items()}, before, host(params), host(opt["m"])))
    return out


def steps_main(archs: list[str]) -> None:
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.launch.mesh import make_mesh
    from repro.runtime.optimizer import Optimizer as JaxOptimizer
    from repro.runtime.optimizer import OptimizerConfig as JaxConfig
    from repro.runtime.steps import build_train_step as jax_build_train_step
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import train_state_from_jax
    from repro_torch.runtime.optimizer import OptimizerConfig

    torch.set_num_threads(1)  # as the test runs
    n = 3
    for arch in archs:
        jm, jp, tm = fam._jax_pair(arch)
        batches = [fam._batch(tm.cfg, 10 + i) for i in range(n)]
        shape = (fam._positions(batches[0]), fam.B)
        bundle = jax_build_train_step(jm, make_mesh((1, 1), ("data", "model")),
                                      JaxShape("t", *shape, "train"), JaxConfig(**fam.KW),
                                      grad_accum=1, donate=False)
        jp, js = jax.device_put((jp, JaxOptimizer(JaxConfig(**fam.KW)).init(jp)),
                                bundle.in_shardings[:2])
        start = jax.tree.map(np.asarray, {"params": jp, "opt": js})
        jflat = lambda tree: jax_paths(jax.tree.map(np.asarray, tree))  # noqa: E731
        chains = {"jax": _chain(lambda p, o, b: bundle.fn(p, o, fam._jax(b)), jp, js, batches, jflat)}
        state = train_state_from_jax(start, "cpu")
        fn = steps.build_train_step(tm, ShapeConfig("t", *shape, "train"),
                                    OptimizerConfig(**fam.KW), grad_accum=1, device="cpu")
        chains["port"] = _chain(fn, state["params"], state["opt"], batches, tree_flatten_with_paths)
        saved = [m.torch for m in MODULES]
        try:
            for m in MODULES:
                m.torch = _F64Torch()
            tm.compute_dtype = torch.float64
            state = train_state_from_jax(start, "cpu")
            state = tree_map_with_paths(
                lambda _, x: x.to(torch.float64) if x.is_floating_point() else x, state)
            fn = steps.build_train_step(tm, ShapeConfig("t", *shape, "train"),
                                        OptimizerConfig(**fam.KW), grad_accum=1, device="cpu")
            chains["f64"] = _chain(fn, state["params"], state["opt"], batches, tree_flatten_with_paths)
        finally:
            for m, t in zip(MODULES, saved):
                m.torch = t
        for step in range(n):
            cells = []
            for a, b in (("port", "f64"), ("jax", "f64"), ("port", "jax")):
                (ma, ba, aa, mma), (mb, bb, ab, mmb) = chains[a][step], chains[b][step]
                upd = mom = 0.0
                for path in ab:
                    m = np.abs(chains["jax"][step][3][path])
                    live = m > fam.GRAD_TOL[arch] * m.max()
                    du, dref = aa[path] - ba[path], ab[path] - bb[path]
                    upd = max(upd, float(np.linalg.norm((du - dref)[live])
                                         / np.linalg.norm(chains["jax"][step][2][path]
                                                          - chains["jax"][step][1][path])))
                    mom = max(mom, float(np.abs(mma[path] - mmb[path]).max()
                                         / np.abs(mmb[path]).max()))
                cells.append(f"{a}-{b} loss {abs(ma['loss'] - mb['loss']) / abs(mb['loss']):.1e} "
                             f"norm {abs(ma['grad_norm'] - mb['grad_norm']) / mb['grad_norm']:.1e} "
                             f"update {upd:.1e} moment {mom:.1e}")
            print(f"{arch} step {step + 1}: " + " | ".join(cells), flush=True)


def bf16_main(archs: list[str]) -> None:
    import json

    import jax.numpy as jnp

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro.configs.registry import get_arch as jax_get_arch
    from repro.models import build_model as jax_build_model
    from repro_torch.models import build_model

    torch.set_num_threads(8)
    for arch in archs:
        runs, params = {}, None
        for compute in ("float32", "bfloat16"):
            cfg, batches = cs.family_check(arch, compute)
            tm = build_model(cfg.replace(remat="none"))
            if params is None:
                params = tm.init(torch.Generator().manual_seed(cs.SEED))
            over = {k: getattr(cfg, k) for k in ("n_layers", "n_enc_layers", "n_patches",
                                                 "param_dtype", "compute_dtype")}
            jm = jax_build_model(jax_get_arch(arch).replace(remat="none", **over))
            jp = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params)
            (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
                jp, {k: jnp.asarray(v) for k, v in batches[0].items()})
            runs["jax", compute] = (float(jl), {p: torch.from_numpy(np.asarray(g, np.float64))
                                               for p, g in jax_paths(jax.tree.map(np.asarray, jg))})
            del jp, jg
            p = tree_map_with_paths(lambda _, x: x.clone().requires_grad_(True), params)
            loss, _ = tm.loss(p, {k: torch.from_numpy(v) for k, v in batches[0].items()})
            loss.backward()
            runs["port", compute] = (float(loss.detach()), {path: x.grad.double() for path, x
                                                            in tree_flatten_with_paths(p)})
            del p
        loss0, g0 = runs["port", "float32"]
        out = {"model": arch, "reference": "port cpu float32",
               "grad_norm_reference": float(sum(x.norm() ** 2 for x in g0.values()) ** 0.5)}
        for key in (("jax", "float32"), ("jax", "bfloat16"), ("port", "bfloat16")):
            loss, g = runs[key]
            leaf = {k: float((g[k] - g0[k]).norm() / g0[k].norm().clamp_min(1e-30)) for k in g0}
            out[" ".join(key)] = {
                "loss_rel": abs(loss - loss0) / abs(loss0),
                "grad_norm": float(sum(x.norm() ** 2 for x in g.values()) ** 0.5),
                "median_leaf_rel_l2": sorted(leaf.values())[len(leaf) // 2],
                "worst_leaf": max(leaf, key=leaf.get), "worst_leaf_rel_l2": max(leaf.values()),
                "leaf_rel_l2": leaf}
        print("bf16 " + json.dumps(out), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--steps"]:
        steps_main(sys.argv[2:] or list(fam.GRAD_TOL))
    elif sys.argv[1:2] == ["--bf16"]:
        bf16_main(sys.argv[2:] or list(fam.GRAD_TOL))
    else:
        main(sys.argv[1:] or list(fam.ARCHS))
