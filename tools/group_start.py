#!/usr/bin/env python3
"""Where a training rank group's start and first step go, on the GPU machine.

    python3 tools/group_start.py [--layers 5]

``LMTrainApp(mesh=...)`` starts a rank group (``launch/mesh.py``
``RankGroup``) at first use and at every rescale: spawned processes that
each join a fresh process group, build the mesh step and take the state's
tiles. This spawns such ranks by hand, the ranks of one group side by
side, each stamping the steps it takes: ``import torch``, the port's
modules, the CUDA context, ``init_process_group``, the mesh, the model and
its mesh step, the state's tiles (smollm-135m at full width, ``--layers``
layers, f32, drawn in the rank), ``import torch._dynamo`` (the first call
of ``torch.utils.checkpoint``, under remat, imports it), loading the
kernels' libraries, then two train steps on one batch of 8 x 128 tokens,
each synchronised. Groups: one gloo rank, one NCCL rank, four gloo ranks
as a (2, 2) mesh, all on ``cuda:0``. Seconds are from ``Process.start()``
in the parent, each step's own beside it. Needs a CUDA card; builds the
kernels first if they are not built.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _rank(q, rank: int, shape: tuple, backend: str, store: str, layers: int, t0: float) -> None:
    stamps = [("spawned", time.time() - t0)]

    def stamp(name: str) -> None:
        stamps.append((name, time.time() - t0))

    import torch

    stamp("import_torch")
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_mesh_train_step, mesh_train_state

    stamp("import_port")
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    stamp("cuda_context")
    world = shape[0] * shape[1]
    dist.init_process_group(backend, init_method=store, world_size=world, rank=rank)
    stamp("init_process_group")
    mesh = make_mesh(shape, ("data", "model"), device="cuda:0")
    stamp("make_mesh")
    cfg = get_arch("smollm-135m").replace(n_layers=layers, compute_dtype="float32")
    model = build_model(cfg)
    opt_cfg = OptimizerConfig(learning_rate=3e-4, warmup_steps=5, total_steps=20)
    step = build_mesh_train_step(model, ShapeConfig("probe", 128, 8, "train"), opt_cfg, mesh)
    stamp("mesh_step")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    params, opt = mesh_train_state(model, params, Optimizer(opt_cfg).init(params), mesh)
    torch.cuda.synchronize()
    stamp("tiles")
    import torch._dynamo  # noqa: F401

    stamp("import_dynamo")
    _build.forbid_builds()
    _build.load_all()
    stamp("load_libraries")
    tokens = torch.randint(0, cfg.vocab_size, (8, 128), generator=torch.Generator().manual_seed(1))
    for i in range(2):
        params, opt, met = step(params, opt, {"tokens": tokens})
        float(met["loss"])
        stamp(f"step_{i + 1}")
    dist.destroy_process_group()
    q.put((rank, stamps))


def group(shape: tuple, backend: str, layers: int) -> list:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = f"file://{tempfile.mkdtemp(prefix='group-start-')}/store"
    t0 = time.time()
    procs = [ctx.Process(target=_rank, args=(q, r, shape, backend, store, layers, t0))
             for r in range(shape[0] * shape[1])]
    for p in procs:
        p.start()
    out = sorted(q.get(timeout=600) for _ in procs)
    for p in procs:
        p.join(timeout=30)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=5)
    args = ap.parse_args()
    import subprocess

    from repro_torch import kernels

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    kernels.build_all()
    for shape, backend in (((1, 1), "gloo"), ((1, 1), "nccl"), ((2, 2), "gloo")):
        for rank, stamps in group(shape, backend, args.layers):
            steps = {name: round(t - prev, 3) for (name, t), (_, prev) in
                     zip(stamps[1:], stamps[:-1])}
            print(f"group_start {shape} {backend} rank {rank} " + json.dumps(
                {"at_s": {name: round(t, 3) for name, t in stamps}, "step_s": steps}))


if __name__ == "__main__":
    main()
