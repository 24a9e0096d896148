"""Streaming-training launcher: MASS token source -> broker -> micro-batch
train loop, with checkpointing and exactly-once offsets.

This is the paper's Type-2 pipeline (simulation/corpus -> analysis) with an
LM as the analysis stage. On the card (the default):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 20 --seq-len 128 --batch 8

On the CPU, at the reduced config: add ``--reduced --device cpu``. Without
``--device cpu`` it asks for CUDA and raises where there is none.

Every family whose batch is its tokens trains here: the dense and MoE
archs, ``--arch rwkv6-3b`` and ``--arch zamba2-1.2b``. A VLM or enc-dec
arch needs patch or frame embeddings that a token message does not carry:
``LMTrainApp`` refuses it, and ``build_train_step`` trains it with the
embeddings in its batch. A checkpoint is the whole train state (bf16
params and two f32 moments a param: rwkv6-3b's is about 31 GB), so a
smoke run that need not restore sets ``--checkpoint-every`` past its last
step and writes none.

The app trains over the devices the training pilot's lease holds, as the
reference's trains over every local device: ``--devices N`` makes the pool
N slots (round-robin over the host's CUDA cards, or N slots of the CPU with
``--device cpu``) and the lease takes them all. One device trains in this
process; more train on a ``(N, 1)`` ("data", "model") rank group of the
app's own (``LMTrainApp(mesh=...)``: NCCL over distinct cards, gloo over
slots of one card or of the CPU), whose checkpoints hold full leaves and
whose resume has each rank read its own tiles:

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --devices 2

Params are random, drawn on the (first) training device from a generator
seeded 0 (``LMTrainApp.init_state``). Every ``--checkpoint-every`` batches the train
state and the consumer offsets are saved (asynchronously) through the
port's ``CheckpointManager``, in the JAX package's format, under
``--checkpoint-dir`` (``build/train-ckpt`` in the checkout by default);
``--resume`` restores the latest one. The stream files its devices with the
service's arbiter as a fixed request, so other consumers of the pool see
them held.
"""
from __future__ import annotations

import argparse
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.core import PilotComputeService
from repro_torch.core.service import cuda_devices, resolve_device
from repro_torch.elastic.metrics import MetricsBus
from repro_torch.launch import instrumented
from repro_torch.launch.mesh import MeshSpec
from repro_torch.miniapps import LMTrainApp, SourceConfig, TokenSource
from repro_torch.runtime.optimizer import OptimizerConfig
from repro_torch.scheduler import ResourceRequest

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train-ckpt"


@dataclass
class TrainRun:
    """What a run leaves: the app (its losses and stats; ``close()`` it,
    which stops a rank group), the stopped stream (its final state and
    latency), the checkpoint manager, the metrics bus, the device (the
    first of the lease), and the wall seconds from the stream's start to
    the last checkpoint written."""
    app: LMTrainApp
    stream: Any
    ckpt: CheckpointManager
    bus: MetricsBus
    device: Any
    wall: float


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--devices", type=int, default=1,
                    help="slots of the pool the training pilot leases; more than one trains "
                         "on a rank group over them")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8, help="sequences per train step")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--broker-nodes", type=int, default=2)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--checkpoint-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    return ap.parse_args(argv)


def run(args: argparse.Namespace,
        on_save: Callable[[int, Any], None] | None = None) -> TrainRun:
    """The pipeline ``main`` runs, for ``parse_args``'s ``args``; ``on_save
    (step, state)`` is called after each checkpoint save is started."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    if args.devices < 1:
        raise ValueError(f"--devices {args.devices}: the pool needs a device")
    pool = [device]
    if args.devices > 1:
        cards = cuda_devices() if device.type == "cuda" else [device]
        pool = [cards[i % len(cards)] for i in range(args.devices)]

    bus = MetricsBus()
    svc = PilotComputeService(devices=pool, metrics=bus)
    app = None
    try:
        kafka = svc.submit_pilot({"number_of_nodes": args.broker_nodes, "type": "kafka"})
        cluster = kafka.get_context()
        cluster.create_topic("tokens", args.partitions)
        spark = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": len(pool),
                                  "type": "spark"})
        ctx = spark.get_context()
        leased = list(spark.lease.devices)
        device = leased[0]
        mesh = MeshSpec((len(leased), 1), leased) if len(leased) > 1 else None
        # file the training pilot's demand with the service's arbiter: a
        # static reservation, but pipelines sharing this pool see (and must
        # schedule around) the trainer's devices
        held = len(spark.lease.devices)
        svc.get_arbiter(bus).submit(ResourceRequest(
            "launch/train", min_devices=held, max_devices=held, target=held,
            current_fn=lambda: len(spark.lease.devices)))

        opt = OptimizerConfig(name=cfg.optimizer, learning_rate=args.lr, warmup_steps=5,
                              total_steps=max(args.steps, 10))
        app = LMTrainApp(cfg, mesh=mesh, opt_cfg=opt, seqs_per_step=args.batch,
                         seq_len=args.seq_len, device=device)
        ckpt = CheckpointManager(args.checkpoint_dir, keep_last=2, async_save=True)

        state = None
        if args.resume and ckpt.latest_step() is not None:
            state, meta = app.restore(ckpt)
            print(f"[train] resumed from step {ckpt.latest_step()} (offsets {meta.get('offsets')})")

        source = TokenSource(
            cluster,
            SourceConfig("tokens", total_messages=args.steps * 2 + 8, n_producers=2),
            vocab_size=cfg.vocab_size,
            seq_len=args.seq_len,
            seqs_per_msg=args.batch,
        ).start()

        # the stream's stop() waits for its loop only so long: a batch still
        # running after it must not start a save once the last one is waited
        # for, or the process would exit in the middle of the write
        saving = threading.Lock()
        stopped = False

        def checkpoint_fn(state, offsets):
            step = app.stats.batches
            with saving:
                if not stopped and step % args.checkpoint_every == 0 and state is not None:
                    ckpt.save(step, state, meta={"offsets": offsets, "arch": cfg.name})
                    if on_save is not None:
                        on_save(step, state)

        stream = ctx.stream(
            cluster, "tokens", group="trainer",
            process_fn=instrumented(app, bus, "train"), state=state,
            batch_interval=0.2, max_batch_records=1, checkpoint_fn=checkpoint_fn,
            metrics=bus, metrics_label="train",
        ).start()

        t0 = time.time()
        stream.await_batches(args.steps, timeout=3600)
        with saving:
            stopped = True
        stream.stop()
        source.stop()
        ckpt.wait()
        dt = time.time() - t0
    except BaseException:
        if app is not None and app.group is not None:
            app.group.stop()  # the ranks end with the run that failed
        raise
    finally:
        svc.cancel()
    return TrainRun(app, stream, ckpt, bus, device, dt)


def main(argv: list[str] | None = None) -> None:
    r = run(parse_args(argv))
    app, bus, dt = r.app, r.bus, r.wall
    try:
        toks = app.stats.items
        where = r.device if app.mesh is None else \
            f"a {app.mesh.shape} {app.mesh.backend} group of {', '.join(map(str, app.mesh.devices))}"
        print(f"[train] {app.stats.batches} steps, {toks} tokens in {dt:.1f}s "
              f"({toks / dt:.0f} tok/s) on {where}; loss {app.losses[0]:.3f} -> "
              f"{app.losses[-1]:.3f}")
        print(f"[train] bus: step_time={bus.value('train.step_time', stream='train'):.3f}s "
              f"tokens_per_sec={bus.value('train.tokens_per_sec', stream='train'):.0f}")
    finally:
        app.close()


if __name__ == "__main__":
    main()
