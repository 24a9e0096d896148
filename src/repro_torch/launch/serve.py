"""Streaming-serving launcher: request stream -> broker -> prefill/decode.

The paper's Type-1 pipeline (external instrument -> analysis): requests are
token prompts; the MASA serving app prefills and decodes a fixed budget per
request batch. On the card (the default):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --requests 8 --gen-tokens 8

On the CPU, at the reduced config: add ``--reduced --device cpu``.

Params are random, drawn from ``--seed`` on the serving device. The stream
registers its devices with the service's arbiter as a fixed request, so
other consumers of the pool see them held.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import PilotComputeService
from repro_torch.core.service import resolve_device
from repro_torch.elastic.metrics import MetricsBus
from repro_torch.launch import instrumented
from repro_torch.miniapps import LMServeApp, SourceConfig, TokenSource
from repro_torch.scheduler import ResourceRequest


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8, help="request batches to serve")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--mode", choices=("lockstep", "continuous"), default="lockstep")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)

    bus = MetricsBus()
    svc = PilotComputeService(devices=[device], metrics=bus)
    try:
        kafka = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"})
        cluster = kafka.get_context()
        cluster.create_topic("requests", 2)
        spark = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"})
        ctx = spark.get_context()
        held = len(spark.lease.devices)
        svc.get_arbiter(bus).submit(ResourceRequest(
            "launch/serve", min_devices=held, max_devices=held, target=held,
            current_fn=lambda: len(spark.lease.devices)))

        app = LMServeApp(cfg, prompt_len=args.prompt_len, gen_tokens=args.gen_tokens,
                         batch=args.batch, mode=args.mode, device=device)
        params = app.model.init(torch.Generator(device=device).manual_seed(args.seed))

        source = TokenSource(
            cluster, SourceConfig("requests", total_messages=args.requests),
            vocab_size=cfg.vocab_size, seq_len=args.prompt_len, seqs_per_msg=args.batch,
        ).start()
        stream = ctx.stream(
            cluster, "requests", group="server",
            process_fn=instrumented(app, bus, "serve"), state=params,
            batch_interval=0.1, max_batch_records=1,
            metrics=bus, metrics_label="serve",
        ).start()
        t0 = time.time()
        stream.await_batches(args.requests, timeout=3600)
        stream.stop()
        source.stop()
        dt = time.time() - t0
    finally:
        svc.cancel()
    print(f"[serve] {app.stats.messages} request batches, {app.stats.items} tokens "
          f"generated in {dt:.1f}s ({app.stats.items / dt:.1f} tok/s) on {device}")
    print(f"[serve] bus: step_time={bus.value('serve.step_time', stream='serve'):.3f}s "
          f"tokens_per_sec={bus.value('serve.tokens_per_sec', stream='serve'):.0f}")


if __name__ == "__main__":
    main()
