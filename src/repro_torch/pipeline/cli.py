"""``python -m repro_torch.pipeline`` — run and validate declarative
pipeline specs on the card.

    python -m repro_torch.pipeline validate spec.json [--import mymodule]
    python -m repro_torch.pipeline run spec.json --devices 8 [--duration 10] [--share 2]
    python -m repro_torch.pipeline run spec.json --device cpu --devices 4

``--devices N`` is the pool's slot count, spread over the host's CUDA cards
(on one card, N slots of that card); ``--device cpu`` makes the N slots CPU
devices instead. Without CUDA, ``run`` refuses unless ``--device cpu`` is
given.

``validate`` rehydrates a ``Pipeline`` from the JSON spec and prints the
**full** error list of ``Pipeline.validate()`` — the checks ``Pipeline.build()`` runs,
so a spec that validates here will provision. ``--import`` loads modules
first so custom processors/sources/sinks registered at import time are
known to the validator (and the runner).
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from repro_torch.pipeline.builder import Pipeline
from repro_torch.pipeline.spec import PipelineSpec


def _load_spec(path: str) -> PipelineSpec:
    with open(path) as f:
        return PipelineSpec.from_dict(json.load(f))


def _import_modules(mods: list[str]) -> None:
    for m in mods:
        importlib.import_module(m)


def _validate(spec: PipelineSpec) -> list[str]:
    return Pipeline.from_spec(spec).validate()


def cmd_validate(args: argparse.Namespace) -> int:
    _import_modules(args.imports)
    spec = _load_spec(args.spec)
    errors = _validate(spec)
    if errors:
        print(f"invalid pipeline {spec.name!r} ({len(errors)} problem"
              f"{'s' if len(errors) != 1 else ''}):", file=sys.stderr)
        for e in errors:
            print(f"  - {e}", file=sys.stderr)
        return 1
    n_el = sum(1 for s in spec.stages if s.elastic is not None)
    print(f"{args.spec}: pipeline {spec.name!r} OK "
          f"({len(spec.broker.topics)} topics, {len(spec.sources)} sources, "
          f"{len(spec.stages)} stages [{n_el} elastic], "
          f"{len(spec.sinks)} sinks"
          f"{', elastic broker' if spec.broker.elastic else ''})")
    return 0


def cmd_run(args: argparse.Namespace) -> int:
    _import_modules(args.imports)
    spec = _load_spec(args.spec)
    errors = _validate(spec)
    if errors:
        print(f"invalid pipeline {spec.name!r}:", file=sys.stderr)
        for e in errors:
            print(f"  - {e}", file=sys.stderr)
        return 1
    finite = all(s.total_messages is not None for s in spec.sources) and spec.sources
    if args.device == "cpu":
        devices = [torch.device("cpu")] * (args.devices or 1)
    else:
        devices = args.devices
    with spec.run(devices=devices, share=args.share) as run:
        t0 = time.monotonic()
        next_report = args.report_every
        try:
            while True:
                elapsed = time.monotonic() - t0
                if args.duration is not None and elapsed >= args.duration:
                    break
                time.sleep(0.25)  # poll fast, print at --report-every cadence
                lags = {s.name: run.lag(s.name) for s in spec.stages}
                if elapsed >= next_report:
                    next_report += args.report_every
                    devs = {n: c.devices for n, c in run.controllers.items()}
                    print(f"t={elapsed:6.1f}s  lag={lags}"
                          + (f"  devices={devs}" if devs else ""))
                # early exit only when finite sources have actually drained
                # their quotas AND consumers caught up — lag alone reads 0
                # whenever consumers merely keep pace with production
                if (finite and run.sources_finished
                        and all(v == 0 for v in lags.values())):
                    break
        except KeyboardInterrupt:
            pass
        for s in spec.stages:
            st = run.stream(s.name).stats
            records = getattr(st, "records", 0)
            print(f"stage {s.name!r}: {records} records")
    if run.errors:
        for e in run.errors:
            print(f"teardown error: {e!r}", file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.pipeline",
        description="Run/validate declarative streaming-pipeline specs "
                    "(repro_torch.pipeline)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    val = sub.add_parser("validate", help="check a spec, print every problem")
    val.add_argument("spec", help="path to a PipelineSpec JSON file")
    val.add_argument("--import", dest="imports", action="append", default=[],
                     metavar="MODULE",
                     help="import MODULE first (registers custom "
                          "processors/sources/sinks); repeatable")
    val.set_defaults(fn=cmd_validate)

    runp = sub.add_parser("run", help="provision and run a spec")
    runp.add_argument("spec", help="path to a PipelineSpec JSON file")
    runp.add_argument("--devices", type=int, default=None,
                      help="device slots, spread over the CUDA cards (default: one "
                           "per card; with --device cpu: 1)")
    runp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                      help="what a slot is: a CUDA card (default) or the CPU")
    runp.add_argument("--duration", type=float, default=10.0,
                      help="seconds to run (finite sources may stop earlier); "
                           "default 10")
    runp.add_argument("--share", type=float, default=None,
                      help="override the spec's pipeline-level fair-share weight")
    runp.add_argument("--report-every", type=float, default=1.0,
                      help="seconds between progress lines")
    runp.add_argument("--import", dest="imports", action="append", default=[],
                      metavar="MODULE", help="import MODULE first; repeatable")
    runp.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
