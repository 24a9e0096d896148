"""Roofline analysis over dry-run records, for the H100.

Own counterpart of the JAX package's ``launch/roofline.py``. Terms, per
device (the dry run traces one rank's step, so its counts are per device
already):

    compute    = flops / peak FLOP/s
    memory     = bytes (the fused model's) / HBM rate
    collective = in-node payload / NVLink rate + the rest / the NIC's rate

MODEL_FLOPS = 6 N D (train, dense), 6 N_active D (train, MoE), 2 N D
(inference), D = tokens processed per step. The roofline fraction is
ideal_compute_time / max(term), the score a perfect overlap schedule would
reach given the traced operators; decode shapes are scored against the
memory roofline (params and cache read once a step).

A Mini-App stream's cell (``kind`` ``stream``: one K-Means, GridRec or
ML-EM batch, ``launch/dryrun.py``) runs its kernels in f32 on the CUDA
cores: its compute term is its FLOPs (the kernels' formulas) over the f32
rate, its useful FLOPs are those FLOPs, and its score is the larger of the
compute and the bytes its inputs and outputs need (read and written once)
over max(term); a stream's rows get a table of their own.

The peaks are NVIDIA's datasheet figures for the H100 SXM5 80GB (700 W),
not measurements: 989e12 dense bf16 FLOP/s on the tensor cores, 3.35e12 B/s
of HBM3, NVLink 900 GB/s a GPU (450 GB/s each way, the rate a collective's
payload crosses at), and one 400 Gb/s (50 GB/s) NIC a GPU between nodes of
8 GPUs (:data:`H100`). Every function takes the peaks as an argument with
the H100's as the default, so the reference's (v5e) can be handed in.

Records keep the reference's keys (``memory``, ``peak_bytes_per_device``,
``cost_analysis``, ``hlo``), so :func:`analyze_record` reads either
package's record; the port's ``hlo`` entry holds the traced counts
(``runtime/cost_analysis.py``), with the collective bytes split into in-node
and across-node payloads, and ``trace_s`` stands where the reference has
``lower_s`` and ``compile_s``. A record without the split (the
reference's) puts every payload on the in-node link.

  PYTHONPATH=src python -m repro_torch.launch.roofline --in dryrun.json
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    """Per-device peak rates: FLOP/s, HBM B/s, in-node link B/s, across-node
    link B/s."""

    name: str
    flops: float
    hbm: float
    link_in_node: float
    link_across_nodes: float
    #: f32 FLOP/s outside the tensor cores (the Mini-App kernels' rate);
    #: None: ``flops``
    flops_f32: float | None = None


#: NVIDIA H100 SXM5 80GB (700 W) datasheet figures (not measured): dense
#: bf16 on the tensor cores, HBM3, NVLink's 900 GB/s a GPU taken as 450 GB/s
#: each way, one 400 Gb/s NIC a GPU
H100 = Peaks("H100 SXM5 80GB (700 W), datasheet", flops=989e12, hbm=3.35e12,
             link_in_node=450e9, link_across_nodes=50e9, flops_f32=67e12)
#: GPUs a node (consecutive ranks) share NVLink among; a collective whose
#: group spans more crosses the NIC (``runtime/cost_analysis.py`` splits
#: the payloads by it)
NODE_GPUS = 8
#: the same datasheet's f32 rate outside the tensor cores and dense TF32
#: rate on them (the kernel checks of ``chip_smoke.py`` bound f32 work by them)
H100_F32_FLOPS = H100.flops_f32
H100_TF32_FLOPS = 494.5e12

_PARAM_CACHE: dict[str, tuple[int, int]] = {}


def param_counts(arch: str) -> tuple[int, int]:
    if arch not in _PARAM_CACHE:
        from repro_torch.configs.registry import get_arch

        cfg = get_arch(arch)
        _PARAM_CACHE[arch] = (cfg.param_count(), cfg.active_param_count())
    return _PARAM_CACHE[arch]


def model_flops(arch: str, shape_kind: str, seq_len: int, global_batch: int, chips: int) -> float:
    n_total, n_active = param_counts(arch)
    if shape_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens / chips
    if shape_kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens / chips
    # decode: one token per sequence
    return 2.0 * n_active * global_batch / chips


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops: float
    fraction: float
    #: decode shapes are inherently memory-bound: efficiency is measured
    #: against the *memory* roofline (params + cache read once per step)
    mem_fraction: float = 0.0
    peak_gb: float = 0.0
    kind: str = ""

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def score(self) -> float:
        """Roofline fraction on the appropriate axis for the shape kind."""
        return self.mem_fraction if self.shape.startswith(("decode", "long")) else self.fraction


_IDEAL_BYTES_CACHE: dict[tuple[str, str], float] = {}


def ideal_decode_bytes_per_chip(arch: str, shape_name: str, chips: int) -> float:
    """Minimum HBM traffic per decode step: param shard + KV/state shard,
    each read once."""
    key = (arch, shape_name)
    if key not in _IDEAL_BYTES_CACHE:
        from repro_torch.configs.registry import get_arch, get_shape
        from repro_torch.models import build_model
        from repro_torch.utils.tree import tree_bytes

        cfg = get_arch(arch)
        model = build_model(cfg)
        shape = get_shape(shape_name)
        _IDEAL_BYTES_CACHE[key] = float(
            tree_bytes(model.param_struct()) + tree_bytes(model.cache_struct(shape))
        )
    return _IDEAL_BYTES_CACHE[key] / chips


_SUGGESTIONS = {
    "compute": "reduce redundant compute: selective remat / causal-skip attention / smaller capacity factor",
    "memory": "raise arithmetic intensity: larger per-chip batch, fused kernels, bf16 end-to-end",
    "collective": "cut collective volume: reduce-scatter instead of all-gather, ring attention, quantized cross-pod grads",
}


def collective_seconds(hlo: dict, peaks: Peaks = H100) -> float:
    """The collective term: in-node payloads over the in-node link, the rest
    over the across-node link; a record without the split (the
    reference's) puts every payload on the in-node link."""
    if "collective_bytes_in_node_per_device" not in hlo:
        return hlo["collective_bytes_per_device"] / peaks.link_in_node
    return (hlo["collective_bytes_in_node_per_device"] / peaks.link_in_node
            + hlo["collective_bytes_across_nodes_per_device"] / peaks.link_across_nodes)


def analyze_stream(rec: dict, peaks: Peaks = H100) -> RooflineRow:
    """A Mini-App stream's cell: f32 compute, the ideal the larger of its
    FLOPs at the f32 rate and its inputs' and outputs' bytes at the HBM rate."""
    hlo = rec["hlo"]
    compute = hlo["flops_per_device"] / (peaks.flops_f32 or peaks.flops)
    memory = hlo.get("bytes_fused_per_device", hlo["bytes_per_device"]) / peaks.hbm
    collective = collective_seconds(hlo, peaks)
    terms = {"compute": compute, "memory": memory, "collective": collective}
    dominant = max(terms, key=terms.get)
    io = rec["memory"]["argument_bytes"] + rec["memory"]["output_bytes"]
    ideal = max(compute, io / peaks.hbm)
    return RooflineRow(rec["arch"], rec["shape"], rec["mesh"], compute, memory, collective,
                       dominant, hlo["flops_per_device"], hlo["flops_per_device"],
                       ideal / max(max(terms.values()), 1e-30), 0.0,
                       rec.get("peak_bytes_per_device", 0) / 1e9, "stream")


def analyze_record(rec: dict, peaks: Peaks = H100) -> RooflineRow | None:
    if "hlo" not in rec:
        return None
    if rec.get("kind") == "stream":
        return analyze_stream(rec, peaks)
    from repro_torch.configs.registry import get_shape

    shape = get_shape(rec["shape"])
    hlo = rec["hlo"]
    compute = hlo["flops_per_device"] / peaks.flops
    # fused-model bytes = the realistic HBM traffic; the conservative
    # every-op model is reported alongside as the upper bound
    memory = hlo.get("bytes_fused_per_device", hlo["bytes_per_device"]) / peaks.hbm
    collective = collective_seconds(hlo, peaks)
    terms = {"compute": compute, "memory": memory, "collective": collective}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], shape.kind, shape.seq_len, shape.global_batch, rec["chips"])
    ideal = mf / peaks.flops
    fraction = ideal / max(max(terms.values()), 1e-30)
    mem_fraction = 0.0
    if shape.kind == "decode":
        ideal_mem = ideal_decode_bytes_per_chip(rec["arch"], rec["shape"], rec["chips"]) / peaks.hbm
        mem_fraction = ideal_mem / max(max(memory, collective), 1e-30)
    return RooflineRow(
        rec["arch"], rec["shape"], rec["mesh"], compute, memory, collective,
        dominant, mf, hlo["flops_per_device"], fraction, mem_fraction,
        rec.get("peak_bytes_per_device", 0) / 1e9,
    )


def render_markdown(rows: list[RooflineRow]) -> str:
    out = [
        "| arch | shape | mesh | compute (s) | memory (s) | collective (s) | bottleneck | MODEL/HLO flops | roofline fraction* |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        frac = f"{r.score:.1%}" + (" (mem)" if r.shape.startswith(("decode", "long")) else "")
        out.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3e} | {r.memory_s:.3e} "
            f"| {r.collective_s:.3e} | **{r.dominant}** | {r.useful_ratio:.2f} | {frac} |"
        )
    out.append("")
    out.append("\\* train/prefill: fraction of the bf16 compute roofline; "
               "decode: fraction of the HBM roofline (params+cache read once per step).")
    return "\n".join(out)


def render_cells(rows: list[RooflineRow]) -> str:
    """One line a (arch, shape): for each mesh, the peak GB a device and
    the compute, memory and collective seconds with the bottleneck (the
    estimate's table in ``PERF.md``)."""
    meshes = sorted({r.mesh for r in rows}, key=len)
    cells: dict = {}
    for r in rows:
        cells.setdefault((r.arch, r.shape), {})[r.mesh] = r
    head = " | ".join(f"{m}: peak GB, compute / memory / collective s, bound" for m in meshes)
    out = [f"| arch | shape | {head} |", "|---|---|" + "---|" * len(meshes)]
    for (arch, shape), by_mesh in cells.items():
        parts = []
        for m in meshes:
            r = by_mesh.get(m)
            parts.append("-" if r is None else
                         f"{r.peak_gb:.2f}, {r.compute_s:.3g} / {r.memory_s:.3g} / "
                         f"{r.collective_s:.3g}, **{r.dominant}**")
        out.append(f"| {arch} | {shape} | " + " | ".join(parts) + " |")
    return "\n".join(out)


def render_streams(rows: list[RooflineRow]) -> str:
    """The Mini-App streams' cells: one batch's peak GB, FLOPs and compute,
    memory and collective seconds, bottleneck and score."""
    out = ["| stream | batch | peak GB | FLOPs | compute / memory / collective s | bound | "
           "roofline fraction |", "|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r.arch} | {r.shape} | {r.peak_gb:.3f} | {r.hlo_flops:.4g} | "
                   f"{r.compute_s:.3g} / {r.memory_s:.3g} / {r.collective_s:.3g} | "
                   f"**{r.dominant}** | {r.score:.1%} |")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="infile", required=True)
    ap.add_argument("--out", default=None, help="write markdown here")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    with open(args.infile) as f:
        records = json.load(f)
    rows, skips = [], []
    for rec in records:
        if "skipped" in rec:
            skips.append(rec)
            continue
        row = analyze_record(rec)
        if row:
            rows.append(row)
    lm = [r for r in rows if r.kind != "stream"]
    streams = [r for r in rows if r.kind == "stream"]
    parts = ([render_markdown(lm), render_cells(lm)] if lm else []) + (
        [render_streams(streams)] if streams else [])
    md = "\n\n".join(parts)
    md += (f"\n\nPeaks: {H100.name}: {H100.flops:.3e} FLOP/s, {H100.hbm:.3e} B/s HBM, "
           f"{H100.link_in_node:.3e} B/s in a node, {H100.link_across_nodes:.3e} B/s across "
           f"nodes, {H100.flops_f32:.3e} f32 FLOP/s (the streams' kernels).")
    md += "\n\nSkipped cells:\n" + "\n".join(
        f"- {s['arch']} x {s['shape']}: {s['skipped']}" for s in skips
    )
    md += "\n\nSuggested lever per bottleneck:\n" + "\n".join(
        f"- {k}: {v}" for k, v in _SUGGESTIONS.items()
    )
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
        print(f"wrote {args.out}")
    else:
        print(md)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([r.__dict__ | {"useful_ratio": r.useful_ratio} for r in rows], f, indent=1)


if __name__ == "__main__":
    main()
