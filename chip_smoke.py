#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints the build seconds;
3. holds every kernel against its plain PyTorch version at the main path's
   shapes, on the same inputs, with the tolerance printed, and times kernel,
   plain version and (where one exists) a single PyTorch library call that
   computes the same function;
4. drives the Mini-App main path through the port's entry points: a
   ``PilotComputeService`` on the card with a ``kafka`` pilot (2 broker
   nodes) and a ``spark`` pilot, then (a) a K-Means cluster stream of
   5000 x 3 points per message into ``StreamingKMeans(10, 3)`` and (b) a
   light-source stream of 360 x 1448 sinograms reconstructed at n = 1448 by
   GridRec and by ML-EM; every kernel's launch count is set to 0 just
   before a path and read just after it;
5. prints one JSON line ``{"kernels": [...]}`` and, last, one JSON line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without printing the
last line. It refuses to run without CUDA or without the port's sources
beside it.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 rate
# outside the tensor cores — every kernel here does f32 arithmetic on CUDA
# cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_EPS = 2.0 ** -23

# the light-source stream: one 360 x 1448 f32 sinogram per message,
# reconstructed at one pixel per detector bin; ML-EM at the app's default
FRAME_ANGLES, FRAME_BINS, RECON_N, MLEM_ITERS = 360, 1448, 1448, 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time on the card for the work (ms) and what sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def check_assign(torch, kmeans, n: int, d: int, k: int, dtype, clustered: bool,
                 gen, timing: bool) -> dict:
    dev = torch.device("cuda", 0)
    if clustered:  # the cluster source's data: 10 centres in [-10, 10]^3, spread 0.5
        centers = torch.rand((k, d), generator=gen, device=dev) * 20 - 10
        idx = torch.randint(0, k, (n,), generator=gen, device=dev)
        points = centers[idx] + 0.5 * torch.randn((n, d), generator=gen, device=dev)
    else:
        points = torch.randn((n, d), generator=gen, device=dev)
    centroids = torch.randn((k, d), generator=gen, device=dev)
    points, centroids = points.to(dtype).contiguous(), centroids.to(dtype).contiguous()

    labels, dist = kmeans.assign_cuda(points, centroids)
    ref_labels, ref_dist = kmeans.assign_ref(points, centroids)
    torch.cuda.synchronize()
    # rounding of |p|^2 - 2 p.c + |c|^2 in f32, summed over D terms in two
    # orders: 8 (D + 2) eps_f32 (|p| + max|c|)^2 per point
    p, c = points.float(), centroids.float()
    scale = (p.norm(dim=1) + c.norm(dim=1).max()) ** 2
    tol = 8 * (d + 2) * 2.0 ** -24 * scale
    err = (dist - ref_dist).abs()
    if not bool(torch.isfinite(dist).all()) or bool((err > tol).any()):
        raise AssertionError(f"kmeans_assign {n}x{d}x{k} {dtype}: max err "
                             f"{float(err.max())}, worst err/tol {float((err / tol).max())}")
    # labels must agree wherever the best and second-best d^2 differ by
    # more than twice the tolerance
    d2 = (p * p).sum(1, keepdim=True) - 2 * p @ c.T + (c * c).sum(1)
    two = d2.topk(2, dim=1, largest=False).values if k > 1 else None
    clear = (two[:, 1] - two[:, 0] > 2 * tol) if two is not None else torch.ones_like(tol, dtype=torch.bool)
    bad = int(((labels != ref_labels) & clear).sum())
    if bad:
        raise AssertionError(f"kmeans_assign {n}x{d}x{k}: {bad} labels differ where the gap is clear")
    out = {"max_abs_err": float(err.max()), "tol": "8 (D+2) 2^-24 (|p| + max|c|)^2 per point",
           "worst_err_over_tol": float((err / tol).max()),
           "labels_differing_in_near_ties": int((labels != ref_labels).sum())}
    if timing:
        elem = points.element_size()
        n_bytes = n * d * elem + k * d * elem + n * 8
        n_ops = 2 * n * k * d + 3 * n * k + 2 * n * d
        out["bound_ms"], out["bound_by"] = bound(n_bytes, n_ops)
        out["ms"] = time_ms(torch, lambda: kmeans.assign_cuda(points, centroids), 50, 5)
        out["plain_ms"] = time_ms(torch, lambda: kmeans.assign_ref(points, centroids), 20, 3)
        out["library_ms"] = time_ms(torch, lambda: torch.cdist(points, centroids).min(1), 20, 3)
    return out


def check_tomo(torch, tomo, gen) -> tuple[dict, dict]:
    """Both projectors at the light-source path's shapes: 8 frames,
    360 angles, 1448 bins, n = 1448."""
    dev = torch.device("cuda", 0)
    b, a, n_det, n = 8, FRAME_ANGLES, FRAME_BINS, RECON_N
    angles = torch.from_numpy(tomo.angle_grid(a)).to(dev)
    cos_t, sin_t = tomo.trig(angles)
    sinos = torch.rand((b, a, n_det), generator=gen, device=dev)
    imgs = torch.rand((b, n, n), generator=gen, device=dev)

    bp = tomo.backproject_cuda(sinos, cos_t, sin_t, n)
    bp_ref = tomo.backproject_plain(sinos, cos_t, sin_t, n)
    fp = tomo.project_cuda(imgs, cos_t, sin_t, n_det)
    fp_ref = tomo.project_plain(imgs, cos_t, sin_t, n_det)
    torch.cuda.synchronize()
    results = []
    # inputs are non-negative, so max|ref| bounds the sum of |terms|; a sum
    # of m f32 terms in two orders differs by at most ~m eps_f32 of it
    for name, out, ref, terms in (("tomo_backproject", bp, bp_ref, a),
                                  ("tomo_project", fp, fp_ref, 4 * n)):
        err = float((out - ref).abs().max())
        tol = terms * F32_EPS * float(ref.abs().max())
        if not bool(torch.isfinite(out).all()) or err > tol:
            raise AssertionError(f"{name}: max err {err} > tol {tol}")
        results.append({"max_abs_err": err, "tol": tol,
                        "tol_rule": f"{terms} eps_f32 max|ref| (sum of {terms} terms)"})

    # adjointness on the card: <P x, y> = <x, B y>
    lhs = float((fp.double() * sinos.double()).sum())
    rhs = float((imgs.double() * bp.double()).sum())
    rel = abs(lhs - rhs) / abs(lhs)
    if rel > 1e-4:
        raise AssertionError(f"projectors not adjoint: <Px,y>={lhs} <x,By>={rhs} rel {rel}")
    results[0]["adjoint_rel_err"] = results[1]["adjoint_rel_err"] = rel

    # one interpolation per (frame, pixel, angle): 4 f32 operations, and 6
    # per (pixel, angle) for s, floor(s) and the two weights
    n_ops = b * n * n * a * 4 + n * n * a * 6
    trig_bytes = 2 * a * 4
    bp_bytes = b * a * n_det * 4 + trig_bytes + b * n * n * 4
    fp_bytes = b * n * n * 4 + trig_bytes + b * a * n_det * 4
    for res, bytes_, kern, plain, x in (
            (results[0], bp_bytes, tomo.backproject_cuda, tomo.backproject_plain, sinos),
            (results[1], fp_bytes, tomo.project_cuda, tomo.project_plain, imgs)):
        size = n if kern is tomo.backproject_cuda else n_det
        res["bound_ms"], res["bound_by"] = bound(bytes_, n_ops)
        res["ms"] = time_ms(torch, lambda: kern(x, cos_t, sin_t, size), 5, 1)
        res["plain_ms"] = time_ms(torch, lambda: plain(x, cos_t, sin_t, size), 2, 1)
        res["library_ms"] = None  # no single PyTorch call computes a projector
    return results[0], results[1]


def check_quality(torch, tomo) -> dict:
    """The repo's own reconstruction check, on the card and through the
    kernels: on a small phantom ML-EM beats GridRec and stays within half
    the image's RMS."""
    dev = torch.device("cuda", 0)
    n, a = 48, 60
    img = tomo.shepp_logan(n).to(dev)
    angles = torch.from_numpy(tomo.angle_grid(a)).to(dev)
    sino = tomo.project(img, angles, n + 16)
    e_grid = float(((tomo.gridrec(sino, angles, n) - img) ** 2).mean().sqrt())
    e_mlem = float(((tomo.mlem(sino, angles, n, iters=16) - img) ** 2).mean().sqrt())
    rms = float((img ** 2).mean().sqrt())
    if not (e_mlem < e_grid and e_mlem < 0.5 * rms):
        raise AssertionError(f"quality ordering broken: mlem {e_mlem}, gridrec {e_grid}, rms {rms}")
    return {"rmse_gridrec": e_grid, "rmse_mlem": e_mlem, "rms_image": rms}


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def drive(stream, source, n_batches: int, timeout: float) -> float:
    t0 = time.monotonic()
    stream.start()
    source.start()
    try:
        stream.await_batches(n_batches, timeout=timeout)
    finally:
        stream.stop()
        source.stop()
    return time.monotonic() - t0


def report(name: str, app, stream, wall: float) -> dict:
    lat = app.stats.latency
    out = {"path": name, "batches": stream.stats.batches, "messages": app.stats.messages,
           "wall_s": wall, "msgs_per_s": app.stats.messages / wall,
           "latency_p50_s": lat.p50, "latency_p99_s": lat.p99}
    print("path " + json.dumps(out))
    return out


def kmeans_path(torch, kernels, miniapps, cluster, ctx, device) -> dict:
    inertias: list[float] = []

    class TracedKMeans(miniapps.StreamingKMeans):
        def _on_complete(self, result, meta, dt):
            super()._on_complete(result, meta, dt)
            inertias.append(self._inertia)

    cluster.create_topic("points", 8)
    source = miniapps.KMeansClusterSource(
        cluster, miniapps.SourceConfig("points", total_messages=640, n_producers=4, seed=SEED),
        n_clusters=10, dim=3, points_per_msg=5000)
    app = TracedKMeans(10, 3, seed=SEED, device=device)
    stream = ctx.stream(cluster, "points", group="kmeans", process_fn=app.process,
                        batch_interval=0.05, max_batch_records=16)
    kernels.reset_launches()
    wall = drive(stream, source, 20, 300)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    centroids = stream.state
    if not bool(torch.isfinite(centroids).all()) or centroids.shape != (10, 3):
        raise AssertionError(f"bad centroids {centroids}")
    if not inertias[-1] < inertias[0]:
        raise AssertionError(f"inertia did not fall: {inertias}")
    out = report("kmeans", app, stream, wall)
    out["inertia_first"], out["inertia_last"] = inertias[0], inertias[-1]
    return {"report": out, "launches": launches}


def recon_path(torch, kernels, miniapps, tomo, cluster, ctx, device) -> dict:
    a, n_det, n = FRAME_ANGLES, FRAME_BINS, RECON_N
    kernels.reset_launches()
    reports, states = [], {}
    payload = None
    for algo in ("gridrec", "mlem"):
        topic = f"frames_{algo}"
        cluster.create_topic(topic, 4)
        source = miniapps.LightsourceTemplateSource(
            cluster, miniapps.SourceConfig(topic, total_messages=32, n_producers=2, seed=SEED),
            n_angles=a, n_det=n_det)
        payload = source._payload
        app = miniapps.ReconstructionApp(algo, n=n, mlem_iters=MLEM_ITERS, device=device)
        # backpressure off: every micro-batch fills to 8 frames
        stream = ctx.stream(cluster, topic, group=algo, process_fn=app.process,
                            batch_interval=0.5, max_batch_records=8, backpressure=False)
        wall = drive(stream, source, 4, 600)
        state = stream.state
        if state.shape != (n, n) or not bool(torch.isfinite(state).all()):
            raise AssertionError(f"{algo}: bad reconstruction {tuple(state.shape)}")
        states[algo] = state
        reports.append(report(algo, app, stream, wall))
    launches = {k.name: k.launches for k in kernels.KERNELS}

    # hold the last reconstructions (every frame is the template payload)
    # against the plain versions on the same frame
    sino = torch.from_numpy(payload).to(device)[None]
    angles = torch.from_numpy(tomo.angle_grid(a)).to(device)
    cos_t, sin_t = tomo.trig(angles)
    filtered = tomo.ramp_filter(sino)
    scale = math.pi / (2 * a)
    grid_ref = tomo.backproject_plain(filtered, cos_t, sin_t, n)[0] * scale
    grid_abs = tomo.backproject_plain(filtered.abs(), cos_t, sin_t, n)[0] * scale
    x = torch.ones((1, n, n), device=device)
    norm = tomo.backproject_plain(torch.ones_like(sino), cos_t, sin_t, n) + 1e-6
    for _ in range(MLEM_ITERS):
        fp = tomo.project_plain(x, cos_t, sin_t, n_det)
        x = x * tomo.backproject_plain(sino / fp.clamp_min(1e-6), cos_t, sin_t, n) / norm
    checks = {}
    for algo, ref, tol in (
            # GridRec: one backprojection of signed terms, one per angle
            ("gridrec", grid_ref, a * F32_EPS * float(grid_abs.max())),
            # ML-EM: its projections and backprojections of ratio
            # updates compound the per-pass rounding; 1e-3 of the peak
            ("mlem", x[0], 1e-3 * float(x.abs().max()))):
        err = float((states[algo] - ref).abs().max())
        if err > tol:
            raise AssertionError(f"{algo} reconstruction vs plain: max err {err} > tol {tol}")
        checks[algo] = {"max_abs_err": err, "tol": tol}
    print("recon_vs_plain " + json.dumps(checks))
    return {"reports": reports, "launches": launches}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels, miniapps
    from repro_torch.core import PilotComputeService
    from repro_torch.kernels import kmeans, tomo

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    build_s = kernels.build_all()
    print(f"build: {build_s:.1f} s for {len(kernels.KERNELS)} kernels")
    for lib in dict.fromkeys(k.library for k in kernels.KERNELS):
        if lib.log_path.exists():
            for line in lib.log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {lib.source.name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    assign_main = check_assign(torch, kmeans, 80_000, 3, 10, torch.float32, True, gen, True)
    print("check kmeans_assign 80000x3x10 f32 " + json.dumps(assign_main))
    wide = check_assign(torch, kmeans, 65_536, 128, 1024, torch.float32, False, gen, True)
    print("check kmeans_assign 65536x128x1024 f32 " + json.dumps(wide))
    bf16 = check_assign(torch, kmeans, 80_000, 3, 10, torch.bfloat16, True, gen, False)
    print("check kmeans_assign 80000x3x10 bf16 " + json.dumps(bf16))
    bp, fp = check_tomo(torch, tomo, gen)
    print("check tomo_backproject 8x360x1448 n=1448 " + json.dumps(bp))
    print("check tomo_project 8x1448x1448 A=360 " + json.dumps(fp))
    print("check quality " + json.dumps(check_quality(torch, tomo)))

    svc = PilotComputeService()
    try:
        broker = svc.submit_pilot({"number_of_nodes": 2, "type": "kafka"})
        spark = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"})
        cluster, ctx = broker.get_context(), spark.get_context()
        device = ctx.devices[0]
        km = kmeans_path(torch, kernels, miniapps, cluster, ctx, device)
        rc = recon_path(torch, kernels, miniapps, tomo, cluster, ctx, device)
    finally:
        svc.cancel()
    launches = {"kmeans_assign": km["launches"]["kmeans_assign"],
                "tomo_backproject": rc["launches"]["tomo_backproject"],
                "tomo_project": rc["launches"]["tomo_project"]}
    print("launches " + json.dumps({"kmeans_path": km["launches"], "lightsource_path": rc["launches"]}))
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    src = "src/repro_torch/kernels/csrc/"
    rows = [
        ("kmeans_assign", src + "kmeans_assign.cu", "src/repro/kernels/kmeans/kernel.py:45", assign_main),
        ("tomo_backproject", src + "tomo.cu", "src/repro/kernels/tomo/kernel.py:86", bp),
        ("tomo_project", src + "tomo.cu", "src/repro/kernels/tomo/kernel.py:107", fp),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, source, replaces, r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
