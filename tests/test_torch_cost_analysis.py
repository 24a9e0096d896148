"""The port's static cost analysis (``runtime/cost_analysis.py``), the
attention kernels as ``torch.library`` ops with their FLOP formulas, the
decode plain version on a cache shard, and the dry run
(``launch/dryrun.py``) on small fake meshes.

* The reference's tanh-MLP gradient (``tests/test_hlo_analysis.py``'s
  ``_compiled``), written in torch, counts exactly 3 L 2 32 128 128 FLOPs
  (every layer's input gradient taken, as the reference's scan body takes
  it); the reference's ``analyze_hlo`` of its scan lies within 10 % of that,
  and depth 8 counts exactly twice depth 4.
* The column-sharded ``x @ w`` of ``test_collective_bytes_on_sharded_module``
  on a fake 8-rank group counts one all-reduce of 4 bytes.
* Each attention op's fake output has its plain output's shape and dtype,
  ``FlopCounterMode`` over a CPU call counts the op's formula (not the plain
  version's products), and a ``meta`` tensor outside fake mode is refused.
* The decode plain version on 4 shards of a cache (``start`` and the
  log-sum-exp), merged, equals the JAX package's ``decode_attention`` over
  the whole cache within 1e-5 (f32); a row with no valid entry gives 0 and
  -inf.
* The dry run's records on ``reduced()`` configs over fake (2, 2) and
  (2, 2, 2) meshes, each step kind, have the reference's keys; a train
  cell's peak holds at least the rank's param and moment tiles; the FLOPs
  of all ranks sum to the one-device count of the same global step within
  1 % (train, prefill and decode: tensor-parallel serving repeats no
  product on the "model" ranks); a decode cell's arguments hold 1/n_model
  of every weight sharded on "model"; a MoE cell traces too.
* The Mini-App streams: one K-Means batch and one ML-EM batch traced under
  fake tensors count exactly their kernels' formulas (``PERF.md`` §6); the
  dry run lists the four Mini-App cells (``--all``), and each, traced at
  its full size on fake CPU tensors through the CLI, states its FLOPs,
  bytes and peak under the LM cells' keys and reads as a roofline row.

The cases that start a fake process group run in a subprocess (the group
is process-wide).
"""
import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.models.attention import decode_attention as jax_decode_attention
from repro.runtime.hlo_analysis import analyze_hlo
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import decode_attention_plain
from repro_torch.runtime.cost_analysis import trace_cost

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _run(code: str, timeout: float = 600) -> dict:
    """Run ``code`` in a fresh process (it owns the fake process group);
    its last printed line is a JSON object."""
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=timeout, cwd=ROOT,
                         env={**__import__("os").environ, "PYTHONPATH": "src"})
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    return json.loads(res.stdout.strip().splitlines()[-1])


# -- the counter -----------------------------------------------------------------


def _mlp_grad(L: int):
    def f(w, x):
        w.requires_grad_(True)
        x.requires_grad_(True)
        h = x
        for i in range(L):
            h = torch.tanh(h @ w[i])
        return torch.autograd.grad(h.sum(), (w, x))
    return trace_cost(f, torch.empty(L, 128, 128, device="meta"),
                      torch.empty(32, 128, device="meta"), device="cpu")[1]


def _jax_scan_grad(L: int):
    def f(w, x):
        def layer(x, wi):
            return jnp.tanh(x @ wi), ()
        x, _ = jax.lax.scan(layer, x, w)
        return x.sum()
    return jax.jit(jax.grad(f)).lower(jax.ShapeDtypeStruct((L, 128, 128), jnp.float32),
                                      jax.ShapeDtypeStruct((32, 128), jnp.float32)).compile()


def test_tanh_mlp_gradient_counts_the_analytic_flops():
    L = 8
    analytic = 3 * L * 2 * 32 * 128 * 128  # forward and the backward's two products
    cost = _mlp_grad(L)
    assert cost.flops == analytic
    ref = analyze_hlo(_jax_scan_grad(L).as_text()).flops
    assert abs(ref - analytic) / analytic < 0.10
    # the inputs (and the two gradients the step returns) are live at the end
    assert cost.input_bytes == (L * 128 * 128 + 32 * 128) * 4
    assert cost.peak_bytes >= cost.input_bytes + cost.output_bytes


def test_flops_scale_with_depth_exactly():
    assert _mlp_grad(8).flops == 2 * _mlp_grad(4).flops


def test_peak_counts_live_storage_once():
    """A chain that frees as it goes: the inputs, then at most two 4 KiB
    temporaries at once; an in-place update adds nothing."""
    def f(x):
        a = x * 2.0
        b = a + 1.0
        b.add_(1.0)
        return b
    _, c = trace_cost(f, torch.empty(1024, device="meta"), device="cpu")
    assert c.input_bytes == 4096 and c.peak_bytes == 3 * 4096
    assert c.bytes_moved == 4096 + 3 * 2 * 4096  # inputs once, each op's output twice
    _, c = trace_cost(f, torch.empty(1000, device="meta"), device="cuda")
    assert c.peak_bytes == 3 * 4096  # 4000 bytes a storage, in 512-byte blocks


def test_collective_bytes_on_a_sharded_product():
    out = _run("""
        import json, torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.runtime.collectives import psum
        from repro_torch.runtime.cost_analysis import trace_cost
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
        mesh = make_mesh((8,), ("model",), device="cpu")
        def f(x, w):  # w column-sharded: the rank's (256, 64) tile; a cross-shard sum
            return psum((x @ w).sum(), mesh, "model")
        _, c = trace_cost(f, torch.empty(64, 256, device="meta"),
                          torch.empty(256, 512 // 8, device="meta"), device="cpu")
        print(json.dumps({"counts": c.collective_counts, "bytes": c.collective_bytes,
                          "in_node": c.collective_bytes_in_node, "flops": c.flops}))
    """)
    assert out["counts"] == {"all-reduce": 1} and out["bytes"] == 4.0
    assert out["in_node"] == 4.0  # ranks 0-7: one node
    assert out["flops"] == 2 * 64 * 256 * 64


# -- the ops -----------------------------------------------------------------------


def _qkv(B=2, Sq=24, Skv=40, H=4, KV=2, hd=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, Sq, H, hd, generator=g), torch.randn(B, Skv, KV, hd, generator=g),
            torch.randn(B, Skv, KV, hd, generator=g))


def _pairs(sq, skv, causal, off):
    if not causal:
        return sq * skv
    return sum(min(max(off + i + 1, 0), skv) for i in range(sq))


def _cases():
    q, k, v = _qkv()
    out, lse = ops.flash_attention_lse(q, k, v, causal=True, q_offset=16)
    dout = torch.randn_like(out)
    pos = torch.tensor([5, 37])
    qd = q[:, :1].contiguous()
    B, H, hd = 2, 4, 32
    fl = lambda causal, off, per: per * hd * B * H * _pairs(24, 40, causal, off)  # noqa: E731
    valid = sum(min(max(int(p) - 8 + 1, 0), 40) for p in pos)
    return {
        "flash_attention": (ops.flash_attention_op, (q, k, v, True, 16), fl(True, 16, 4)),
        "flash_attention_lse": (ops.flash_attention_lse_op, (q, k, v, False, 0), fl(False, 0, 4)),
        "flash_attention_bwd": (ops.flash_attention_bwd_op, (q, k, v, out, lse, dout, True, 16),
                                fl(True, 16, 10)),
        "decode_attention": (ops.decode_attention_op, (qd, k, v, pos, 8), 4 * hd * H * valid),
        "decode_attention_lse": (ops.decode_attention_lse_op, (qd, k, v, pos, 8),
                                 4 * hd * H * valid),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_op_fake_outputs_match_the_plain_outputs(name):
    op, args, _ = _cases()[name]
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(t.shape, t.dtype) for t in fake] == [(t.shape, t.dtype) for t in real]


@pytest.mark.parametrize("name", list(_cases()))
def test_flop_counter_counts_the_op_formula_not_the_plain_products(name):
    op, args, want = _cases()[name]
    with FlopCounterMode(display=False) as fc:
        op(*args)
    assert fc.get_total_flops() == want
    assert list(fc.get_flop_counts()["Global"]) == [getattr(torch.ops.repro_torch, name)]


@pytest.mark.parametrize("name", list(_cases()))
def test_a_meta_tensor_outside_fake_mode_is_refused(name):
    op, args, _ = _cases()[name]
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no .* for device meta"):
        op(*meta)


def test_decode_shards_merged_match_the_jax_decode_over_the_whole_cache():
    rng = np.random.default_rng(4)
    B, S, H, KV, hd, n = 4, 64, 6, 2, 32, 4
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32) for _ in range(2))
    pos = np.array([0, 15, 16, 63], np.int32)  # rows ending in each shard
    want = np.asarray(jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                           positions=jnp.asarray(pos)))
    outs, lses = [], []
    for j in range(n):
        c = slice(j * S // n, (j + 1) * S // n)
        o, lse = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k[:, c]),
                                        torch.from_numpy(v[:, c]), torch.from_numpy(pos),
                                        start=j * S // n, with_lse=True)
        outs.append(o)
        lses.append(lse)
        empty = pos < j * S // n
        assert not o[torch.from_numpy(empty)].any()  # rows before the shard: 0 and -inf
        assert bool((lse[torch.from_numpy(empty)] == -math.inf).all())
    lse = torch.stack(lses)  # (n, B, H)
    w = torch.exp(lse - lse.max(dim=0).values)[..., None]  # (n, B, H, 1)
    merged = (torch.stack([o[:, 0] for o in outs]) * w).sum(0) / w.sum(0)
    np.testing.assert_allclose(merged[:, None].numpy(), want, atol=1e-5)
    # one shard with its start: the whole cache's rule, entries past the position masked
    one = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(pos))
    np.testing.assert_allclose(one.numpy(), want, atol=1e-5)


# -- the dry run ---------------------------------------------------------------------

_DRYRUN = """
    import json, torch
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.runtime.steps import build_step
    out = {}
    SHAPES = {"train": ShapeConfig("train", 64, 8, "train"),
              "prefill": ShapeConfig("prefill", 64, 8, "prefill"),
              "decode": ShapeConfig("decode", 64, 8, "decode")}
    for mesh in ((2, 2), (2, 2, 2)):
        for kind, shape in SHAPES.items():
            cfg = get_arch("smollm-135m").reduced()
            rec = dryrun.run_cell("smollm-135m", kind, multi_pod=len(mesh) == 3, device="cpu",
                                  cfg=cfg, mesh_shape=mesh, shape=shape, verbose=False)
            key = f"{'x'.join(map(str, mesh))}/{kind}"
            out[key] = {k: v for k, v in rec.items() if k != "ranks"}
            out[key]["n_ranks"] = len(rec["ranks"])
            model = build_model(cfg)
            axes = dryrun.PRODUCTION[len(mesh) == 3][1]
            out[key]["rank_flops"] = [
                dryrun.trace_rank(model, shape, mesh, axes, r, "cpu")["hlo"]["flops_per_device"]
                for r in range(rec["chips"])]
            _, one = build_step(model, shape, device="cpu").trace()
            out[key]["one_flops"] = one.flops
    rec = dryrun.run_cell("phi3.5-moe-42b-a6.6b", "decode", multi_pod=False, device="cpu",
                          cfg=get_arch("phi3.5-moe-42b-a6.6b").reduced(), mesh_shape=(2, 2),
                          shape=SHAPES["decode"], verbose=False)
    out["moe"] = rec
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dry():
    return _run(_DRYRUN)


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_records_have_the_reference_keys(dry, mesh, kind):
    rec = dry[f"{mesh}/{kind}"]
    assert {"arch", "shape", "mesh", "chips", "kind", "memory", "peak_bytes_per_device",
            "cost_analysis", "hlo", "trace_s"} <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    m = rec["memory"]
    assert rec["peak_bytes_per_device"] >= m["argument_bytes"] + m["output_bytes"] \
        + m["temp_bytes"] - m["alias_bytes"]
    assert set(rec["cost_analysis"]) == {"flops", "bytes_accessed"}
    assert {"flops_per_device", "bytes_per_device", "bytes_fused_per_device",
            "collective_bytes_per_device", "collectives"} <= set(rec["hlo"])
    assert rec["n_ranks"] == 2 and rec["mesh"] == mesh
    assert rec["hlo"]["flops_per_device"] == max(rec["rank_flops"])  # the heavier rank's


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
def test_a_train_cell_holds_its_param_and_moment_tiles(dry, mesh):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    n_params = build_model(get_arch("smollm-135m").reduced()).param_count()
    rec = dry[f"{mesh}/train"]
    # each rank's tiles: at least its share of the f32 params and both moments
    assert rec["memory"]["argument_bytes"] >= 3 * 4 * n_params / rec["chips"]
    assert rec["peak_bytes_per_device"] >= rec["memory"]["argument_bytes"]


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
def test_rank_flops_sum_to_the_one_device_step(dry, mesh):
    """The ranks split the one-device step's work, each step kind within
    1 % as train does. Train: the rows and the sequence, the vocab-parallel
    loss and the causal shards' pairs. Prefill: also, and the last
    position's logits are each "model" rank's vocab tile of them, not
    computed n_model times (2 d V_pad a row, (n_model - 1) times over, the
    gap before tensor-parallel serving). Decode: the products are
    tensor-parallel (each "model" rank multiplies by its tiles) and the
    cache shards split the attention, where each "model" rank used to
    compute its rows' whole token."""
    from repro_torch.configs import get_arch

    cfg = get_arch("smollm-135m").reduced()
    n_model = 2
    for kind in ("train", "prefill", "decode"):
        rec = dry[f"{mesh}/{kind}"]
        assert abs(sum(rec["rank_flops"]) - rec["one_flops"]) <= 0.01 * rec["one_flops"], kind
    pre = dry[f"{mesh}/prefill"]
    logits = 2 * cfg.d_model * cfg.padded_vocab * 8  # the 8 rows' last position
    assert abs(sum(pre["rank_flops"]) - pre["one_flops"]) < (n_model - 1) * logits / 2
    dec = dry[f"{mesh}/decode"]
    attn = 4 * cfg.resolved_head_dim * cfg.n_heads * 8 * 64 * cfg.n_layers  # full caches
    assert sum(dec["rank_flops"]) < n_model * (dec["one_flops"] - attn) + attn


def test_a_dense_decode_cell_holds_its_weights_as_model_tiles(dry):
    """smollm-135m reduced's decode cell on the fake (2, 2) mesh: its
    arguments are the rank's cache tile, the global batch and the served
    weights, of which every leaf sharded on "model" (the tensor axes) is
    1/n_model, the rest whole."""
    import types

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.sharding import flatten_specs, param_shardings, spec_axes
    from repro_torch.utils import tree_flatten_with_paths

    model = build_model(get_arch("smollm-135m").reduced())
    n_rows = n_model = 2
    mesh = types.SimpleNamespace(shape={"data": n_rows, "model": n_model})
    specs = flatten_specs(param_shardings(model, mesh, zero=False))
    served = dict(tree_flatten_with_paths(model.compute_params(model.param_struct())))
    nbytes = {p: x.numel() * x.element_size() for p, x in served.items()}
    tensor = sum(b for p, b in nbytes.items() if "model" in spec_axes(specs[p]))
    assert tensor > 0.9 * sum(nbytes.values())  # the embedding and every layer matrix
    weights = sum(nbytes.values()) - tensor * (1 - 1 / n_model)
    shape = ShapeConfig("decode", 64, 8, "decode")
    cache = sum(x.numel() * x.element_size() for x in model.cache_struct(shape).values())
    batch = 2 * 8 * 4  # tokens (8, 1) and positions (8,), int32
    rec = dry["2x2/decode"]
    assert rec["memory"]["argument_bytes"] == weights + cache / (n_rows * n_model) + batch


def test_a_moe_cell_is_traced(dry):
    """The MoE family's decode cell traces on the fake (2, 2) mesh: its 8
    rows are one group across both "data" ranks (the routing counts
    exchanged), with FLOPs and the reference's keys."""
    rec = dry["moe"]
    assert "skipped" not in rec and rec["hlo"]["flops_per_device"] > 0
    assert {"memory", "peak_bytes_per_device", "cost_analysis"} <= set(rec)
    assert rec["hlo"]["collective_bytes_per_device"] > 0


_EXPERT_CELLS = """
    import json
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.runtime import steps
    shape = ShapeConfig("train", 64, 8, "train")
    out = {}
    for arch in ("phi3.5-moe-42b-a6.6b", "smollm-135m"):
        for tiles in (True, False):
            keep = steps._kept_tiles
            if not tiles:  # every layer leaf gathered whole, the experts too
                steps._kept_tiles = lambda specs, axes, *a: {
                    p: t for p, t in keep(specs, axes, *a).items() if "experts" not in axes[p]}
            try:
                rec = dryrun.run_cell(arch, "train", multi_pod=False, device="cpu",
                                      cfg=get_arch(arch).reduced(), mesh_shape=(2, 2),
                                      shape=shape, verbose=False)
            finally:
                steps._kept_tiles = keep
            out[f"{arch}/{tiles}"] = {k: rec[k] for k in ("hlo", "peak_bytes_per_device",
                                                          "memory")}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def expert_cells():
    return _run(_EXPERT_CELLS)


def test_a_moe_train_cell_gathers_its_expert_tiles_and_moves_tokens(expert_cells):
    """phi3.5-moe reduced's train cell on the fake (2, 2) mesh: its
    all-gathers return the expert leaves' "model" tiles, 1/n_model of what
    the whole gather of every layer leaf returned (the bytes all-gathered
    fall by (1 - 1/n_model) of the whole expert leaves), and its
    collectives include the all-to-alls of the tokens, two a layer forward
    and two backward, which the whole gather has none of; the FLOPs of the
    heavier rank stay (its groups are whole on each rank: no work was
    repeated)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("phi3.5-moe-42b-a6.6b").reduced()
    struct = build_model(cfg).param_struct()["layers"]
    experts = sum(struct[k].numel() * struct[k].element_size()
                  for k in ("w_gate", "w_up", "w_down"))
    n_model = 2
    ep = expert_cells["phi3.5-moe-42b-a6.6b/True"]["hlo"]
    whole = expert_cells["phi3.5-moe-42b-a6.6b/False"]["hlo"]
    gathered = ep["collective_out_bytes_by_kind"]["all-gather"]
    assert gathered == whole["collective_out_bytes_by_kind"]["all-gather"] \
        - experts * (1 - 1 / n_model)
    assert ep["collectives"]["all-to-all"] == 4 * cfg.n_layers
    assert "all-to-all" not in whole["collectives"]
    assert ep["collective_bytes_by_kind"]["all-to-all"] > 0
    assert ep["collective_out_bytes_by_kind"]["all-to-all"] \
        == ep["collective_bytes_by_kind"]["all-to-all"]
    assert ep["flops_per_device"] == whole["flops_per_device"]


def test_a_dense_cell_reads_as_before(expert_cells, dry):
    """smollm-135m's train cell is the same record whether or not expert
    leaves would stay tiles, and the same as the dry run's (2, 2) cell."""
    ep = expert_cells["smollm-135m/True"]
    assert ep == expert_cells["smollm-135m/False"]
    assert ep["hlo"] == dry["2x2/train"]["hlo"]
    assert ep["peak_bytes_per_device"] == dry["2x2/train"]["peak_bytes_per_device"]


# -- the Mini-App streams ---------------------------------------------------------------


def test_a_kmeans_batch_counts_its_kernels_formulas():
    """One K-Means batch (``minibatch_update``: the assignment, the update
    and the decayed centroids) traced under fake tensors counts exactly
    2NKD + 3NK + 2ND + N (D + 1): the elementwise work counts nothing, as in
    every traced step."""
    from repro_torch.kernels import kmeans

    n, d, k = 5000, 3, 10
    args = (torch.empty((n, d), device="meta"), torch.empty((k, d), device="meta"))
    _, cost = trace_cost(kmeans.minibatch_update, *args, device="cpu")
    assert cost.flops == 2 * n * k * d + 3 * n * k + 2 * n * d + n * (d + 1)
    assert cost.peak_bytes >= cost.input_bytes + n * 8 + k * d * 4


def test_an_mlem_batch_counts_its_kernels_formulas():
    """One ML-EM batch of B frames at ``iters`` iterations runs iters + 1
    backprojections and iters projections: (2 iters + 1) (4 B n^2 A + 6 n^2 A)."""
    from repro_torch.kernels import tomo

    b, a, n_det, n, iters = 3, 12, 40, 32, 4
    sinos = torch.empty((b, a, n_det), device="meta")
    angles = torch.from_numpy(tomo.angle_grid(a))
    _, cost = trace_cost(lambda s, t: tomo.mlem_batch(s, t, n, iters=iters), sinos, angles,
                         device="cpu")
    assert cost.flops == (2 * iters + 1) * (4 * b * n * n * a + 6 * n * n * a)
    # the projection's scratch (a transposed copy of the B images) is live
    # beside x, norm and the batch's sinograms
    assert cost.peak_bytes >= 3 * b * n * n * 4 + 2 * b * a * n_det * 4


def test_the_dry_run_lists_the_miniapp_cells():
    from repro_torch.launch import dryrun

    cells = dryrun.dry_run_cells()
    assert [c for c in cells if c in dryrun.MINIAPP_CELLS] == [
        ("kmeans", "narrow"), ("kmeans", "wide"), ("gridrec", "360x1448"), ("mlem", "360x1448")]


@pytest.mark.parametrize("app,shape", [("kmeans", "narrow"), ("kmeans", "wide"),
                                       ("gridrec", "360x1448"), ("mlem", "360x1448")])
def test_a_miniapp_cell_states_its_flops_bytes_and_peak_with_no_card(app, shape, tmp_path,
                                                                        capsys):
    """The dry run's CLI on one Mini-App cell at its full size, on fake CPU
    tensors: a record under the LM cells' keys, its FLOPs the kernels'
    formulas, its peak at least its inputs and outputs, a roofline row."""
    from repro_torch.launch import dryrun, roofline

    out = tmp_path / "cell.json"
    dryrun.main(["--arch", app, "--shape", shape, "--device", "cpu", "--out", str(out)])
    assert "all 1 cells OK" in capsys.readouterr().out
    (rec,) = json.loads(out.read_text())
    size = dryrun.MINIAPP_CELLS[(app, shape)]
    assert rec["kind"] == "stream" and rec["mesh"] == "1" and rec["chips"] == 1
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    if app == "kmeans":
        n, d, k = size["points"], size["dim"], size["k"]
        flops = 2 * n * k * d + 3 * n * k + 2 * n * d + n * (d + 1)
        assert rec["memory"]["argument_bytes"] == (n + k) * d * 4
    else:
        b, a, n = size["frames"], size["angles"], size["n"]
        flops = (4 * b * n * n * a + 6 * n * n * a) * (2 * size.get("iters", 0) + 1)
        assert rec["memory"]["output_bytes"] == b * n * n * 4
    assert rec["hlo"]["flops_per_device"] == rec["cost_analysis"]["flops"] == flops
    assert rec["hlo"]["bytes_fused_per_device"] > 0 and rec["cost_analysis"]["bytes_accessed"] > 0
    m = rec["memory"]
    assert rec["peak_bytes_per_device"] >= m["argument_bytes"] + m["output_bytes"]
    row = roofline.analyze_record(rec)
    assert row.kind == "stream" and row.hlo_flops == flops
    assert row.compute_s == flops / roofline.H100.flops_f32
    assert f"| {app} | {shape} |" in roofline.render_streams([row])
