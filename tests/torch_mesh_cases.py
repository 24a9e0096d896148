"""Rank bodies of the port's mesh tests: each runs in a spawned gloo rank
(``repro_torch.launch.mesh.spawn_ranks``) and returns numpy results for
the pytest process to check. Imports only the port and numpy, so a rank
starts without JAX. One function per test file runs every case of that
file once; the inputs come from the pytest process, made there from seeds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import make_mesh


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _rules(mesh, kind="train"):
    from repro_torch.runtime.sharding import ShardingRules

    return ShardingRules(mesh=mesh, batch_axes=("data",), kind=kind)


def _tile(x: np.ndarray, mesh, seq_dim: int = 1) -> torch.Tensor:
    """This rank's rows (dim 0 over "data") and sequence shard (``seq_dim``
    over "model") of a global array."""
    d, m = mesh.axis_index("data"), mesh.axis_index("model")
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    b, s = x.shape[0] // nd, x.shape[seq_dim] // nm
    x = x[d * b:(d + 1) * b]
    idx = [slice(None)] * x.ndim
    idx[seq_dim] = slice(m * s, (m + 1) * s)
    return torch.from_numpy(np.ascontiguousarray(x[tuple(idx)]))


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py
# ---------------------------------------------------------------------------


def _vocab_parallel(mesh, inp):
    from repro_torch.runtime.losses import vocab_parallel_cross_entropy, vocab_parallel_embed

    rules = _rules(mesh)
    m, nm = mesh.axis_index("model"), mesh.shape["model"]
    V = inp["head"].shape[0]
    head = torch.from_numpy(inp["head"][m * V // nm:(m + 1) * V // nm].copy())
    x = _tile(inp["x"], mesh).requires_grad_(True)
    tot, cnt = vocab_parallel_cross_entropy(x, head, _tile(inp["targets"], mesh),
                                            _tile(inp["mask"], mesh), rules, chunk=8)
    # the loss every rank holds, back-propagated once over the ranks
    (tot / mesh.size).backward()
    emb = vocab_parallel_embed(_tile(inp["tokens"], mesh), head, rules)
    return {"tot": float(tot.detach()), "cnt": float(cnt), "grad_x": _np(x.grad), "embed": _np(emb)}


def _attention(mesh, inp):
    from repro_torch.runtime.ring_attention import ring_attention_shmap
    from repro_torch.runtime.sharded_attention import sharded_attention

    out = {}
    for kind, impl in (("prefill", "allgather"), ("train", "allgather"), ("train", "flash")):
        q, k, v = (_tile(inp[n], mesh) for n in "qkv")
        out[f"{kind}/{impl}"] = _np(sharded_attention(q, k, v, _rules(mesh, kind), causal=True,
                                                      block_kv=16, impl=impl))
    # gradients through the flash path, of sum(sin(out)) over every rank
    q, k, v = (_tile(inp[n], mesh).requires_grad_(True) for n in "qkv")
    o = sharded_attention(q, k, v, _rules(mesh, "train"), causal=True, block_kv=16, impl="flash")
    torch.sin(o).sum().backward()
    out["grads"] = [_np(t.grad) for t in (q, k, v)]
    q, k, v = (_tile(inp[n], mesh) for n in "qkv")
    for causal in (True, False):
        out[f"ring/{causal}"] = _np(ring_attention_shmap(q, k, v, _rules(mesh, "prefill"),
                                                         causal=causal, block_kv=16))
    # "ring" in a train-kind rule takes the flash path, as the reference
    out["ring/train"] = _np(sharded_attention(q, k, v, _rules(mesh, "train"), causal=True,
                                              impl="ring"))
    return out


def _train_steps(mesh, inp):
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.sharding import param_shardings, unshard_tree
    from repro_torch.runtime.steps import build_train_step, mesh_train_state

    # remat recomputes each layer (its collectives too) in the backward; it
    # changes no arithmetic, so the one-device step runs without it
    cfg = get_arch("smollm-135m").reduced(remat="full")
    model = build_model(cfg)
    B, S = inp["tokens_train"].shape[1:]
    opt_cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=0)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    state = Optimizer(opt_cfg).init(params)
    params, state = mesh_train_state(model, params, state, mesh)
    step = build_train_step(model, ShapeConfig("t", S, B, "train"), opt_cfg, mesh=mesh)
    metrics = []
    for i in range(3):
        params, state, met = step(params, state, {"tokens": inp["tokens_train"][i]})
        metrics.append({k: float(v) for k, v in met.items()})
    specs = param_shardings(model, mesh)
    full = unshard_tree(params, specs, mesh)
    moments = unshard_tree(state["m"], specs, mesh)
    tiles = {"wqkv": _np(params["layers"]["wqkv"]), "embed": _np(params["embed"])}
    return {"metrics": metrics, "tiles": tiles,
            "params": {k: _np(v) for k, v in _flat(full).items()} if mesh.rank == 0 else None,
            "m": {k: _np(v) for k, v in _flat(moments).items()} if mesh.rank == 0 else None}


def _families(mesh, inp):
    """One mesh step of the reduced rwkv6 and zamba2 (the token shifts,
    the sequence-parallel cores and the shared attention site cross the
    shards), and of the reduced MoE, VLM and enc-dec families from the JAX
    weights (``inp["family_cases"]``: the MoE's groups, the VLM's shards of
    [patches; text], the enc-dec model's frames and tokens each split)."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.sharding import param_shardings, unshard_tree
    from repro_torch.runtime.steps import build_train_step, mesh_train_state

    out = {}
    tokens = inp["tokens_families"]
    B, S = tokens.shape
    opt_cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=0)
    for name in ("rwkv6-3b", "zamba2-1.2b"):
        model = build_model(get_arch(name).reduced())
        params = model.init(torch.Generator().manual_seed(1))
        state = Optimizer(opt_cfg).init(params)
        params, state = mesh_train_state(model, params, state, mesh)
        step = build_train_step(model, ShapeConfig("t", S, B, "train"), opt_cfg, mesh=mesh)
        params, state, met = step(params, state, {"tokens": tokens})
        full = unshard_tree(params, param_shardings(model, mesh), mesh)
        out[name] = {"metrics": {k: float(v) for k, v in met.items()},
                     "params": {k: _np(v) for k, v in _flat(full).items()}
                     if mesh.rank == 0 else None}
    for name, case in inp["family_cases"].items():
        out[name] = _mesh_family_step(mesh, case)
    return out


def _flat(tree):
    from repro_torch.utils.tree import tree_flatten_with_paths

    return dict(tree_flatten_with_paths(tree))


def _restore(mesh8, mesh4, inp, directory):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime.sharding import P, shard, unshard, unshard_many

    w = torch.from_numpy(inp["w"])
    state = {"w": shard(w, P("model"), mesh8)}
    full = {"w": unshard(state["w"], P("model"), mesh8)}
    mgr = CheckpointManager(directory)
    if mesh8.rank == 0:
        mgr.save(1, full)
    torch.distributed.barrier()
    spec = P(("data", "model"), None)
    restored, _ = mgr.restore({"w": w}, shardings={"w": spec}, mesh=mesh4)
    # tiles of one and two mesh axes on either dim, gathered back in one call
    specs = [spec, P("model", "data"), P(None, ("model", "data")), P("data")]
    back = unshard_many([shard(w, s, mesh4) for s in specs], specs, mesh4)
    return {"tile": _np(restored["w"]), "want": _np(shard(w, spec, mesh4)),
            "gathered": [_np(x) for x in back]}


def distributed_cases(rank: int, inp: dict, directory: str) -> dict:
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": mesh.coords(), "vocab": _vocab_parallel(mesh, inp),
           "attention": _attention(mesh, inp), "train": _train_steps(mesh, inp),
           "families": _families(mesh, inp)}
    from repro_torch.launch.mesh import make_local_mesh

    out["local_mesh"] = make_local_mesh(n_model=2, device="cpu").shape
    mesh8 = make_mesh((4,), ("model",), device="cpu")
    out["restore"] = _restore(mesh8, mesh, inp, directory)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_sequence_parallel.py
# ---------------------------------------------------------------------------


def sequence_parallel_cases(rank: int, inp: dict) -> dict:
    from repro_torch.runtime.sequence_parallel import conv1d_sharded, ssd_sharded, wkv6_sharded

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = _rules(mesh)
    r, k, v, w = (_tile(inp[n], mesh, seq_dim=2).requires_grad_(True)
                  for n in ("r", "k", "v", "w"))
    o, s = wkv6_sharded(r, k, v, w, torch.from_numpy(inp["u"]), rules, chunk=8)
    torch.sin(o).sum().backward()
    out = {"wkv": (_np(o), _np(s)), "wkv_grads": [_np(t.grad) for t in (r, k, v, w)]}
    y, s = ssd_sharded(_tile(inp["x"], mesh), _tile(inp["dt"], mesh), torch.from_numpy(inp["A"]),
                       _tile(inp["Bm"], mesh), _tile(inp["Cm"], mesh),
                       torch.from_numpy(inp["D"]), rules, chunk=8)
    out["ssd"] = (_np(y), _np(s))
    xc = _tile(inp["xc"], mesh).requires_grad_(True)
    c = conv1d_sharded(xc, torch.from_numpy(inp["wc"]), torch.from_numpy(inp["bc"]), rules)
    torch.sin(c).sum().backward()
    out["conv"] = (_np(c), _np(xc.grad))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_grad_compress.py
# ---------------------------------------------------------------------------


def grad_compress_cases(rank: int, inp: dict) -> dict:
    from repro_torch.runtime import collectives
    from repro_torch.runtime.grad_compress import quantized_psum, quantized_psum_tree, resid_len

    mesh = make_mesh((2,), ("pod",), device="cpu")
    sent = []
    real = collectives._all_gather

    def spy(mesh_, axes, x, dim):  # record what crosses the wire
        sent.append(str(x.dtype))
        return real(mesh_, axes, x, dim)

    collectives._all_gather = spy
    try:
        g = torch.from_numpy(inp["g"][rank])
        red, resid = quantized_psum(g, torch.zeros(resid_len(g.numel())), mesh, "pod")
    finally:
        collectives._all_gather = real
    out = {"wire": sent, "reduced": _np(red), "resid": _np(resid)}
    # the tree form: each leaf as quantized_psum takes it alone
    tree = {"a": g[:2], "b": {"c": g[2:].reshape(-1)}}
    zeros = {"a": torch.zeros(resid_len(512)), "b": {"c": torch.zeros(resid_len(512))}}
    red_t, resid_t = quantized_psum_tree(tree, zeros, mesh, "pod")
    alone = [quantized_psum(x, torch.zeros(resid_len(512)), mesh, "pod") for x in (g[:2],
                                                                                 g[2:].reshape(-1))]
    out["tree_equal"] = all(torch.equal(a, b) for a, b in (
        (red_t["a"], alone[0][0]), (red_t["b"]["c"], alone[1][0]),
        (resid_t["a"], alone[0][1]), (resid_t["b"]["c"], alone[1][1])))
    # data parallelism on a least-squares problem: exact psum vs int8 wire
    X, y = torch.from_numpy(inp["X"]), torch.from_numpy(inp["y"])
    half = X.shape[0] // 2
    Xl, yl = X[rank * half:(rank + 1) * half], y[rank * half:(rank + 1) * half]
    for compressed in (False, True):
        w = torch.zeros(X.shape[1])
        resid = torch.zeros(resid_len(w.numel()))
        for _ in range(300):
            wl = w.clone().requires_grad_(True)
            loss = ((Xl @ wl - yl) ** 2).mean() / 2  # this rank's half of the mean
            (gl,) = torch.autograd.grad(loss, wl)
            if compressed:
                gsum, resid = quantized_psum(gl, resid, mesh, "pod")
            else:
                gsum = collectives.psum(gl, mesh, "pod")
            w = w - 0.05 * gsum
        out["final/" + ("compressed" if compressed else "exact")] = float(
            ((X @ w - y) ** 2).mean())
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_serve_mesh.py
# ---------------------------------------------------------------------------


def _serve_one(mesh, model, params, inp, extra: dict | None = None, on_served=None) -> dict:
    """Prefill the global prompts (beside ``extra`` inputs: a VLM's patch
    or an enc-dec model's frame embeddings) and decode ``inp["steps"]`` on
    the mesh: the rank's rows' logits of each call, its cache tile after
    the prefill and its K/V tiles after the last decode step, and the
    decode-attention merge at the right and at a one-off shard start.
    ``on_served`` is called with the params the steps take."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models.common import decode_segment
    from repro_torch.runtime.collectives import all_gather
    from repro_torch.runtime.sharded_attention import sharded_decode_attention
    from repro_torch.runtime.sharding import activation_rules, shard_tree
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step
    from repro_torch.kernels.attention import decode_attention

    tokens, steps, cache_len = inp["tokens"], inp["steps"], inp["cache_len"]
    extra = extra or {}
    B, T = tokens.shape
    if "patch_embeds" in extra:  # the prompt's positions count the patches
        T += extra["patch_embeds"].shape[1]
    pre = build_prefill_step(model, ShapeConfig("p", T, B, "prefill"), mesh=mesh,
                             cache_len=cache_len)
    # an enc-dec model's decode shape holds the frames' half of the budget too
    dec = build_decode_step(model, ShapeConfig(
        "d", cache_len * (2 if "frame_embeds" in extra else 1), B, "decode"), mesh=mesh)
    served = pre.load(shard_tree(params, pre.in_specs[0], mesh))  # the rank's tiles
    if on_served is not None:
        on_served(served)
    logits, cache = pre.fn(served, {"tokens": tokens, **extra})
    out = {"logits": [_np(logits)], "cache": {k: _np(v).copy() for k, v in _flat(cache).items()}}
    for i, tok in enumerate(steps):
        pos = np.full((B,), T + i, np.int32)
        logits, cache = dec.fn(served, cache, {"tokens": tok, "positions": pos})
        out["logits"].append(_np(logits))
    out["final_cache"] = {k: _np(cache[k]).copy() for k in ("k", "v") if k in cache}
    if "k" in cache:  # the merge of the first site's tiles at a shard start one off
        with activation_rules(dec.rules):
            start, axes = decode_segment()
        b = B // mesh.shape["data"]
        g = torch.Generator().manual_seed(3)
        H, hd = model.cfg.n_heads, model.cfg.resolved_head_dim
        q = torch.randn((b, 1, H, hd), generator=g)
        pos = torch.full((b,), T + len(steps), dtype=torch.int32)
        kc, vc = cache["k"][0], cache["v"][0]
        whole = [all_gather(c, mesh, axes, dim=1) for c in (kc, vc)]
        ref = decode_attention(q, *whole, pos)
        errs = {}
        for name, at in (("right", start), ("one_off", start + 1)):
            got = sharded_decode_attention(q, kc, vc, pos, mesh, start=at, axes=axes)
            errs[name] = float((got - ref).abs().max())
        out["start_errs"] = errs
        out["start"], out["axes"] = start, list(axes)
    return out


def serve_mesh_cases(rank: int, inp: dict) -> dict:
    """The serving steps on a (2, 2) ("data", "model") mesh: the reduced
    smollm, rwkv6 and zamba2 from the JAX weights (``inp["params"]``), and
    the MoE, VLM and enc-dec families' cases of ``inp["families"]``
    (their weights and extra inputs)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.runtime import steps

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": mesh.coords()}
    for name, tree in inp["params"].items():
        model = build_model(get_arch(name).reduced())
        out[name] = _serve_one(mesh, model, params_from_jax(tree, "cpu"), inp)
    # the weights kept as ZeRO tiles, gathered a layer at a time (the path of
    # a model too big for whole weights on every rank)
    zero, steps._serving_zero = steps._serving_zero, lambda model, mesh: True
    try:
        model = build_model(get_arch("smollm-135m").reduced())
        out["smollm-135m/zero"] = _serve_one(
            mesh, model, params_from_jax(inp["params"]["smollm-135m"], "cpu"), inp)
    finally:
        steps._serving_zero = zero
    for name, case in inp["families"].items():
        model = build_model(get_arch(name).reduced())
        out[name] = _serve_one(mesh, model, params_from_jax(case["params"], "cpu"), inp,
                               case["extra"])
    return out


def serve_bf16_cases(rank: int, inp: dict) -> dict:
    """bf16 tensor-parallel serving on a (2, 2) ("data", "model") mesh: the
    reduced smollm at bf16 compute from the JAX weights, the prompts
    prefilled and ``inp["n_steps"]`` greedy decode steps on the mesh (each
    rank's tokens the argmax of its rows' logits); then the one-device bf16
    steps fed the mesh's tokens on the rank's rows. Returns the rank's
    rows, the mesh's tokens and both logits of every call; with
    ``inp["mutate"]``, a row-parallel slice one tile off."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model, common, params_from_jax
    from repro_torch.models.common import first_argmax
    from repro_torch.runtime.sharding import shard_tree
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    model = build_model(get_arch("smollm-135m").reduced(compute_dtype="bfloat16"))
    params = params_from_jax(inp["params"], "cpu")
    tokens, cache_len, n = torch.as_tensor(inp["tokens"]), inp["cache_len"], inp["n_steps"]
    B, T = tokens.shape
    b = B // mesh.shape["data"]
    rows = slice(mesh.axis_index("data") * b, (mesh.axis_index("data") + 1) * b)
    pre = build_prefill_step(model, ShapeConfig("p", T, B, "prefill"), mesh=mesh,
                             cache_len=cache_len)
    dec = build_decode_step(model, ShapeConfig("d", cache_len, B, "decode"), mesh=mesh)
    served = pre.load(shard_tree(params, pre.in_specs[0], mesh))
    rank_slice = common._rank_slice
    if inp.get("mutate"):
        common._rank_slice = _slice_one_off
    try:
        logits, cache = pre.fn(served, {"tokens": tokens})
        got, toks = [logits], []
        for i in range(n):
            tok = first_argmax(got[-1][:, -1], dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            every = torch.zeros((B, 1), dtype=torch.int32)
            every[rows] = tok
            logits, cache = dec.fn(served, cache, {"tokens": every, "positions": torch.full(
                (B,), T + i, dtype=torch.int32)})
            got.append(logits)
    finally:
        common._rank_slice = rank_slice
    whole = model.compute_params(params)
    one_pre = build_prefill_step(model, ShapeConfig("p1", T, b, "prefill"), device="cpu",
                                 cache_len=cache_len)
    one_dec = build_decode_step(model, ShapeConfig("d1", cache_len, b, "decode"), device="cpu")
    logits, cache = one_pre.fn(whole, {"tokens": tokens[rows]})
    want = [logits]
    for i, tok in enumerate(toks):
        logits, cache = one_dec.fn(whole, cache, {"tokens": tok, "positions": torch.full(
            (b,), T + i, dtype=torch.int32)})
        want.append(logits)
    return {"rows": [rows.start, rows.stop], "tokens": [_np(t) for t in toks],
            "mesh_logits": [_np(x) for x in got], "one_logits": [_np(x) for x in want]}


def serve_families_cases(rank: int, inp: dict) -> dict:
    """The MoE, VLM and enc-dec families' serving steps on the (2, 2)
    mesh (``_serve_one``), from the JAX weights of each ``inp`` case; a MoE
    case also records each routing's (tokens, routed, kept) choices."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, moe, params_from_jax

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": mesh.coords()}
    for name, case in inp.items():
        model = build_model(get_arch(name).reduced(**case["overrides"]))
        seen: list = []
        route = moe.moe_route
        moe.moe_route = _routed(moe, seen)
        try:
            out[name] = _serve_one(mesh, model, params_from_jax(case["params"], "cpu"), case,
                                   case["extra"])
        finally:
            moe.moe_route = route
        out[name]["routes"] = seen
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_mesh_families.py and tests/test_torch_mesh_adafactor.py
# ---------------------------------------------------------------------------


def _routed(moe, seen: list):
    """A ``moe_route`` that appends each call's (tokens, routed, kept)."""
    route = moe.moe_route

    def recording(*args, **kwargs):
        r = route(*args, **kwargs)
        seen.append((r.gates.shape[0] * r.gates.shape[1], int((r.gates > 0).sum()),
                     int(r.keep.sum())))
        return r
    return recording


def _own_counts_only(moe):
    """A ``group_counts`` that keeps the collective but drops every other
    rank's counts: a group's slots then ignore the tokens before the
    rank's part (the mutation the MoE case must catch)."""
    real = moe.group_counts

    def own(counts, mesh, axes):
        every = real(counts, mesh, axes)
        if not axes:
            return every
        n, i = counts.shape[0], mesh.axis_index(axes)
        keep = torch.zeros(every.shape[0], 1, dtype=every.dtype)
        keep[i * n:(i + 1) * n] = 1.0
        return every * keep
    return own


def _mesh_family_step(mesh, case: dict) -> dict:
    """One mesh train step of ``case["arch"]``'s reduced config (with
    ``case["overrides"]``) from the JAX weights ``case["params"]`` on
    ``case["batch"]``: the metrics on every rank; on rank 0 every param
    gathered and the optimizer state's moments gathered; each rank's
    factored moment tiles with their slices of the global leaves."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.sharding import (flatten_specs, param_shardings, shard_slices,
                                              unshard_tree)
    from repro_torch.runtime.steps import build_train_step, mesh_train_state, opt_state_shardings

    model = build_model(get_arch(case["arch"]).reduced(**case["overrides"]))
    opt = Optimizer(OptimizerConfig(**case["opt"]))
    params = params_from_jax(case["params"], "cpu")
    state = opt.init(params)
    params, state = mesh_train_state(model, params, state, mesh)
    batch = case["batch"]
    B, S = batch["tokens"].shape[0], case["seq_len"]
    step = build_train_step(model, ShapeConfig("t", S, B, "train"), opt.cfg, mesh=mesh)
    params, state, met = step(params, state, batch)
    out = {"metrics": {k: float(v) for k, v in met.items()}}
    ospecs = opt_state_shardings(model, opt, mesh)
    if "m" in state:
        m = unshard_tree(state["m"], ospecs["m"], mesh)
        out["m"] = {k: _np(v) for k, v in _flat(m).items()} if mesh.rank == 0 else None
    full = unshard_tree(params, param_shardings(model, mesh), mesh)
    out["params"] = {k: _np(v) for k, v in _flat(full).items()} if mesh.rank == 0 else None
    if "v_row" in state:  # each rank's factored moment tiles, with their slices
        struct = opt.state_struct(model.param_struct())
        out["factored"] = {}
        for name in ("v_row", "v_col"):
            specs, shapes = flatten_specs(ospecs[name]), _flat(struct[name])
            out["factored"][name] = {
                k: (_np(t), [(s.start, s.stop) for s in shard_slices(specs[k], shapes[k].shape,
                                                                     mesh)])
                for k, t in _flat(state[name]).items()}
    return out


def mesh_family_cases(rank: int, inp: dict) -> dict:
    """Every case of ``inp["cases"]`` once on the (2, 2) mesh; a MoE case
    also counts its routed and kept choices (summed over its layers and
    this rank's tokens) and runs again with the groups' slots blind to the
    other ranks (``_own_counts_only``)."""
    from repro_torch.models import moe

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": mesh.coords()}
    for key, case in inp["cases"].items():
        seen: list = []
        route = moe.moe_route
        moe.moe_route = _routed(moe, seen)
        try:
            out[key] = _mesh_family_step(mesh, case)
        finally:
            moe.moe_route = route
        if seen:
            out[key]["routed"] = sum(r for _, r, _ in seen)
            out[key]["kept"] = sum(k for _, _, k in seen)
            counts = moe.group_counts
            moe.group_counts = _own_counts_only(moe)
            try:
                out[key]["own_counts_only"] = _mesh_family_step(mesh, case)["metrics"]
            finally:
                moe.group_counts = counts
    return out


def _restore_state(mesh, case: dict, directory: str) -> dict:
    """A one-device Adafactor state saved whole (rank 0 writes) and
    restored onto the mesh with ``opt_state_shardings``: each rank's tiles
    against ``mesh_train_state``'s of the same state, bitwise."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.sharding import param_shardings
    from repro_torch.runtime.steps import mesh_train_state, opt_state_shardings

    model = build_model(get_arch(case["arch"]).reduced(**case["overrides"]))
    opt = Optimizer(OptimizerConfig(**case["opt"]))
    from repro_torch.utils import tree_map_with_paths

    params = params_from_jax(case["params"], "cpu")
    g = torch.Generator().manual_seed(4)
    state = {k: (v if k == "step" else tree_map_with_paths(
        lambda _, x: torch.rand(x.shape, generator=g), v)) for k, v in opt.init(params).items()}
    mgr = CheckpointManager(directory)
    if mesh.rank == 0:
        mgr.save(1, {"params": params, "opt": state})
    dist.barrier()
    shardings = {"params": param_shardings(model, mesh), "opt": opt_state_shardings(model, opt,
                                                                                  mesh)}
    restored, _ = mgr.restore({"params": params, "opt": state}, shardings=shardings, mesh=mesh)
    want_p, want_o = mesh_train_state(model, params, state, mesh)
    same = all(torch.equal(a, b) for a, b in zip(
        _flat({"params": want_p, "opt": want_o}).values(), _flat(restored).values()))
    return {"bitwise": same, "leaves": len(_flat(restored))}


def mesh_adafactor_cases(rank: int, inp: dict, directory: str) -> dict:
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    case = inp["case"]
    out = {"step": _mesh_family_step(mesh, case),
           "restore": _restore_state(mesh, case, directory),
           "clip_scope": _adafactor_clip_scope(mesh, inp["clip_scope"])}
    return out


def _adafactor_clip_scope(mesh, case: dict) -> dict:
    """Two Adafactor updates of a stacked leaf (8 layers, 2^22 elements:
    layerwise "big" as a whole, not as a rank's tile) and a norm, on the
    rank's tiles, from ``case``'s params and per-step gradients: the
    params gathered after each step (rank 0)."""
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig, TileLayout
    from repro_torch.runtime.sharding import P, shard, unshard

    opt = Optimizer(OptimizerConfig(**case["opt"]))
    specs = {"w": P(None, "model", None, "data"), "n": P("data")}
    rows = {"w": P(None, "model"), "n": P("data")}
    cols = {"w": P(None, "model", "data"), "n": P()}
    full = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    params = {k: shard(v, specs[k], mesh) for k, v in full.items()}
    state = opt.init(params)  # zeros: any tiling of them is theirs
    state["v_row"] = {k: shard(torch.zeros(v.shape[:-1] if v.ndim >= 2 else v.shape),
                               rows[k], mesh) for k, v in full.items()}
    state["v_col"] = {k: shard(torch.zeros(v.shape[:-2] + v.shape[-1:] if v.ndim >= 2 else ()),
                               cols[k], mesh) for k, v in full.items()}
    tiles = {k: TileLayout.of(mesh, tuple(full[k].shape), specs[k], rows[k], cols[k])
             for k in full}
    out = []
    for grads in case["grads"]:
        g = {k: shard(torch.from_numpy(v), specs[k], mesh) for k, v in grads.items()}
        norm = torch.sqrt(sum(torch.from_numpy(v).double().square().sum() for v in grads.values())
                          ).float()
        params, state, _ = opt.update(g, state, params, grad_norm=norm, tiles=tiles)
        gathered = {k: _np(unshard(v, specs[k], mesh)) for k, v in params.items()}
        out.append(gathered if mesh.rank == 0 else None)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_expert_parallel.py
# ---------------------------------------------------------------------------


class _ExpertSpies:
    """Records, while active, what expert parallelism must show: the
    expert counts each expert product holds (``moe._experts``), each
    gather of an expert leaf (its axes and the experts it returns:
    ``unshard_many``, the leaves told apart by identity with ``experts``,
    the rank's stacked expert tiles), the all-to-alls by step kind (calls
    and bytes, forward and backward), and the "model" all-reduces of
    ``d_model``-wide sums (the decode combine, and tensor-parallel
    serving's other sums of that width)."""

    def __init__(self, moe, experts: list, d_model: int):
        from repro_torch.runtime import collectives, sharding

        self.moe, self.coll, self.sharding = moe, collectives, sharding
        self.experts, self.d = experts, d_model
        self.held, self.gathers, self.a2a, self.a2a_bytes, self.combine = set(), [], {}, {}, {}
        self.quiet = 0  # inside ``unshard_tree``: a test's gather of its results

    def _kind(self) -> str:
        rules = self.sharding.current_rules()
        return "none" if rules is None else rules.kind

    def __enter__(self):
        moe, coll, sharding = self.moe, self.coll, self.sharding
        self.saved = (moe._experts, sharding.unshard_many, coll._all_to_all, coll._all_reduce,
                      sharding.unshard_tree)
        experts, unshard, a2a, reduce, tree = self.saved

        def held(p, xe, cd):
            self.held.add((int(p["w_gate"].shape[0]), int(xe.shape[0])))
            return experts(p, xe, cd)

        def gather(tiles, specs, mesh):
            out = unshard(tiles, specs, mesh)
            for t, spec, o in zip(tiles, specs, out):
                if not self.quiet and any(t is e or t._base is e for e in self.experts):
                    self.gathers.append((list(sharding.spec_axes(spec)), int(o.shape[-3])))
            return out

        def all_to_all(mesh, axes, x, dim):
            k = self._kind()
            self.a2a[k] = self.a2a.get(k, 0) + 1
            self.a2a_bytes[k] = self.a2a_bytes.get(k, 0) + x.numel() * x.element_size()
            return a2a(mesh, axes, x, dim)

        def all_reduce(mesh, axes, x, *args, **kwargs):
            if axes == "model" and x.shape[-1] == self.d:
                k = self._kind()
                self.combine[k] = self.combine.get(k, 0) + 1
            return reduce(mesh, axes, x, *args, **kwargs)

        def unshard_tree(*args):
            self.quiet += 1
            try:
                return tree(*args)
            finally:
                self.quiet -= 1

        moe._experts, sharding.unshard_many = held, gather
        coll._all_to_all, coll._all_reduce = all_to_all, all_reduce
        sharding.unshard_tree = unshard_tree
        return self

    def __exit__(self, *exc):
        moe, coll, sharding = self.moe, self.coll, self.sharding
        (moe._experts, sharding.unshard_many, coll._all_to_all, coll._all_reduce,
         sharding.unshard_tree) = self.saved

    def record(self) -> dict:
        return {"held": sorted(self.held), "gathers": self.gathers, "a2a": self.a2a,
                "a2a_bytes": self.a2a_bytes, "combine": self.combine}


def _one_sender_only():
    """An ``_owner_buffers`` that keeps one sender's partial buffer of a
    group held by several (``index_copy``: the last sender's overwrites the
    others'): the mutation the parity cases must catch."""
    def owner(recv, pos, n_groups):
        El, _, C, d = recv.shape
        return recv.new_zeros((El, n_groups + 1, C, d)).index_copy(1, pos, recv)[:, :-1]
    return owner


def _expert_leaves(tiles, experts: list):
    """Note the stacked expert leaves of a param tree of tiles (any other
    tree as is: ``shard_tree``'s subtrees); return it."""
    if isinstance(tiles, dict) and "layers" in tiles:
        experts.extend(tiles["layers"][k] for k in ("w_gate", "w_up", "w_down"))
    return tiles


def _expert_case(mesh, case: dict) -> dict:
    """``case`` on ``mesh`` under :class:`_ExpertSpies`: a train case is
    ``_mesh_family_step`` (the rank's expert tiles: what
    ``mesh_train_state`` cuts), a serve case ``_serve_one`` (ZeRO-tiled
    weights where ``case["zero"]``; the tiles: what ``shard_tree`` cuts
    for ``bundle.load``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, moe, params_from_jax
    from repro_torch.runtime import sharding, steps

    cfg = get_arch(case["arch"]).reduced(**case["overrides"])
    experts: list = []
    saved = steps.mesh_train_state, sharding.shard_tree, steps._serving_zero
    cut, shard, zero = saved
    def keep(*args):
        params, state = cut(*args)
        return _expert_leaves(params, experts), state

    steps.mesh_train_state = keep
    if case["kind"] == "serve":
        sharding.shard_tree = lambda *a: _expert_leaves(shard(*a), experts)
    if case.get("zero"):
        steps._serving_zero = lambda model_, mesh_: True
    try:
        with _ExpertSpies(moe, experts, cfg.d_model) as spy:
            if case["kind"] == "train":
                out = _mesh_family_step(mesh, case)
            else:
                out = _serve_one(mesh, build_model(cfg), params_from_jax(case["params"], "cpu"),
                                 case)
    finally:
        steps.mesh_train_state, sharding.shard_tree, steps._serving_zero = saved
    out["spy"] = spy.record()
    return out


def expert_parallel_cases(rank: int, inp: dict) -> dict:
    """Every case of ``inp["cases"]`` on its mesh, (2, 2) or (1, 4)
    ("data", "model"), under the spies; the cases named in
    ``inp["one_sender_only"]`` run again with the owners keeping one
    sender's partial buffer of a group (``_one_sender_only``): their
    metrics or logits."""
    from repro_torch.models import moe

    meshes = {"2x2": make_mesh((2, 2), ("data", "model"), device="cpu"),
              "1x4": make_mesh((1, 4), ("data", "model"), device="cpu")}
    out = {"coords": {k: m.coords() for k, m in meshes.items()}}
    for key, case in inp["cases"].items():
        out[key] = _expert_case(meshes[case["mesh"]], case)
    owner = moe._owner_buffers
    moe._owner_buffers = _one_sender_only()
    try:
        for key in inp["one_sender_only"]:
            case = inp["cases"][key]
            got = _expert_case(meshes[case["mesh"]], case)
            out[key]["one_sender_only"] = got["metrics"] if "metrics" in got else got["logits"]
    finally:
        moe._owner_buffers = owner
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_tensor_parallel_serving.py
# ---------------------------------------------------------------------------


class _ServeSpies:
    """Records, while active, what tensor-parallel serving must show, by
    step kind: each gather of a served weight (``unshard_many``: its path,
    told apart by identity with the served leaves, or their layer slices;
    the axes it gathers over; the bytes it returns), each ``psum`` of
    products' partial sums (by the function that runs it: ``row_product``,
    or ``moe_apply``'s fold of the experts' combine and the shared experts'
    product) and each all-gather of activations (by the function that runs
    it: ``_gathered_slices``, the column-parallel outputs; ``vocab_logits``,
    the head's)."""

    def __init__(self):
        from repro_torch.runtime import collectives, sharding

        self.coll, self.sharding = collectives, sharding
        self.paths: dict = {}
        self.gathers, self.psums, self.act_gathers = [], {}, {}

    def served(self, tree):
        from repro_torch.utils import tree_flatten_with_paths

        self.paths = {id(x): p for p, x in tree_flatten_with_paths(tree)}
        self.shapes = {p: list(x.shape) for p, x in tree_flatten_with_paths(tree)}

    def _kind(self) -> str:
        rules = self.sharding.current_rules()
        return "none" if rules is None else rules.kind

    def _count(self, into: dict, axes):
        """Count a collective under the function that runs it (past the
        collectives' own wrappers) and its axes."""
        import sys

        f = sys._getframe(2)
        while f.f_code.co_name == "all_gather_stack":
            f = f.f_back
        key = (self._kind(), f.f_code.co_name, axes if isinstance(axes, str) else "/".join(axes))
        into[key] = into.get(key, 0) + 1

    def __enter__(self):
        coll, sharding = self.coll, self.sharding
        self.saved = sharding.unshard_many, coll.psum, coll.all_gather
        unshard, psum, all_gather = self.saved

        def gather(tiles, specs, mesh):
            out = unshard(tiles, specs, mesh)
            for t, spec, o in zip(tiles, specs, out):
                path = self.paths.get(id(t), self.paths.get(id(t._base)))
                if path is not None:
                    self.gathers.append((self._kind(), path, list(sharding.spec_axes(spec)),
                                         o.numel() * o.element_size()))
            return out

        def psum_(x, mesh, axes):
            self._count(self.psums, axes)
            return psum(x, mesh, axes)

        def all_gather_(x, mesh, axes, *, dim):
            self._count(self.act_gathers, axes)
            return all_gather(x, mesh, axes, dim=dim)

        sharding.unshard_many, coll.psum, coll.all_gather = gather, psum_, all_gather_
        return self

    def __exit__(self, *exc):
        self.sharding.unshard_many, self.coll.psum, self.coll.all_gather = self.saved

    def record(self) -> dict:
        return {"shapes": self.shapes, "gathers": self.gathers,
                "psums": [[*k, n] for k, n in sorted(self.psums.items())],
                "act_gathers": [[*k, n] for k, n in sorted(self.act_gathers.items())]}


def _slice_one_off(x, width, mesh):
    """A ``_rank_slice`` one tile off: the mutation the parity cases must
    catch."""
    j = (mesh.axis_index("model") + 1) % mesh.shape["model"]
    return x[..., j * width:(j + 1) * width]


def _gathered_out_of_order(gathered):
    """A ``_gathered_slices`` whose ranks' tiles come back rotated by one:
    the mutation the parity cases must catch."""
    def rotated(x, mesh):
        return gathered(x, mesh).roll(1, dims=-2)
    return rotated


def _tp_case(mesh, case: dict) -> dict:
    """``case`` served on ``mesh`` (``_serve_one``) under
    :class:`_ServeSpies` (ZeRO tiles where ``case["zero"]``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.runtime import steps

    model = build_model(get_arch(case["arch"]).reduced(**case["overrides"]))
    zero = steps._serving_zero
    if case.get("zero"):
        steps._serving_zero = lambda model_, mesh_: True
    try:
        with _ServeSpies() as spy:
            out = _serve_one(mesh, model, params_from_jax(case["params"], "cpu"), case,
                             case["extra"], on_served=spy.served)
    finally:
        steps._serving_zero = zero
    out["spy"] = spy.record()
    return out


def tensor_parallel_cases(rank: int, inp: dict) -> dict:
    """Every case of ``inp["cases"]`` on its mesh, (2, 2) or (1, 4)
    ("data", "model"), under the spies; the cases named in
    ``inp["mutated"]`` run again with a row-parallel slice one tile off
    and with the column tiles gathered out of order: their logits."""
    from repro_torch.models import common

    meshes = {"2x2": make_mesh((2, 2), ("data", "model"), device="cpu"),
              "1x4": make_mesh((1, 4), ("data", "model"), device="cpu")}
    out = {"coords": {k: m.coords() for k, m in meshes.items()}}
    for key, case in inp["cases"].items():
        out[key] = _tp_case(meshes[case["mesh"]], case)
    for name, (attr, fn) in {"slice_one_off": ("_rank_slice", lambda f: _slice_one_off),
                             "out_of_order": ("_gathered_slices", _gathered_out_of_order)}.items():
        saved = getattr(common, attr)
        setattr(common, attr, fn(saved))
        try:
            for key in inp["mutated"]:
                case = inp["cases"][key]
                out[key][name] = _tp_case(meshes[case["mesh"]], case)["logits"]
        finally:
            setattr(common, attr, saved)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_train_group.py
# ---------------------------------------------------------------------------


class Echo:
    """A rank group's handler (``RankGroup(spec, Echo, (), pool)``) whose
    answer names the rank and the command it answers."""

    def __init__(self, mesh):
        self.rank = mesh.rank

    def echo(self, tag):
        return self.rank, tag
