"""The port's MoE family (``repro_torch.models.moe`` and the MoE branch of
``DecoderLM``) against the JAX package's, on the same numpy weights and
inputs (the JAX ``model.init`` pytree crosses with ``params_from_jax``).

The routing is compared exactly: the reference's dispatch buffer
(groups, experts, capacity, d) is captured where its ``moe_apply`` hands it
to ``constrain`` and must equal the port's, bit for bit: the same tokens in
the same slots, the same tokens dropped. That needs every token's top-k
set to be decided by more than the two frameworks' difference in the
router's logits, so the tests scale the router (std 0.1 instead of 1e-3:
logits of order 1) and assert each token's margin (``Routing.margin``: the
K-th chosen logit less the best unchosen one). On one MoE layer, given the
same inputs, the logits differ by the order of their f32 sums (about
1e-6), or by one bf16 step (2^-8 relative) in bf16 compute: the margin must
exceed LAYER_MARGIN = 0.05, several bf16 steps of these logits. Through
the f32 models the hidden states differ by about 1e-6 relative: the
margins must exceed MODEL_MARGIN = 1e-4. Through the bf16 models they
differ by a few bf16 steps (about 1 %), more than the smallest of the
hundreds of top-2 margins there, so the bf16 prefill/decode/loss cases
route every token to all 4 experts (``experts_per_token = 4``: no set to
flip; the gates are the softmax), and top-2 in bf16 is held twice: on the
layer, and through the whole models layer by layer, where a route may flip
only where the two models' measured log-probability difference explains
it (``test_bf16_top2_routes_match_jax_layer_by_layer``).

Tolerances: MoE outputs 2e-5 (f32) or 2^-5 (bf16) of the largest value
compared (sums in other orders; in bf16 the expert and shared-expert
intermediates are rounded, four bf16 steps), the aux loss 1e-6;
through the reduced models, as ``test_torch_models.py``: 2e-5 on logits for
f32 compute, 4e-2 of the largest value for bf16 compute (bf16 residual
streams rounded at other places), the loss 1e-5 (f32) and 2e-2 (bf16)
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.sharding as jax_sharding
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.runtime.steps import build_paged_decode_step as jax_decode_step
from repro.runtime.steps import build_paged_prefill_step as jax_prefill_step
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import build_model, common, moe, params_from_jax
from repro_torch.runtime.steps import build_paged_decode_step, build_paged_prefill_step

torch.set_num_threads(1)

MOE = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]
ROUTER_SCALE = 100.0  # std 1e-3 -> 0.1: logits of order 1
LAYER_MARGIN, MODEL_MARGIN = 0.05, 1e-4
ROUTE_LOGP_REL, ROUTE_COMPARED = 2.0 ** -5, 0.75


def _layer_params(name: str, **overrides):
    """One layer of the reduced model's params (numpy), the router scaled."""
    jc = jax_get_arch(name).reduced(**overrides)
    jp = jax_build_model(jc).init(jax.random.key(0))
    lp = jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"])
    lp["router"] = lp["router"] * ROUTER_SCALE
    return jc, get_arch(name).reduced(**overrides), lp


def _jax_moe(lp: dict, x: np.ndarray, cfg, dtype):
    """The reference's (y, aux) and its dispatch buffer (G, E, C, d), read
    where ``moe_apply`` hands it to ``constrain`` (eagerly, not jitted);
    arrays as f32 numpy."""
    seen = []

    def capture(a, axes):
        seen.append(np.asarray(a.astype(jnp.float32)))
        return a

    orig = jax_sharding.constrain
    jax_sharding.constrain = capture
    try:
        y, aux = jax_moe.moe_apply(jax.tree.map(jnp.asarray, lp),
                                   jnp.asarray(x).astype(dtype), cfg, dtype)
    finally:
        jax_sharding.constrain = orig
    return np.asarray(y.astype(jnp.float32)), float(aux), seen[0]


# (capacity factor, shared experts, (B, S)): binding (1.25 and a tighter
# 0.5) and non-binding (4.0) capacity, with and without a shared expert; 36
# tokens make groups of 12 (a proper divisor of T below the group size 16)
CASES = {
    "binding": (1.25, 0, (2, 16)),
    "binding_shared": (1.25, 1, (2, 16)),
    "tight_ragged": (0.5, 1, (3, 12)),
    "nonbinding": (4.0, 0, (2, 16)),
    "nonbinding_shared_ragged": (4.0, 1, (3, 12)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax_drops_included(case, dtype):
    cf, shared, (B, S) = CASES[case]
    jc, tc, lp = _layer_params("kimi-k2-1t-a32b", capacity_factor=cf, n_shared_experts=shared)
    if not shared:
        lp = {k: v for k, v in lp.items() if not k.startswith("shared_")}
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, tc.d_model)).astype(np.float32)
    if dtype == "bfloat16":  # inputs both frameworks hold exactly
        x = torch.from_numpy(x).bfloat16().float().numpy()
    jy, jaux, jxe = _jax_moe(lp, x, jc, getattr(jnp, dtype))
    tp = params_from_jax(lp, "cpu")
    cd = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(cd)
    ty, taux = moe.moe_apply(tp, tx, tc, cd)

    T = B * S
    gs = moe.moe_group_size(tc, T)
    assert gs == (12 if T == 36 else 16)
    xt = tx.reshape(T // gs, gs, tc.d_model)
    r = moe.moe_route(tp["router"], xt, tc, cd)
    assert float(r.margin().min()) > LAYER_MARGIN
    xe, _, _ = moe.moe_dispatch(xt, r, cd)
    assert jxe.shape == (T // gs, tc.n_experts, r.capacity, tc.d_model)
    # same tokens in the same slots, the same ones dropped
    np.testing.assert_array_equal(xe.permute(1, 0, 2, 3).float().numpy(), jxe)
    routed = T * tc.experts_per_token
    kept = int(r.keep.sum())
    if cf < tc.n_experts / tc.experts_per_token:
        assert kept < routed  # capacity binds: some tokens fall through
    else:
        assert kept == routed
    assert ty.dtype == cd and ty.shape == (B, S, tc.d_model)
    rel = 2e-5 if dtype == "float32" else 2.0 ** -5
    np.testing.assert_allclose(ty.float().numpy(), jy, atol=rel * float(np.abs(jy).max()))
    assert abs(float(taux) - jaux) <= 1e-6


def test_moe_capacity_and_group_size_match_jax():
    cfg = get_arch("kimi-k2-1t-a32b")
    for gs, k, e, cf in [(512, 8, 384, 1.25), (4, 8, 384, 1.25), (256, 2, 16, 1.25),
                         (16, 2, 4, 4.0), (12, 2, 4, 0.5)]:
        assert moe.moe_capacity(gs, k, e, cf) == jax_moe.moe_capacity(gs, k, e, cf)
    assert [moe.moe_group_size(cfg, t) for t in (4, 512, 640, 1000, 2048)] == [4, 512, 320, 500, 512]


def test_routing_ties_take_the_first_expert_and_margin_is_zero():
    """Equal logits: each round takes the first remaining expert, as
    ``jnp.argmax`` does, and the margin reads 0."""
    cfg = get_arch("phi3.5-moe-42b-a6.6b").reduced()
    r = moe.moe_route(torch.zeros((cfg.d_model, 4)), torch.ones((1, 3, cfg.d_model)), cfg,
                      torch.float32)
    assert r.experts.tolist() == [[[0, 1]] * 3]
    assert float(r.margin().abs().max()) == 0.0
    torch.testing.assert_close(r.gates[0, 0], torch.tensor([0.5, 0.5, 0.0, 0.0]))


def _pair(name, **overrides):
    """The reduced model in both packages from the JAX init, the router
    scaled by ROUTER_SCALE."""
    jm = jax_build_model(jax_get_arch(name).reduced(**overrides))
    tm = build_model(get_arch(name).reduced(**overrides))
    jp = jm.init(jax.random.key(0))
    jp["layers"]["router"] = jp["layers"]["router"] * ROUTER_SCALE
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture
def margins(monkeypatch):
    """Every routing margin the port's models compute while the test runs."""
    seen = []
    route = moe.moe_route

    def recording(*args, **kwargs):
        r = route(*args, **kwargs)
        seen.append(float(r.margin().min()))
        return r

    monkeypatch.setattr(moe, "moe_route", recording)
    return seen


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_decoder_prefill_decode_and_loss_match_jax(name, compute_dtype, margins):
    """The reduced MoE model (non-binding capacity, as ``reduced()`` sets
    it): prefill logits (last token and ``last_pos``), the cache, one
    decode step, and the loss with its aux term. Top-2 of 4 experts in f32,
    every expert in bf16 (see the module's note)."""
    f32 = compute_dtype == "float32"
    k = {} if f32 else {"experts_per_token": 4}
    jm, jp, tm, tp = _pair(name, compute_dtype=compute_dtype, **k)
    assert tm.is_moe and tm.cfg.capacity_factor == 4.0
    cp = tm.compute_params(tp)
    toks = np.random.default_rng(1).integers(1, 512, (2, 12)).astype(np.int32)
    last = np.array([11, 6], np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(cp, {"tokens": torch.from_numpy(toks)}, cache_len=13)
    jl_last, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks),
                                          "last_pos": jnp.asarray(last)})
    tl_last, _ = tm.prefill(cp, {"tokens": torch.from_numpy(toks),
                                 "last_pos": torch.from_numpy(last)})
    tol = 2e-5 if f32 else 4e-2 * float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    np.testing.assert_allclose(tl_last.numpy(), np.asarray(jl_last), atol=tol)
    jv = np.asarray(jc["v"], np.float32)
    np.testing.assert_allclose(tc["v"][:, :, :12].to(torch.float32).numpy(), jv,
                               atol=2e-5 if f32 else 4e-2 * float(np.abs(jv).max()))

    jc = jax.tree.map(lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]), jc)
    tok, pos = np.array([[5], [7]], np.int32), np.array([12, 12], np.int32)
    jd, _ = jax.jit(jm.decode)(jp, jc, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)})
    td, _ = tm.decode(cp, tc, {"tokens": torch.from_numpy(tok), "positions": torch.from_numpy(pos)})
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=tol)

    batch = np.random.default_rng(2).integers(1, 512, (2, 16)).astype(np.int32)
    jloss, jmet = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(batch)})
    tloss, tmet = tm.loss(tp, {"tokens": torch.from_numpy(batch)})
    rel = 1e-5 if f32 else 2e-2
    assert set(tmet) == set(jmet) == {"ce_loss", "tokens", "aux_loss"}
    for key in ("ce_loss", "aux_loss"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= rel * abs(float(jmet[key])), key
    assert abs(float(tloss) - float(jloss)) <= rel * abs(float(jloss))
    # the aux term is in the loss: 0.01 x the layers' mean
    assert float(tloss) == pytest.approx(float(tmet["ce_loss"]) + 0.01 * float(tmet["aux_loss"]),
                                         rel=1e-6)
    assert len(margins) == 2 * 4  # two layers of two prefills, the decode step and the loss
    if f32:
        assert min(margins) > MODEL_MARGIN
    else:  # every expert chosen: no unchosen one to come close
        assert min(margins) == float("inf")


class _Routes:
    """Each MoE layer's routing while the context is open, in both
    packages: the reference's router log-probabilities, read where its
    ``moe_apply`` starts (``jax.debug.callback``, so also under ``jit``
    and ``scan``), and the port's ``Routing``: per layer, (T, E)
    log-probabilities, (T, K) expert sets sorted, and (T,) margins."""

    def __enter__(self):
        self.jax, self.port = [], []
        self._jax_apply, self._route = jax_moe.moe_apply, moe.moe_route

        def jax_apply(p, x, cfg, cd):
            logits = (x.reshape(-1, x.shape[-1]).astype(cd) @ p["router"].astype(cd))
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            jax.debug.callback(lambda a: self.jax.append(np.asarray(a)), logp, ordered=True)
            return self._jax_apply(p, x, cfg, cd)

        def route(*args, **kwargs):
            r = self._route(*args, **kwargs)
            E, K = r.probs.shape[-1], r.experts.shape[-1]
            self.port.append((torch.log(r.probs).reshape(-1, E).numpy(),
                              r.experts.reshape(-1, K).sort(-1).values.numpy(),
                              r.margin().reshape(-1).numpy()))
            return r

        jax_moe.moe_apply, moe.moe_route = jax_apply, route
        return self

    def __exit__(self, *exc):
        jax_moe.moe_apply, moe.moe_route = self._jax_apply, self._route


def _jax_sets(logp: np.ndarray, k: int) -> np.ndarray:
    """The reference's top-k: k rounds of first-index argmax, sorted."""
    masked, chosen = logp.copy(), []
    for _ in range(k):
        idx = masked.argmax(-1)
        chosen.append(idx)
        masked[np.arange(len(idx)), idx] = -np.inf
    return np.sort(np.stack(chosen, -1), -1)


@pytest.mark.parametrize("name", MOE)
def test_bf16_top2_routes_match_jax_layer_by_layer(name):
    """The served dtype at the published top-k of the reduced config
    (top-2 of 4): a prefill of two rows and one decode step, the routes of
    the two models compared at every layer, token by token. The two bf16
    residual streams differ by about 1 %, so a route may flip, but only
    where the difference explains it: a flip needs the port's margin to be
    at most twice the token's largest log-probability difference (the two
    experts' logits must cross), and that difference is held to
    ROUTE_LOGP_REL of the layer's largest |log-probability|. A flip changes
    its token's FFN output and, causally, every later position of its row
    in the layers after it: those are not compared; the rest are, at least
    ROUTE_COMPARED of all routes, and so are the logits at each row's last
    position not downstream of a flip (4e-2 of the largest value, as in
    the all-expert cases)."""
    jm, jp, tm, tp = _pair(name, compute_dtype="bfloat16")
    cfg = tm.cfg
    assert cfg.experts_per_token == 2 and cfg.n_experts == 4 and cfg.capacity_factor == 4.0
    cp = tm.compute_params(tp)
    B, S, K, L = 2, 12, cfg.experts_per_token, cfg.n_layers
    toks = np.random.default_rng(1).integers(1, 512, (B, S)).astype(np.int32)
    tok, pos = np.array([[5], [7]], np.int32), np.array([S, S], np.int32)
    with _Routes() as routes:
        _, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
        jc = jax.tree.map(lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]), jc)
        jd, _ = jax.jit(jm.decode)(jp, jc, {"tokens": jnp.asarray(tok),
                                            "positions": jnp.asarray(pos)})
        jax.block_until_ready(jd)
        _, tc = tm.prefill(cp, {"tokens": torch.from_numpy(toks)}, cache_len=S + 1)
        td, _ = tm.decode(cp, tc, {"tokens": torch.from_numpy(tok),
                                   "positions": torch.from_numpy(pos)})
    assert len(routes.jax) == len(routes.port) == 2 * L  # each layer's prefill, then decode
    clean = np.ones((B, S + 1), bool)  # positions no earlier flip reaches
    compared = flips = 0
    for i in range(2 * L):  # the prefill's layers, then the decode's
        at = np.s_[:, :S] if i < L else np.s_[:, S:]
        jlogp = routes.jax[i]
        tlogp, tset, margin = routes.port[i]
        diff = np.abs(tlogp - jlogp).max(-1)
        live = clean[at].reshape(-1)
        assert diff[live].max() <= ROUTE_LOGP_REL * np.abs(jlogp).max(), (i, diff.max())
        flip = (tset != _jax_sets(jlogp, K)).any(-1) & live
        assert (margin[flip] <= 2 * diff[flip]).all(), (i, margin[flip], diff[flip])
        compared += int(live.sum()) - int(flip.sum())
        flips += int(flip.sum())
        # a flip reaches its own position and every later one of its row
        rows, cols = np.nonzero(flip.reshape(clean[at].shape))
        for r, c in zip(rows, cols + (0 if i < L else S)):
            clean[r, c:] = False
    assert compared >= ROUTE_COMPARED * L * B * (S + 1), (compared, flips)

    # the logits at each row's last position that no flip reached
    last = np.array([int(np.nonzero(clean[r, :S])[0].max()) for r in range(B)], np.int32)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks), "last_pos": jnp.asarray(last)})
    tl, _ = tm.prefill(cp, {"tokens": torch.from_numpy(toks), "last_pos": torch.from_numpy(last)})
    jl = np.asarray(jl, np.float32)
    np.testing.assert_allclose(tl.float().numpy(), jl, atol=4e-2 * float(np.abs(jl).max()))
    ok = clean[:, S]  # rows whose decode step no flip reached
    jd = np.asarray(jd, np.float32)[ok]
    np.testing.assert_allclose(td.float().numpy()[ok], jd,
                               atol=4e-2 * float(np.abs(jd).max(initial=0.0)))


@pytest.mark.parametrize("cf", [4.0, 1.25])
@pytest.mark.parametrize("name", MOE)
def test_paged_steps_give_the_jax_next_tokens(name, cf):
    """The paged prefill of two right-padded prompts into a page pool, then
    four paged decode steps: the same next tokens as the JAX package's
    steps, and the same pages. At binding capacity the groups of prefill and
    decode differ, and drops with them, as in the reference."""
    ps, n_pages = 4, 12
    jm, jp, tm, tp = _pair(name, capacity_factor=cf)
    cp = tm.compute_params(tp)
    cfg = tm.cfg
    pool = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.resolved_head_dim)
    jk = jv = jnp.zeros(pool, jnp.float32)
    tk, tv = torch.zeros(pool), torch.zeros(pool)
    toks = np.random.default_rng(3).integers(1, 512, (2, 8)).astype(np.int32)
    toks[1, 5:] = 0
    last = np.array([7, 4], np.int32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)  # 16 positions a row
    jnext, jk, jv = jax_prefill_step(jm, page_size=ps, donate=False)(
        jp, jk, jv, jnp.asarray(toks), jnp.asarray(last), jnp.asarray(table[:, :2]))
    tnext, tk, tv = build_paged_prefill_step(tm, page_size=ps)(
        cp, tk, tv, torch.from_numpy(toks), torch.from_numpy(last),
        torch.from_numpy(table[:, :2].copy()))
    assert tnext.tolist() == np.asarray(jnext).tolist()
    jdec = jax_decode_step(jm, page_size=ps, donate=False)
    tdec = build_paged_decode_step(tm, page_size=ps)
    jtok, ttok = jnext[:, None], tnext[:, None]
    pos = last + 1
    for _ in range(4):
        jn, jk, jv = jdec(jp, jk, jv, jtok, jnp.asarray(pos), jnp.asarray(table))
        tn, tk, tv = tdec(cp, tk, tv, ttok, torch.from_numpy(pos), torch.from_numpy(table))
        assert tn.tolist() == np.asarray(jn).tolist()
        jtok, ttok, pos = jn[:, None], tn[:, None], pos + 1
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-5)


@pytest.mark.parametrize("name", MOE)
def test_param_counts_match_jax_at_full_width(name):
    """Total and active parameters of the published config, from the
    abstract (``meta``) specs: no storage at 1T."""
    tm = build_model(get_arch(name))
    assert all(t.device.type == "meta" for t in common.tree_leaves(tm.param_struct()))
    assert tm.expert_param_count() == jax_build_model(jax_get_arch(name)).expert_param_count()
    assert get_arch(name).param_count() == jax_get_arch(name).param_count()
    assert get_arch(name).active_param_count() == jax_get_arch(name).active_param_count()
    assert get_arch("smollm-135m").active_param_count() == get_arch("smollm-135m").param_count()


@pytest.mark.parametrize("name", MOE)
def test_params_from_jax_carries_every_moe_leaf(name):
    """Every leaf of the MoE pytree crosses with its shape and storage
    dtype (the f32 router, bf16 experts and shared experts), values kept."""
    jm = jax_build_model(jax_get_arch(name).reduced(param_dtype="bfloat16"))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    tp = params_from_jax(jp, "cpu")
    names = set(tp["layers"])
    assert {"router", "w_gate", "w_up", "w_down"} <= names
    assert ("shared_gate" in names) == (name == "kimi-k2-1t-a32b")
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["w_gate"].dtype == torch.bfloat16
    for key, arr in jp["layers"].items():
        t = tp["layers"][key]
        assert tuple(t.shape) == arr.shape, key
        assert str(t.dtype).removeprefix("torch.") == str(arr.dtype), key
        np.testing.assert_array_equal(t.to(torch.float32).numpy(), arr.astype(np.float32))
    spec = build_model(get_arch(name).reduced(param_dtype="bfloat16")).param_struct()
    assert set(spec["layers"]) == names


def test_router_init_is_small_and_experts_draw_fan_in():
    """The router draws normal 1e-3 (the reference's ``small``) in f32; the
    stacked expert weights draw 1/sqrt(fan_in) into their storage dtype,
    each expert its own values."""
    tm = build_model(get_arch("kimi-k2-1t-a32b").reduced(param_dtype="bfloat16"))
    p = tm.init(torch.Generator().manual_seed(0))
    router = p["layers"]["router"]
    assert router.dtype == torch.float32
    assert 0.8e-3 < float(router.std()) < 1.2e-3
    w = p["layers"]["w_gate"]
    assert w.dtype == torch.bfloat16 and w.shape == (2, 4, 128, 256)
    std = float(w.float().std())
    assert abs(std - 128 ** -0.5) < 0.02 * 128 ** -0.5
    assert not torch.equal(w[0, 0], w[0, 1])


@pytest.mark.parametrize("name", MOE)
def test_serve_launcher_takes_a_moe_arch_on_the_cpu(name, capsys):
    """``python -m repro_torch.launch.serve --arch <moe arch> --reduced
    --device cpu``: continuous batching over paged KV, nothing in the
    serving path told the family."""
    serve.main(["--arch", name, "--reduced", "--device", "cpu", "--mode", "continuous",
                "--requests", "2", "--batch", "2", "--prompt-len", "8", "--gen-tokens", "3"])
    assert "2 request batches, 12 tokens generated" in capsys.readouterr().out
