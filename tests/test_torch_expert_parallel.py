"""Expert parallelism on a mesh (``models/moe.py``): where the "model"
axis splits the expert count, each rank keeps and computes only its
E / n_model experts, in the train, prefill and decode steps, on gloo
ranks on the CPU, from the JAX package's weights (``params_from_jax``):

* phi3.5-moe reduced (4 experts top-2) at ``capacity_factor`` 1.0 and
  kimi-k2 reduced (4 experts top-2 and a shared one, at
  ``tests/test_torch_mesh_adafactor.py``'s 8 layers and d_ff 1024, under
  its Adafactor), each on a (2, 2) ("data", "model") mesh (2 experts a
  rank) and a (1, 4) mesh (1 expert a rank), routers x100
  (``tests/test_torch_moe.py``'s ROUTER_SCALE);
* train, B = 4 rows of 16 tokens (groups of 16: every group spans all the
  "model" ranks, whose partial buffers the owner sums) and, for phi, of 24
  (sequence shards of 12 or 6: "model" ranks hold overlapping but
  different groups, in different numbers), against the port's one-device
  step and the JAX package's one-device loss and gradients (phi: its
  first moments; kimi: the JAX Adafactor update);
* serving, 16 prompts of 28 tokens into a cache of 64 and 8 decode steps
  (phi from whole weights but for the expert tiles; kimi from ZeRO tiles,
  the path its full width takes), the logits against the JAX package's;
* phi with 3 experts on the (2, 2) mesh: "model" does not divide the
  expert count, so the experts are gathered whole, as before.

Structure, from spies in each rank (``torch_mesh_cases._ExpertSpies``):
every expert product holds E / n_model experts; no expert leaf is
gathered over "model" (only over its ZeRO axes); train and prefill steps
move tokens by all-to-all, decode steps by none, their combine summed by
a "model" all-reduce. A mutation, owners that keep one sender's partial
buffer of a group held by several (``_one_sender_only``), fails the
parity.

Tolerances are the mesh tests' (``tests/test_torch_mesh_families.py``,
``test_torch_mesh_adafactor.py``, ``test_torch_serve_mesh_families.py``):
metrics and losses to 1e-5 relative, each param's update to 1e-3 of its
norm, moments to 1e-3 of their leaf's largest |value|, logits atol 2e-5.

One rank group runs every case once (a module-scoped fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.runtime.optimizer import Optimizer as JaxOptimizer
from repro.runtime.optimizer import OptimizerConfig as JaxOptConfig
from repro_torch.launch.mesh import spawn_ranks

torch.set_num_threads(1)

PHI, KIMI = "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"
OVER = {"phi": {"capacity_factor": 1.0}, "kimi": {"n_layers": 8, "d_ff": 1024},
        "phi3": {"capacity_factor": 1.0, "n_experts": 3}}
ARCH = {"phi": PHI, "kimi": KIMI, "phi3": PHI}
OPT = {"phi": {"learning_rate": 1e-3, "warmup_steps": 0},
       "kimi": {"name": "adafactor", "first_moment": False, "learning_rate": 1e-3,
                "warmup_steps": 0}}
OPT["phi3"] = OPT["phi"]
N_MODEL = {"2x2": 2, "1x4": 4}
B, CACHE, STEPS, PROMPT = 4, 64, 8, 28
TRAIN = ["phi/2x2/16", "phi/1x4/16", "phi/2x2/24", "phi/1x4/24", "kimi/2x2/16", "kimi/1x4/16",
         "phi3/2x2/16"]
SERVE = ["phi/2x2", "phi/1x4", "kimi/2x2", "kimi/1x4"]
MUTATED = ["phi/2x2/16", "phi/1x4/serve"]
LOGIT_TOL = 2e-5


def _jax(model: str):
    m = jax_build_model(jax_get_arch(ARCH[model]).reduced(**OVER[model]))
    p = m.init(jax.random.key(0))
    p["layers"]["router"] = p["layers"]["router"] * 100.0
    return m, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    d = tmp_path_factory.mktemp("expert_parallel")
    rng = np.random.default_rng(29)
    params = {m: _jax(m)[1] for m in OVER}
    inp = {"cases": {}, "one_sender_only": MUTATED}
    for key in TRAIN:
        model, mesh, seq = key.split("/")
        inp["cases"][key] = {
            "kind": "train", "mesh": mesh, "arch": ARCH[model], "overrides": OVER[model],
            "opt": OPT[model], "seq_len": int(seq), "params": params[model],
            "batch": {"tokens": rng.integers(1, 512, (B, int(seq))).astype(np.int32)}}
    for key in SERVE:
        model, mesh = key.split("/")
        inp["cases"][f"{key}/serve"] = {
            "kind": "serve", "mesh": mesh, "arch": ARCH[model], "overrides": OVER[model],
            "zero": model == "kimi", "params": params[model], "cache_len": CACHE,
            "tokens": rng.integers(1, 512, (16, PROMPT)).astype(np.int32),
            "steps": rng.integers(1, 512, (STEPS, 16, 1)).astype(np.int32)}
    res = spawn_ranks(cases.expert_parallel_cases, 4, init_method=f"file://{d}/store",
                      args=(inp,), timeout=300)
    return inp, res


def _one_device(case: dict):
    """The port's one-device step from the same weights and batch: (initial
    params, metrics, params, optimizer state) as numpy."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_train_step
    from repro_torch.utils import tree_flatten_with_paths

    model = build_model(get_arch(case["arch"]).reduced(**case["overrides"]))
    opt = Optimizer(OptimizerConfig(**case["opt"]))
    params = params_from_jax(case["params"], "cpu")
    init = {p: x.clone().numpy() for p, x in tree_flatten_with_paths(params)}
    shape = ShapeConfig("t", case["seq_len"], B, "train")
    params, state, met = build_train_step(model, shape, opt.cfg, device="cpu")(
        params, opt.init(params), case["batch"])
    state = {k: {p: x.numpy() for p, x in tree_flatten_with_paths(v)}
             for k, v in state.items() if k != "step"}
    return (init, {k: float(v) for k, v in met.items()},
            {p: x.numpy() for p, x in tree_flatten_with_paths(params)}, state)


def _flat(tree) -> dict:
    from repro.utils.tree import tree_flatten_with_paths

    return {p: np.asarray(x) for p, x in tree_flatten_with_paths(tree)}


def _close_update(got: dict, want: dict, init: dict, what: str):
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        du, dj = got[path] - init[path], w - init[path]
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), (what, path)


@pytest.mark.parametrize("key", TRAIN)
def test_mesh_train_step_matches_the_one_device_step(ran, key):
    inp, res = ran
    case = inp["cases"][key]
    init, met, params, state = _one_device(case)
    for r in res:
        got = r[key]["metrics"]
        assert sorted(got) == sorted(met)
        for k in met:
            np.testing.assert_allclose(got[k], met[k], rtol=1e-5, err_msg=f"{key} {k}")
    _close_update(res[0][key]["params"], params, init, key)
    if "m" in state:
        for path, want in state["m"].items():
            np.testing.assert_allclose(res[0][key]["m"][path], want, rtol=0,
                                       atol=1e-3 * float(np.abs(want).max(initial=0)),
                                       err_msg=f"{key} {path}")
    for which in ("v_row", "v_col"):  # Adafactor's factored moments, tile by tile
        for path, want in state.get(which, {}).items():
            for r in res:
                tile, sl = r[key]["factored"][which][path]
                np.testing.assert_allclose(tile, want[tuple(slice(a, b) for a, b in sl)],
                                           rtol=0,
                                           atol=1e-3 * float(np.abs(want).max(initial=0)),
                                           err_msg=f"{key} {which} {path}")


@pytest.mark.parametrize("key", TRAIN)
def test_mesh_train_step_matches_the_jax_loss_and_gradients(ran, key):
    """The loss (and the MoE aux loss) against the JAX package's on one
    device; phi's first moments, 0.1 x the clip scale x the gradient,
    against the JAX gradient; kimi's updated params against the JAX
    package's Adafactor update of its gradients."""
    from repro.utils.tree import tree_flatten_with_paths as jax_paths

    inp, res = ran
    case = inp["cases"][key]
    model = key.split("/")[0]
    jm, jp = _jax(model)
    jp = jax.tree.map(jnp.asarray, jp)
    (loss, jmet), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, case["batch"]))
    got = res[0][key]["metrics"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for k in ("ce_loss", "aux_loss"):
        if k in jmet and k in got:
            np.testing.assert_allclose(got[k], float(jmet[k]), rtol=1e-5, err_msg=k)
    if res[0][key].get("m") is not None:
        scale = 0.1 * min(1.0, 1.0 / got["grad_norm"])
        for path, g in jax_paths(grads):
            g = np.asarray(g)
            np.testing.assert_allclose(res[0][key]["m"][path] / scale, g, rtol=0,
                                       atol=1e-3 * float(np.abs(g).max(initial=0)),
                                       err_msg=f"{key} {path}")
    else:
        opt = JaxOptimizer(JaxOptConfig(**OPT[model]))
        new, _, stats = opt.update(grads, opt.init(jp), jp)
        np.testing.assert_allclose(got["grad_norm"], float(stats["grad_norm"]), rtol=1e-5)
        _close_update(res[0][key]["params"], _flat(new), _flat(jp), key)


def _jax_serve(model: str, case: dict) -> list:
    """The JAX package's one-device prefill and decode logits of ``case``."""
    m, p = _jax(model)
    logits, cache = jax.jit(m.prefill)(p, {"tokens": jnp.asarray(case["tokens"])})
    S = cache["k"].shape[2]
    pad = [(0, 0), (0, 0), (0, CACHE - S), (0, 0), (0, 0)]
    cache = dict(cache, **{k: jnp.pad(cache[k], pad) for k in ("k", "v")})
    out, dec = [np.asarray(logits)], jax.jit(m.decode)
    n = case["tokens"].shape[0]
    for i, tok in enumerate(case["steps"]):
        logits, cache = dec(p, cache, {"tokens": jnp.asarray(tok),
                                       "positions": jnp.full((n,), S + i, jnp.int32)})
        out.append(np.asarray(logits))
    return out


def _rows(key: str, rank: int, n: int) -> slice:
    """A rank's rows of a global batch of ``n`` on the case's mesh."""
    n_model = N_MODEL[key.split("/")[1]]
    d, n_data = rank // n_model, 4 // n_model
    return slice(d * n // n_data, (d + 1) * n // n_data)


@pytest.fixture(scope="module")
def jax_served(ran):
    inp, _ = ran
    return {key: _jax_serve(key.split("/")[0], inp["cases"][f"{key}/serve"]) for key in SERVE}


@pytest.mark.parametrize("key", SERVE)
def test_mesh_prefill_and_decode_logits_match_jax(ran, jax_served, key):
    _, res = ran
    want = jax_served[key]
    for rank, r in enumerate(res):
        got = r[f"{key}/serve"]["logits"]
        assert len(got) == STEPS + 1
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w[_rows(key, rank, 16)], atol=LOGIT_TOL, rtol=0,
                                       err_msg=f"{key} rank {rank} call {step}")


@pytest.mark.parametrize("key", TRAIN + [f"{k}/serve" for k in SERVE])
def test_each_rank_holds_and_computes_only_its_experts(ran, key):
    """Every expert product of the step holds E / n_model experts, and
    each gather of an expert leaf runs over its ZeRO axes only, returning
    that many; with 3 experts over 2 "model" ranks the experts are
    gathered whole over "model" and computed whole."""
    _, res = ran
    model, mesh = key.split("/")[:2]
    E = 3 if model == "phi3" else 4
    held = E if model == "phi3" else E // N_MODEL[mesh]
    for r in res:
        spy = r[key]["spy"]
        assert [tuple(h) for h in spy["held"]] == [(held, held)], (key, spy["held"])
        for axes, n in spy["gathers"]:
            assert n == held, (key, axes, n)
            assert ("model" in axes) == (model == "phi3"), (key, axes)
        if model == "phi3":
            assert spy["gathers"], key  # the whole gather still runs
        if model == "kimi" and mesh == "2x2":  # ZeRO over "data": gathered a layer at a time
            assert len(spy["gathers"]) >= 3 * OVER["kimi"]["n_layers"], (key, spy["gathers"])


@pytest.mark.parametrize("key", TRAIN + [f"{k}/serve" for k in SERVE])
def test_tokens_move_by_all_to_all_in_train_and_prefill_not_in_decode(ran, key):
    """Train (forward and backward) and prefill steps run all-to-alls over
    "model", two a layer in the forward; decode steps run none, and sum
    each layer's combine over "model" instead (kimi-k2's shared expert's
    row-parallel product folded into the same sum), beside the two other
    d_model-wide sums of tensor-parallel serving: each layer's attention
    output (row-parallel) and the step's vocab-parallel embedding lookup;
    the 3-expert case moves no token."""
    _, res = ran
    model = key.split("/")[0]
    layers = OVER[model].get("n_layers", 2)
    for r in res:
        spy = r[key]["spy"]
        if model == "phi3":
            assert not spy["a2a"], spy
        elif key.endswith("serve"):
            assert spy["a2a"] == {"prefill": 2 * layers}, spy["a2a"]
            assert spy["combine"].get("decode", 0) == STEPS * (2 * layers + 1), spy["combine"]
        else:
            assert spy["a2a"] == {"train": 4 * layers}, spy["a2a"]  # and the backward's
            assert not spy["combine"], spy["combine"]


def test_an_owner_keeping_one_partial_buffer_fails_the_parity(ran):
    """Owners that keep only one sender's partial buffer of a group held by
    several "model" ranks lose the other ranks' tokens of it: the train
    step's loss leaves the one-device loss by more than 100x the
    tolerance, and so do the prefill logits the JAX ones."""
    inp, res = ran
    _, met, _, _ = _one_device(inp["cases"]["phi/2x2/16"])
    blind = res[0]["phi/2x2/16"]["one_sender_only"]
    assert abs(blind["loss"] - met["loss"]) > 100 * 1e-5 * abs(met["loss"]), (blind, met)
    want = _jax_serve("phi", inp["cases"]["phi/1x4/serve"])[0]
    got = res[0]["phi/1x4/serve"]["one_sender_only"][0]
    assert np.abs(got - want[_rows("phi/1x4", 0, 16)]).max() > 100 * LOGIT_TOL
