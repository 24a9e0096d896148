"""Tensor-parallel serving (``runtime/steps.py`` ``build_prefill_step`` and
``build_decode_step`` on a mesh): each rank keeps the "model" tiles of the
weights, a decode step multiplies by them column- and row-parallel
(``models/common.py`` ``column_products`` / ``row_product``) and a prefill
step gathers each layer's tiles where the layer runs. One 4-rank gloo
group serves, on a (2, 2) and on a (1, 4) ("data", "model") mesh, the
reduced smollm, rwkv6, zamba2, phi3.5-moe (router x100), llava-next and
seamless-m4t from the JAX weights (``params_from_jax``), in f32: 4 prompts
of 16 tokens (llava: behind 16 patches; seamless: beside 16 frames) into a
cache of 48 positions, then 4 decode steps. Also on (2, 2): smollm and
kimi-k2 reduced with the weights kept as ZeRO tiles too; and on (1, 4):
smollm at d_ff 250, which "model" does not divide.

* Every call's logits of each rank's rows against the JAX package's
  one-device prefill and decode, within ``tests/test_torch_serve_mesh.py``'s
  and ``test_torch_serve_mesh_families.py``'s tolerances (2e-5 for the
  dense and MoE models; atol 2e-4, rtol 2e-3 for the others); each rank's
  cache tiles (K/V, seamless's memory, the recurrent states' rows) against
  the JAX caches' segments.
* Structure, from spies on ``unshard_many``, ``psum`` and ``all_gather``
  (``torch_mesh_cases._ServeSpies``): every served leaf is the rank's tile
  of its spec (1/n_model of each leaf on "model", the ZeRO tiles too);
  a decode step gathers no weight over "model" but the small vectors the
  model reads whole (``GATHERED_IN_DECODE``), their bytes exactly; it runs
  one ``psum`` a row-parallel product (and a MoE layer one for its
  combine, the shared expert's product folded in) and gathers the logits
  once; a prefill gathers each layer's "model" tiles once, never the
  experts' or the vocab's; with ZeRO a decode step gathers the product
  weights over "data" only.
* Mutations: a row-parallel slice one tile off, and the column tiles
  gathered out of order, each leave the JAX logits by far more than the
  tolerance.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.launch.mesh import spawn_ranks

torch.set_num_threads(1)

ARCH = {"smollm": "smollm-135m", "rwkv6": "rwkv6-3b", "zamba2": "zamba2-1.2b",
        "phi": "phi3.5-moe-42b-a6.6b", "llava": "llava-next-mistral-7b",
        "seamless": "seamless-m4t-medium", "kimi": "kimi-k2-1t-a32b", "smollm-odd": "smollm-135m"}
OVER = {"smollm-odd": {"d_ff": 250}}
TOL = {m: ({"atol": 2e-5, "rtol": 0} if m in ("smollm", "smollm-odd", "phi", "kimi")
           else {"atol": 2e-4, "rtol": 2e-3}) for m in ARCH}
MESH = {"2x2": (2, 2), "1x4": (1, 4)}
B, T, CACHE, STEPS, PATCHES, FRAMES = 4, 16, 48, 4, 16, 16
CASES = [f"{m}/{mesh}" for m in ("smollm", "rwkv6", "zamba2", "phi", "llava", "seamless")
         for mesh in MESH] + ["smollm/2x2/zero", "kimi/2x2/zero", "smollm-odd/1x4"]
MUTATED = "smollm/1x4"


def _jax(model: str):
    m = jax_build_model(jax_get_arch(ARCH[model]).reduced(**OVER.get(model, {})))
    p = m.init(jax.random.key(0))
    if "router" in p.get("layers", {}):  # as tests/test_torch_moe.py
        p["layers"]["router"] = p["layers"]["router"] * 100.0
    return m, jax.tree.map(np.asarray, p)


def _port(model: str):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    return build_model(get_arch(ARCH[model]).reduced(**OVER.get(model, {})))


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_parallel")
    rng = np.random.default_rng(30)
    base = {"tokens": rng.integers(1, 512, (B, T)).astype(np.int32),
            "steps": rng.integers(1, 512, (STEPS, B, 1)).astype(np.int32), "cache_len": CACHE}
    extra = {"llava": {"patch_embeds": rng.standard_normal((B, PATCHES, 128)).astype(np.float32)},
             "seamless": {"frame_embeds": rng.standard_normal((B, FRAMES, 128)).astype(
                 np.float32)}}
    params = {m: _jax(m)[1] for m in {k.split("/")[0] for k in CASES}}
    inp = {"cases": {}, "mutated": [MUTATED]}
    for key in CASES:
        model, mesh = key.split("/")[:2]
        inp["cases"][key] = dict(base, arch=ARCH[model], overrides=OVER.get(model, {}),
                                 mesh=mesh, zero=key.endswith("zero"), params=params[model],
                                 extra=extra.get(model, {}))
    res = spawn_ranks(cases.tensor_parallel_cases, 4, init_method=f"file://{d}/store",
                      args=(inp,), timeout=300)
    return inp, res


@pytest.fixture(scope="module")
def jax_served(ran):
    """The JAX package's one-device prefill and decode of each model: every
    call's logits, the prefill's cache (K/V grown to CACHE by zeros) and the
    cache after the last decode step."""
    inp, _ = ran
    out = {}
    for key in CASES:
        model = key.split("/")[0]
        if model in out:
            continue
        case = inp["cases"][key]
        m, p = _jax(model)
        batch = {"tokens": jnp.asarray(case["tokens"]),
                 **{k: jnp.asarray(v) for k, v in case["extra"].items()}}
        logits, cache = jax.jit(m.prefill)(p, batch)
        S = T + (PATCHES if "patch_embeds" in case["extra"] else 0)
        calls = [np.asarray(logits)]
        pad = [(0, 0), (0, 0), (0, CACHE - S), (0, 0), (0, 0)]
        cache = dict(cache, **{k: jnp.pad(cache[k], pad) for k in ("k", "v") if k in cache})
        first = jax.tree.map(np.asarray, cache)
        dec = jax.jit(m.decode)
        for i, tok in enumerate(case["steps"]):
            logits, cache = dec(p, cache, {"tokens": jnp.asarray(tok),
                                           "positions": jnp.full((B,), S + i, jnp.int32)})
            calls.append(np.asarray(logits))
        out[model] = calls, first, jax.tree.map(np.asarray, cache)
    return out


def _rows(key: str, coords: dict) -> slice:
    n_data = MESH[key.split("/")[1]][0]
    return slice(coords["data"] * B // n_data, (coords["data"] + 1) * B // n_data)


def _segment(key: str, coords: dict, n: int) -> slice:
    n_model = MESH[key.split("/")[1]][1]
    return slice(coords["model"] * n // n_model, (coords["model"] + 1) * n // n_model)


def _ranks(ran, key):
    """(coords, result) of every rank for ``key``."""
    _, res = ran
    mesh = key.split("/")[1]
    return [(r["coords"][mesh], r[key]) for r in res]


def _specs(key: str) -> tuple:
    """(the port's model, {path: spec}, {path: logical axes}, the mesh
    sizes) of ``key``'s serving weights."""
    from repro_torch.runtime.sharding import flatten_specs, param_shardings
    from repro_torch.runtime.steps import _serving_zero

    model = _port(key.split("/")[0])
    sizes = dict(zip(("data", "model"), MESH[key.split("/")[1]]))
    mesh = types.SimpleNamespace(shape=sizes)
    zero = key.endswith("zero") or _serving_zero(model, mesh)
    return (model, flatten_specs(param_shardings(model, mesh, zero=zero)),
            flatten_specs(model.param_axes()), sizes)


def _full_shapes(model) -> dict:
    from repro_torch.utils import tree_flatten_with_paths

    return {p: list(x.shape) for p, x in tree_flatten_with_paths(model.param_struct())}


@pytest.mark.parametrize("key", CASES)
def test_logits_match_jax(ran, jax_served, key):
    want = jax_served[key.split("/")[0]][0]
    for coords, r in _ranks(ran, key):
        assert len(r["logits"]) == STEPS + 1
        for step, (g, w) in enumerate(zip(r["logits"], want)):
            np.testing.assert_allclose(g, w[_rows(key, coords)], **TOL[key.split("/")[0]],
                                       err_msg=f"{key} {coords} call {step}")


@pytest.mark.parametrize("key", CASES)
def test_cache_tiles_are_the_jax_segments(ran, jax_served, key):
    """Each rank's K/V tiles after the prefill and after the last step (and
    seamless's memory tiles) are the JAX caches' segments; the recurrent
    states (RWKV6's, Zamba2's Mamba2 layers') the rows' whole states."""
    model = key.split("/")[0]
    _, first, final = jax_served[model]
    tol = TOL[model]
    checked = 0
    for coords, r in _ranks(ran, key):
        rows = _rows(key, coords)
        for name, cache in (("cache", first), ("final_cache", final)):
            for k in ("k", "v"):
                if k in cache:
                    np.testing.assert_allclose(
                        r[name][k], cache[k][:, rows, _segment(key, coords, CACHE)], **tol,
                        err_msg=f"{key} {coords} {name} {k}")
                    checked += 1
        for k, mem in first.items():
            if k in ("k_mem", "v_mem"):
                np.testing.assert_allclose(
                    r["cache"][k], mem[:, rows, _segment(key, coords, mem.shape[2])], **tol)
        flat = {"mamba/conv": first.get("mamba", {}).get("conv"),
                "mamba/ssd": first.get("mamba", {}).get("ssd"),
                **{k: first.get(k) for k in ("tm_shift", "cm_shift", "wkv")}}
        for k, want in flat.items():
            if want is not None:
                np.testing.assert_allclose(r["cache"][k], want[:, rows], **tol,
                                           err_msg=f"{key} {coords} {k}")
                checked += 1
    assert checked


@pytest.mark.parametrize("key", CASES)
def test_every_served_leaf_is_the_ranks_tile(ran, key):
    """The params the steps take are each leaf's tile of its spec: 1/n_model
    of every leaf sharded on "model" (the tensor axes: the embedding and
    head, every layer matrix, the experts), and with ZeRO their "data"
    tiles too; only leaves with no tensor axis "model" divides are whole."""
    from repro_torch.runtime.sharding import spec_axes

    model, specs, _, sizes = _specs(key)
    full = _full_shapes(model)
    on_model = [p for p, s in specs.items() if "model" in spec_axes(s)]
    assert len(on_model) >= 3, on_model
    for _, r in _ranks(ran, key):
        shapes = r["spy"]["shapes"]
        assert sorted(shapes) == sorted(full)
        for path, spec in specs.items():
            want = list(full[path])
            for i, entry in enumerate(spec):
                for a in ((entry,) if isinstance(entry, str) else entry or ()):
                    want[i] //= sizes[a]
            assert shapes[path] == want, (key, path, spec)


@pytest.mark.parametrize("key", CASES)
def test_decode_gathers_no_weight_matrix_over_model(ran, key):
    """A decode step gathers over "model" only the small vectors the model
    reads whole (``GATHERED_IN_DECODE``: RWKV6's decay base and WKV norm,
    Mamba2's conv weights and SSD norm), each layer's once a step: their
    bytes exactly; every other weight stays the rank's tile (with ZeRO,
    gathered over "data" only)."""
    model, specs, axes, _ = _specs(key)
    full = _full_shapes(model)
    names = set(model.GATHERED_IN_DECODE)
    vectors = [p for p in specs if p.rsplit("/", 1)[-1] in names and "model" in specs[p]]
    per_step = sum(int(np.prod(full[p])) * 4 for p in vectors)  # f32 leaves, whole
    for _, r in _ranks(ran, key):
        over_model = [(p, b) for kind, p, ax, b in r["spy"]["gathers"]
                      if kind == "decode" and "model" in ax]
        assert {p for p, _ in over_model} == set(vectors), (key, over_model)
        assert sum(b for _, b in over_model) == STEPS * per_step
        if key.endswith("zero"):
            data = [p for kind, p, ax, _ in r["spy"]["gathers"]
                    if kind == "decode" and ax == ["data"]]
            assert any(p.endswith("wqkv") for p in data), data


def _row_products(model) -> tuple[int, int]:
    """(row-parallel products a decode step runs through ``row_product``'s
    own ``psum``, MoE layers whose combine is one ``psum``) of a reduced
    model on a mesh whose "model" axis splits every product's dim."""
    cfg, L = model.cfg, model.cfg.n_layers
    if cfg.n_experts:
        return L, L  # the attention output; the combine, a shared expert folded in
    if cfg.family == "ssm":
        return 2 * L, 0  # the time mix's output, the channel mix's value
    if cfg.family == "hybrid":
        return 2 * model.n_sites + L, 0  # the shared block's output and down; each w_out
    if cfg.n_enc_layers:
        return 3 * L, 0  # self- and cross-attention outputs, the MLP's down
    return 2 * L, 0


@pytest.mark.parametrize("key", CASES)
def test_each_row_parallel_product_runs_one_psum(ran, key):
    """Per decode step, one ``psum`` a row-parallel product and one a MoE
    layer's fold; none in a prefill (its layers' weights gathered), whose
    last position's logits, like each decode step's, are gathered from the
    head's vocab tiles once."""
    model = _port(key.split("/")[0])
    rows, moe_sums = _row_products(model)
    if key == "smollm-odd/1x4":
        rows = model.cfg.n_layers  # d_ff 250 does not split over 4: the MLP runs whole
    for _, r in _ranks(ran, key):
        psums = {(k, f, a): n for k, f, a, n in r["spy"]["psums"]}
        assert psums.get(("decode", "row_product", "model"), 0) == STEPS * rows, psums
        assert psums.get(("decode", "moe_apply", "model"), 0) == STEPS * moe_sums, psums
        assert not any(k == "prefill" and f == "row_product" for k, f, _ in psums), psums
        gathers = {(k, f): n for k, f, _, n in r["spy"]["act_gathers"]}
        assert gathers[("decode", "vocab_logits")] == STEPS, gathers
        assert gathers[("prefill", "vocab_logits")] == 1, gathers
        assert gathers[("decode", "_gathered_slices")] >= STEPS, gathers


@pytest.mark.parametrize("key", CASES)
def test_prefill_gathers_each_layers_tiles_once(ran, key):
    """A prefill gathers every layer leaf on "model" once a layer (an
    unstacked block, Zamba2's shared one, once), never an expert or vocab
    leaf over "model"."""
    from repro_torch.runtime.sharding import spec_axes

    model, specs, axes, _ = _specs(key)
    for _, r in _ranks(ran, key):
        count: dict = {}
        for kind, p, ax, _ in r["spy"]["gathers"]:
            if "model" in ax:
                assert "experts" not in axes[p] and "vocab" not in axes[p], (kind, p)
                if kind == "prefill":
                    count[p] = count.get(p, 0) + 1
        for p, spec in specs.items():
            if "model" not in spec_axes(spec) or {"experts", "vocab"} & set(axes[p]):
                continue
            layers = model.cfg.n_enc_layers if p.startswith("encoder/") else model.cfg.n_layers
            want = layers if axes[p][0] == "layers" else 1
            assert count.get(p, 0) == want, (key, p, count.get(p))


def test_an_indivisible_dim_is_served_whole(ran):
    """smollm at d_ff 250 on 4 "model" ranks: the MLP's spec keeps its dim
    whole, so its weights are served whole and its products run whole,
    while the attention's and the vocab's are tiles."""
    model, specs, _, _ = _specs("smollm-odd/1x4")
    full = _full_shapes(model)
    for _, r in _ranks(ran, "smollm-odd/1x4"):
        shapes = r["spy"]["shapes"]
        for leaf in ("w_up", "w_gate", "w_down"):
            assert "model" not in specs[f"layers/{leaf}"]
            assert shapes[f"layers/{leaf}"] == full[f"layers/{leaf}"]
        assert shapes["layers/wqkv"][-1] * 4 == full["layers/wqkv"][-1]
        assert shapes["embed"][0] * 4 == full["embed"][0]


@pytest.mark.parametrize("mutation", ["slice_one_off", "out_of_order"])
def test_a_mutated_tile_fails_the_parity(ran, jax_served, mutation):
    """A row-parallel product that takes the input slice one tile off, or
    column tiles gathered out of rank order, leave the JAX logits by more
    than 100x the tolerance, in the prefill's logits (the head's vocab
    tiles; with the slice one off, only decode products) or a decode
    step's."""
    want = jax_served["smollm"][0]
    for coords, r in _ranks(ran, MUTATED):
        got = r[mutation]
        worst = max(float(np.abs(g - w[_rows(MUTATED, coords)]).max())
                    for g, w in zip(got[1:], want[1:]))
        assert worst > 100 * TOL["smollm"]["atol"], (mutation, worst)
