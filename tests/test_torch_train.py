"""The port's training path against the JAX package's (CPU), on the same
weights and tokens: ``DecoderLM.loss`` and every parameter's gradient (the
attention backward through ``FlashAttentionFn``'s plain version), three
steps of ``build_train_step`` with and without gradient accumulation, and
remat. The JAX side runs on a one-device mesh; weights and train states
cross with ``train_state_from_jax``.

Tolerances (f32, the reduced smollm config): the loss to 1e-5 and each
gradient to 1e-5 of its leaf's largest |value| (the same f32 products,
summed in other orders). Train steps, with AdamW at lr 1e-3: the loss, the
grad norm and the rate to 1e-5 relative; each leaf's update (new minus old
params) to 1e-3 of its norm, and its moments to 1e-3 of the leaf's largest
|value|: Adam divides each grad by its own root mean square, so an element
whose grad is near 0 turns an f32 rounding of it into a visible change of
its step, which the next step's grads then carry (no element can move more
than 2 lr per step apart: every param is held to that too). Remat changes
no arithmetic: "full" and "dots" equal "none" bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.registry import get_arch as jax_get_arch
from repro.launch.mesh import make_mesh
from repro.models import build_model as jax_build_model
from repro.runtime.optimizer import Optimizer as JaxOptimizer
from repro.runtime.optimizer import OptimizerConfig as JaxConfig
from repro.runtime.steps import build_train_step as jax_build_train_step
from repro.utils.tree import tree_flatten_with_paths as jax_paths
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models import build_model, params_from_jax, train_state_from_jax, tree_to_numpy
from repro_torch.models.common import chunked_cross_entropy, shift_targets
from repro_torch.runtime.optimizer import OptimizerConfig
from repro_torch.runtime.steps import build_train_step
from repro_torch.utils import tree_flatten_with_paths, tree_map_with_paths

torch.set_num_threads(1)

ARCH = "smollm-135m"
B, S = 4, 32


def _jax_pair(**overrides):
    jm = jax_build_model(jax_get_arch(ARCH).reduced())
    tm = build_model(get_arch(ARCH).reduced(**overrides))
    return jm, jm.init(jax.random.key(0)), tm


def _tokens(seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(np.int32)


def _with_grad(params):
    return tree_map_with_paths(lambda _, x: x.detach().clone().requires_grad_(True), params)


def test_shift_targets_and_chunked_cross_entropy_match_jax():
    from repro.models.common import chunked_cross_entropy as jax_ce
    from repro.models.common import shift_targets as jax_shift

    toks = _tokens(1, 3, 24)
    mask = np.random.default_rng(2).integers(0, 2, (3, 24)).astype(np.int32)
    jt, jm = jax_shift(jnp.asarray(toks), jnp.asarray(mask))
    tt, tmask = shift_targets(torch.from_numpy(toks), torch.from_numpy(mask))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jm))
    assert tmask.dtype == torch.float32 and not bool(tmask[:, -1].any())
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 24, 16)).astype(np.float32)
    emb = rng.normal(size=(512, 16)).astype(np.float32)
    # chunks of 8 (24 = 3 x 8) and one chunk of 24
    for chunk in (8, 1024):
        jtot, jcnt = jax_ce(jnp.asarray(x), jnp.asarray(emb), jt, jm, vocab_size=500, chunk=chunk)
        ttot, tcnt = chunked_cross_entropy(torch.from_numpy(x), torch.from_numpy(emb), tt, tmask,
                                           vocab_size=500, chunk=chunk)
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-5)
        assert float(tcnt) == float(jcnt)


def test_loss_and_every_gradient_match_jax():
    jm, jp, tm = _jax_pair()
    toks = _tokens(1)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks)})
    tp = _with_grad(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    tl, tmet = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == B * (S - 1)
    assert float(tmet["ce_loss"].detach()) == float(tl.detach())
    grads = dict(jax_paths(jax.tree.map(np.asarray, jg)))
    flat = tree_flatten_with_paths(tp)
    assert sorted(p for p, _ in flat) == sorted(grads)
    for path, leaf in flat:
        ref = grads[path]
        scale = float(np.abs(ref).max())
        assert scale > 0 and float(leaf.grad.abs().max()) > 0, path  # every leaf is reached
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=1e-5 * scale, err_msg=path)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_nothing(remat):
    """Each layer under ``torch.utils.checkpoint`` (everything recomputed,
    or the matmul outputs kept): the same loss and gradients, bitwise."""
    params = build_model(get_arch(ARCH).reduced()).init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(4))
    out = {}
    for mode in ("none", remat):
        model = build_model(get_arch(ARCH).reduced(remat=mode))
        p = _with_grad(params)
        loss, _ = model.loss(p, {"tokens": toks})
        loss.backward()
        out[mode] = (loss.detach(), [x.grad for _, x in tree_flatten_with_paths(p)])
    assert torch.equal(out["none"][0], out[remat][0])
    for a, b in zip(out["none"][1], out[remat][1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        build_model(get_arch(ARCH).reduced(remat="some")).loss(
            params, {"tokens": toks})


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_jax(accum):
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jm, jp, tm = _jax_pair()
    mesh = make_mesh((1, 1), ("data", "model"))
    jfn = jax_build_train_step(jm, mesh, JaxShape("t", S, B, "train"), JaxConfig(**kw),
                               grad_accum=accum, donate=False).fn
    js = JaxOptimizer(JaxConfig(**kw)).init(jp)
    state = train_state_from_jax(jax.tree.map(np.asarray, {"params": jp, "opt": js}), "cpu")
    fn = build_train_step(tm, ShapeConfig("t", S, B, "train"), OptimizerConfig(**kw),
                          grad_accum=accum, device="cpu")
    tp, to = state["params"], state["opt"]
    lr_sum = 0.0
    for step in range(3):
        toks = _tokens(10 + step)
        before_t = {p: x.clone() for p, x in tree_flatten_with_paths(tp)}
        before_j = dict(jax_paths(jax.tree.map(np.asarray, jp)))
        jp, js, jmet = jfn(jp, js, {"tokens": jnp.asarray(toks)})
        tp_in = tp
        tp, to, tmet = fn(tp, to, {"tokens": toks})
        assert tp is tp_in  # updated in place
        assert sorted(tmet) == sorted(jmet)
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
        lr_sum += float(jmet["lr"])
        assert all(not x.requires_grad for _, x in tree_flatten_with_paths(tp))
        for (path, a), (_, b) in zip(tree_flatten_with_paths(tp), jax_paths(jp)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2 * lr_sum, err_msg=path)
            du, dj = a.numpy() - before_t[path].numpy(), b - before_j[path]
            assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), path
        assert int(to["step"]) == int(js["step"]) == step + 1
        for (path, a), (_, b) in zip(tree_flatten_with_paths(to), jax_paths(js)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-3 * float(np.abs(b).max(initial=0)), err_msg=path)


def test_train_step_refuses_an_accumulation_that_does_not_divide_the_batch():
    with pytest.raises(ValueError, match="grad_accum"):
        build_train_step(build_model(get_arch(ARCH).reduced()), ShapeConfig("t", S, 6, "train"),
                         grad_accum=4, device="cpu")


def test_train_state_crosses_to_numpy_and_back():
    """``tree_to_numpy`` then ``train_state_from_jax``: every leaf, its
    dtype (a bf16 moment and the int32 step included) and value."""
    params = build_model(get_arch(ARCH).reduced()).init(torch.Generator().manual_seed(0))
    state = {"params": params,
             "opt": {"step": torch.tensor(3, dtype=torch.int32),
                     "m": tree_map_with_paths(lambda _, x: (x * 0.5).to(torch.bfloat16), params)}}
    back = train_state_from_jax(tree_to_numpy(state), "cpu")
    for (p, a), (q, b) in zip(tree_flatten_with_paths(state), tree_flatten_with_paths(back)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b), p
    assert str(tree_to_numpy(state)["opt"]["m"]["embed"].dtype) == "bfloat16"
    with pytest.raises(ValueError, match="params"):
        train_state_from_jax({"params": {}}, "cpu")
