"""Training the VLM, enc-dec, RWKV6 and Zamba2 families in the port against
the JAX package's (CPU), on the same weights (``params_from_jax``) and
batches: each family's loss and every parameter's gradient, remat, and
``LMTrainApp`` and the launcher on the two families that train on token
messages (the other two are refused there). Three steps of
``build_train_step`` with and without gradient accumulation are in
``tests/test_torch_train_families_steps.py``, on this module's inputs.

Batches follow ``tests/test_models.py``'s ``make_batch`` at B = 2, drawn
from numpy seeds: llava's 16 tokens behind its 16 patch embeddings (the
gradient reaches ``vision_proj`` and the patch positions); seamless's 16
tokens beside 32 frame embeddings, so that its cross-attention runs at
Sq != Skv as on the card (128 against 256); rwkv6 and zamba2 at 128 tokens,
so that the chunked WKV6 (chunks of 32) and SSD (chunks of 64) scans carry
their states through 4 and 2 chunks.

Tolerances are ``tests/test_torch_train.py``'s (f32, ``reduced()``): the
loss to 1e-5 and each gradient to 1e-5 of its leaf's largest |value|; a
train step's loss, grad norm and rate to 1e-5 relative, each leaf's update
to 1e-3 of its norm, each moment to 1e-3 of the leaf's largest |value|,
each param to 2 lr a step; remat bitwise. The apps' losses: 1e-4
relative, over five batches through each package's ``LMTrainApp``.
RWKV6's and Zamba2's f32 gradients are further from exact than that in
either package (``GRAD_TOL``): they are held to the sum of the two
packages' distances from an f64 evaluation; an element whose moment lies
within that distance of zero (its Adam step about lr in either sign) is
held to the 2 lr bound only, and their three chained steps to the sum of
the packages' distances from three f64 steps (``STEP_TOL`` there).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.miniapps.masa import LMTrainApp as JaxTrainApp
from repro.models import build_model as jax_build_model
from repro.runtime.optimizer import OptimizerConfig as JaxConfig
from repro.utils.tree import tree_flatten_with_paths as jax_paths
from repro_torch.configs import get_arch
from repro_torch.launch import train as launcher
from repro_torch.miniapps import LMTrainApp
from repro_torch.models import build_model, params_from_jax, train_state_from_jax
from repro_torch.runtime.optimizer import OptimizerConfig
from repro_torch.utils import tree_flatten_with_paths, tree_map_with_paths

torch.set_num_threads(1)

ARCHS = ("llava-next-mistral-7b", "seamless-m4t-medium", "rwkv6-3b", "zamba2-1.2b")
TOKEN_ARCHS = ("rwkv6-3b", "zamba2-1.2b")  # the families a token stream trains
B = 2
KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
# each gradient to this much of its leaf's largest |value| (1e-5 by default):
# RWKV6's and Zamba2's f32 gradients at these inputs lie up to 6.6e-5 and
# 1.1e-5 (the port) and 4.2e-5 and 9.6e-6 (the JAX package) of the leaf's
# largest |value| from an f64 evaluation of the same model, where llava's
# and seamless's lie within 2e-6 (tests/grad_precision.py), so the two
# packages may differ by the sum, 1.1e-4 and 2.0e-5
GRAD_TOL = {"rwkv6-3b": 1.5e-4, "zamba2-1.2b": 2.5e-5}


class Msg:
    def __init__(self, value):
        self.value = value


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """The JAX model and its params (drawn once a process: seconds each)."""
    jm = jax_build_model(jax_get_arch(arch).reduced())
    return jm, jm.init(jax.random.key(0))


def _jax_pair(arch, **overrides):
    return (*_jax_model(arch), build_model(get_arch(arch).reduced(**overrides)))


def _batch(cfg, seed, b=B):
    """``make_batch``'s keys and widths, from a numpy seed (see the module
    docstring for the lengths)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, 16)).astype(np.int32),
                "patch_embeds": rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, 16)).astype(np.int32),
                "frame_embeds": rng.normal(size=(b, 32, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, 128)).astype(np.int32)}


def _positions(batch):
    """The sequence length a ``ShapeConfig`` of this batch names (the JAX
    step reads it only for its dry-run structs)."""
    t = batch["tokens"].shape[1]
    return t + sum(v.shape[1] for k, v in batch.items() if k != "tokens")


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _with_grad(params):
    return tree_map_with_paths(lambda _, x: x.detach().clone().requires_grad_(True), params)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jm, jp, tm = _jax_pair(arch)
    batch = _batch(tm.cfg, 1)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, _jax(batch))
    tp = _with_grad(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    tl, tmet = tm.loss(tp, _torch(batch))
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == B * (batch["tokens"].shape[1] - 1)
    grads = dict(jax_paths(jax.tree.map(np.asarray, jg)))
    flat = tree_flatten_with_paths(tp)
    assert sorted(p for p, _ in flat) == sorted(grads)
    for path, leaf in flat:
        ref = grads[path]
        scale = float(np.abs(ref).max())
        assert scale > 0 and float(leaf.grad.abs().max()) > 0, path  # every leaf is reached
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=GRAD_TOL.get(arch, 1e-5) * scale,
                                   err_msg=path)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_nothing(arch, remat):
    """Every checkpointed region (llava's and rwkv6's layers; seamless's
    encoder layers and its decoder layers, whose closure over the encoder's
    memory must carry the gradient back through the checkpoint; zamba2's
    weight-tied shared site, its gradient summed over the sites, and its
    Mamba2 layers): the same loss and gradients as ``remat="none"``,
    bitwise."""
    params = build_model(get_arch(arch).reduced()).init(torch.Generator().manual_seed(0))
    batch = _torch(_batch(get_arch(arch).reduced(), 4))
    out = {}
    for mode in ("none", remat):
        model = build_model(get_arch(arch).reduced(remat=mode))
        p = _with_grad(params)
        loss, _ = model.loss(p, batch)
        loss.backward()
        out[mode] = (loss.detach(), [(path, x.grad) for path, x in tree_flatten_with_paths(p)])
    assert torch.equal(out["none"][0], out[remat][0])
    for (path, a), (_, b) in zip(out["none"][1], out[remat][1]):
        assert a is not None and torch.equal(a, b), path


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_lm_train_app_matches_the_jax_app(arch):
    """The same token messages (three of 2 rows, one of 4: two steps, and
    one of 1 row, padded) through both packages' ``LMTrainApp`` from the
    JAX app's initial state: the losses of every batch."""
    japp = JaxTrainApp(jax_get_arch(arch).reduced(), opt_cfg=JaxConfig(**KW), seqs_per_step=2,
                       seq_len=64)
    shard = dict(zip(("params", "opt"), japp.bundle.in_shardings))  # no second compile
    jstate = {k: jax.device_put(v, shard[k]) for k, v in japp.init_state().items()}
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")  # copies
    tapp = LMTrainApp(get_arch(arch).reduced(), opt_cfg=OptimizerConfig(**KW), seqs_per_step=2,
                      seq_len=64, device="cpu")
    rng = np.random.default_rng(7)
    for rows in (2, 2, 4, 2, 1):
        msg = [Msg(rng.integers(0, 512, (rows, 64)).astype(np.int32))]
        jstate = japp.process(jstate, msg)
        tstate = tapp.process(tstate, msg)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 6
    np.testing.assert_allclose(tapp.losses, japp.losses, rtol=1e-4)
    assert len(tapp.losses) == 5 and all(np.isfinite(tapp.losses))


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_the_launcher_trains_the_state_families(arch, tmp_path):
    """``launch/train.py``'s ``run`` on the reduced config on the CPU, with
    ``--checkpoint-every`` past the last step: the steps taken, the losses
    finite, and nothing written."""
    run = launcher.run(launcher.parse_args([
        "--arch", arch, "--reduced", "--device", "cpu", "--steps", "2", "--seq-len", "64",
        "--batch", "2", "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "3"]))
    losses = run.app.losses
    assert int(run.stream.state["opt"]["step"]) == run.app.stats.batches >= 2
    assert len(losses) == run.app.stats.batches and all(np.isfinite(losses))
    assert not list((tmp_path / "ck").glob("step_*"))


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "seamless-m4t-medium"])
def test_lm_train_app_refuses_the_families_a_token_stream_cannot_feed(arch, tmp_path):
    """C12: a VLM or enc-dec config is refused at construction, naming the
    route that trains it (the JAX app fails at its first step), by the app
    and by the launcher."""
    with pytest.raises(ValueError, match="build_train_step"):
        LMTrainApp(get_arch(arch).reduced(), device="cpu")
    with pytest.raises(ValueError, match="embeddings beside its tokens"):
        launcher.run(launcher.parse_args(["--arch", arch, "--reduced", "--device", "cpu",
                                          "--checkpoint-dir", str(tmp_path)]))
