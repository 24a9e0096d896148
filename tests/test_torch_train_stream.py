"""The port's streaming training on the CPU: ``LMTrainApp`` over a token
stream (the loss drops, as ``tests/test_system.py`` holds the JAX app to),
its batching, padding and rescale hook (its rule, and a move onto a rank
group and back), train states checkpointed by one package and continued by
the other, the launcher ``python -m repro_torch.launch.train`` with
``--resume``, on one device and on a lease of two, and the data helpers.
The group app against the JAX package: ``tests/test_torch_train_group.py``.

A state that crosses a checkpoint is compared bitwise; the step each
package then takes from it is held to ``tests/test_torch_train.py``'s
train-step tolerances (the loss and grad norm to 1e-5 relative, each
leaf's update to 1e-3 of its norm, the moments to 1e-3 of the leaf's
largest |value|).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.registry import get_arch as jax_get_arch
from repro.data.batching import batch_messages as jax_batch_messages
from repro.launch.mesh import make_mesh
from repro.models import build_model as jax_build_model
from repro.runtime.optimizer import Optimizer as JaxOptimizer
from repro.runtime.optimizer import OptimizerConfig as JaxConfig
from repro.runtime.steps import build_train_step as jax_build_train_step
from repro.utils.tree import tree_flatten_with_paths as jax_paths
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core import PilotComputeService
from repro_torch.data import DevicePrefetcher, batch_messages, shard_batch
from repro_torch.launch.mesh import MeshSpec
from repro_torch.miniapps import LMTrainApp, SourceConfig, TokenSource
from repro_torch.miniapps.masa import GroupState, _rescale_mesh
from repro_torch.runtime.optimizer import OptimizerConfig
from repro_torch.utils import tree_flatten_with_paths, tree_map_with_paths

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)


class Msg:
    def __init__(self, value):
        self.value = value


def _tokens(seed, b=4, s=32):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(np.int32)


def test_streaming_lm_training_loss_drops():
    """A TokenSource stream through the broker and the micro-batch engine
    into ``LMTrainApp`` on a CPU slot, one message (4 sequences of 64
    tokens) a batch, as the JAX package's system test runs it."""
    cfg = get_arch("smollm-135m").reduced(n_layers=2)
    svc = PilotComputeService(devices=[CPU])
    try:
        cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
        cluster.create_topic("tokens", 2)
        ctx = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"}).get_context()
        src = TokenSource(cluster, SourceConfig("tokens", total_messages=6),
                          vocab_size=cfg.vocab_size, seq_len=64, seqs_per_msg=4)
        app = LMTrainApp(cfg, opt_cfg=OptimizerConfig(learning_rate=3e-3, warmup_steps=1),
                         seqs_per_step=4, seq_len=64, device=ctx.devices[0])
        s = ctx.stream(cluster, "tokens", group="lm", process_fn=app.process,
                       batch_interval=0.02, max_batch_records=1, backpressure=False)
        src.start()
        s.start()
        s.await_batches(5, timeout=120)
        s.stop()
        src.stop()
    finally:
        svc.cancel()
    losses = app.losses
    assert len(losses) >= 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert app.stats.items == app.stats.messages * 4 * 64
    assert {x.device for _, x in tree_flatten_with_paths(s.state)} == {CPU}
    assert int(s.state["opt"]["step"]) == app.stats.batches


def test_process_pads_a_short_window_and_steps_per_full_batch(monkeypatch):
    """Rows are cut into steps of ``seqs_per_step``; a window shorter than
    one step is padded with zero rows (the JAX app's rule), and the tokens
    counted are the rows received."""
    app = LMTrainApp(get_arch("smollm-135m").reduced(), seqs_per_step=4, seq_len=32,
                     device="cpu")
    seen = []
    real = app.step_fn

    def spy(params, opt, batch):
        seen.append(batch["tokens"].copy())
        return real(params, opt, batch)

    monkeypatch.setattr(app, "step_fn", spy)
    state = app.process(None, [Msg(_tokens(0, 2))])
    assert seen[0].shape == (4, 32) and not seen[0][2:].any()
    np.testing.assert_array_equal(seen[0][:2], _tokens(0, 2))
    state = app.process(state, [Msg(_tokens(1, 4)), Msg(_tokens(2, 4))])
    assert len(seen) == 3 and int(state["opt"]["step"]) == 3
    assert app.stats.items == 10 * 32 and app.stats.batches == 2
    assert len(app.losses) == 2


def test_on_rescale_keeps_the_state_on_the_slots_device():
    """The slots of one device give the one-device app with plain tensors;
    distinct devices give a rank group of that size (ROADMAP C17): here
    ``cpu`` and ``cpu:0``, which ``torch.device`` tells apart, stand for
    two devices. Back on one device, the state is plain tensors again,
    each step the same as the app that never left it."""
    app = LMTrainApp(get_arch("smollm-135m").reduced(), seqs_per_step=2, seq_len=16,
                     device="cpu")
    state = app.process(None, [Msg(_tokens(0, 2, 16))])
    moved = app.on_rescale([CPU, CPU])(state)
    assert app.device == CPU and app.mesh is None and app.group is None
    assert {x.device for _, x in tree_flatten_with_paths(moved)} == {CPU}
    moved = app.process(moved, [Msg(_tokens(1, 2, 16))])
    alone = LMTrainApp(get_arch("smollm-135m").reduced(), seqs_per_step=2, seq_len=16,
                       device="cpu")
    kept = alone.place_state(tree_map_with_paths(lambda _, x: x.clone(), moved))
    two = [CPU, torch.device("cpu", 0)]
    try:
        grouped = app.on_rescale(two)(moved)
        assert isinstance(grouped, GroupState) and grouped.step == 2
        assert app.mesh == MeshSpec((2, 1), two) and app.group.size == 2
        grouped = app.process(grouped, [Msg(_tokens(2, 2, 16))])
        back = app.on_rescale([CPU])(grouped)
        assert app.mesh is None and app.group is None
        assert [g["shape"] for g in app.groups] == [[2, 1]]
        assert [(r["from"], r["to"]) for r in app.rescales] == [("cpu", (2, 1)), ((2, 1), "cpu")]
    finally:
        app.close()
    assert {x.device for _, x in tree_flatten_with_paths(back)} == {CPU}
    assert int(back["opt"]["step"]) == 3
    kept = alone.process(kept, [Msg(_tokens(2, 2, 16))])
    np.testing.assert_allclose(app.losses[-1], alone.losses[-1], rtol=1e-5)
    for (path, a), (_, b) in zip(tree_flatten_with_paths(back), tree_flatten_with_paths(kept)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("devices, keeps_group, shape, backend", [
    ([CPU, CPU], False, None, None),
    ([torch.device("cuda", 0)] * 4, False, None, None),
    ([torch.device("cuda", 0), torch.device("cuda", 1)], False, (2, 1), "nccl"),
    ([torch.device("cuda", 0)] * 4, True, (4, 1), "gloo"),
    ([CPU], True, (1, 1), "gloo"),
    ([torch.device("cuda", 1)], True, (1, 1), "nccl"),
])
def test_the_rescale_rule(devices, keeps_group, shape, backend):
    """``on_rescale``'s placement: one device (or one repeated) is the
    one-device app unless the app was built with a mesh; otherwise a
    (len(devices), 1) group, NCCL over distinct cards, else gloo."""
    target = _rescale_mesh(devices, keeps_group=keeps_group)
    if shape is None:
        assert target is None
    else:
        assert target.shape == shape and target.backend == backend
        assert list(target.devices) == devices


def _close_step(tp, to, tmet, jp, js, jmet, before):
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    for (path, a), (_, b) in zip(tree_flatten_with_paths(tp), jax_paths(jp)):
        du, dj = a.numpy() - before[path], np.asarray(b) - before[path]
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), path
    assert int(to["step"]) == int(js["step"])
    for (path, a), (_, b) in zip(tree_flatten_with_paths(to), jax_paths(js)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-3 * float(np.abs(b).max(initial=0)), err_msg=path)


def test_train_states_cross_checkpoints_both_ways_and_continue_alike(tmp_path):
    """A state the JAX package trained one step and saved restores in the
    port bitwise (into ``LMTrainApp.init_state()``, the launcher's
    template); a state the port trained and saved restores in the JAX
    package bitwise; from each, both packages' next steps agree."""
    cfg = jax_get_arch("smollm-135m").reduced()
    jm = jax_build_model(cfg)
    jfn = jax_build_train_step(jm, make_mesh((1, 1), ("data", "model")),
                               JaxShape("t", 32, 4, "train"), JaxConfig(**KW), donate=False).fn
    app = LMTrainApp(get_arch("smollm-135m").reduced(), opt_cfg=OptimizerConfig(**KW),
                     seqs_per_step=4, seq_len=32, device="cpu")
    jp = jm.init(jax.random.key(0))
    js = JaxOptimizer(JaxConfig(**KW)).init(jp)
    jp, js, _ = jfn(jp, js, {"tokens": jnp.asarray(_tokens(0))})

    # JAX -> port
    JaxManager(str(tmp_path / "j")).save(1, {"params": jp, "opt": js}, meta={"offsets": {"0": 3}})
    state, meta = CheckpointManager(str(tmp_path / "j")).restore(app.init_state())
    assert meta == {"offsets": {"0": 3}}
    for (p, a), (q, b) in zip(tree_flatten_with_paths(state), jax_paths({"params": jp, "opt": js})):
        assert p == q and str(a.dtype).removeprefix("torch.") == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=p)
    before = {p: x.numpy().copy() for p, x in tree_flatten_with_paths(state["params"])}
    toks = _tokens(1)
    tp, to, tmet = app.step_fn(state["params"], state["opt"], {"tokens": toks})
    jp2, js2, jmet = jfn(jp, js, {"tokens": jnp.asarray(toks)})
    _close_step(tp, to, tmet, jp2, js2, jmet, before)

    # port -> JAX: the port's state after its own step
    CheckpointManager(str(tmp_path / "t")).save(2, {"params": tp, "opt": to})
    template = {"params": jp2, "opt": js2}
    restored, _ = JaxManager(str(tmp_path / "t")).restore(template)
    for (p, a), (q, b) in zip(tree_flatten_with_paths({"params": tp, "opt": to}),
                              jax_paths(restored)):
        assert p == q
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=p)
    before = {p: x.numpy().copy() for p, x in tree_flatten_with_paths(tp)}
    toks = _tokens(2)
    jp3, js3, jmet = jfn(restored["params"], restored["opt"], {"tokens": jnp.asarray(toks)})
    tp, to, tmet = app.step_fn(tp, to, {"tokens": toks})
    _close_step(tp, to, tmet, jp3, js3, jmet, before)


def _launch(*args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
         "--steps", "3", "--checkpoint-every", "1", "--checkpoint-dir", str(tmp_path / "ck"),
         *args], capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)


def test_the_launcher_trains_checkpoints_and_resumes(tmp_path):
    first = _launch(tmp_path=tmp_path)
    assert first.returncode == 0, first.stderr
    assert "[train]" in first.stdout and "on cpu" in first.stdout
    steps = sorted((tmp_path / "ck").glob("step_*"))
    assert len(steps) == 2  # keep_last=2 of one checkpoint per batch
    last = int(steps[-1].name.split("_")[1])
    second = _launch("--resume", tmp_path=tmp_path)
    assert second.returncode == 0, second.stderr
    assert f"[train] resumed from step {last}" in second.stdout


def test_the_launcher_trains_on_a_lease_of_two_devices_and_resumes(tmp_path):
    """``--devices 2``: the training pilot leases two CPU slots and the app
    trains on a (2, 1) gloo group over them; its checkpoints (gathered
    full leaves) resume onto a group again, each rank reading its tiles."""
    first = _launch("--devices", "2", tmp_path=tmp_path)
    assert first.returncode == 0, first.stderr
    assert "on a (2, 1) gloo group of cpu, cpu" in first.stdout
    steps = sorted((tmp_path / "ck").glob("step_*"))
    assert len(steps) == 2
    last = int(steps[-1].name.split("_")[1])
    second = _launch("--resume", "--devices", "2", tmp_path=tmp_path)
    assert second.returncode == 0, second.stderr
    assert f"[train] resumed from step {last}" in second.stdout
    assert "on a (2, 1) gloo group" in second.stdout


def test_batch_messages_matches_jax_and_shard_batch_places_the_tree():
    msgs = [Msg(_tokens(i, 3, 10)) for i in range(2)]
    for batch, seq_len in ((4, None), (8, 6), (6, 10)):
        np.testing.assert_array_equal(
            batch_messages(msgs, batch=batch, seq_len=seq_len),
            np.asarray(jax_batch_messages(msgs, batch=batch, seq_len=seq_len)))
    tree = shard_batch({"tokens": _tokens(0), "extra": [np.zeros(2), torch.ones(1)]}, CPU)
    assert isinstance(tree["tokens"], torch.Tensor) and tree["tokens"].dtype == torch.int32
    assert isinstance(tree["extra"], list) and tree["extra"][0].device == CPU


def test_device_prefetcher_places_items_in_order_and_reraises():
    items = list(DevicePrefetcher(iter([{"t": np.arange(3) + i} for i in range(5)]),
                                  device="cpu", depth=2))
    assert [int(x["t"][0]) for x in items] == list(range(5))
    assert all(isinstance(x["t"], torch.Tensor) for x in items)

    def broken():
        yield np.zeros(1)
        raise RuntimeError("source failed")

    it = DevicePrefetcher(broken(), device="cpu")
    assert isinstance(next(it), torch.Tensor)
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)
