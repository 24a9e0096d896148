"""The port's streaming training on a rank group of its own
(``LMTrainApp(mesh=...)``, ``launch/mesh.py`` ``RankGroup``): gloo ranks on
the CPU, one thread a rank, held to the JAX package's ``LMTrainApp`` on its
one CPU device fed the same token batches from the same state
(``train_state_from_jax``). Multi-device JAX does not run on this jax
(``tests/test_distributed.py::test_small_mesh_train_step_runs``); data
parallelism computes the same step.

Tolerances, ``tests/test_torch_train_stream.py``'s ``_close_step``: each
batch's loss to 1e-5 relative; each param's change from the common start
within 1e-3 of the JAX change's norm; the moments within 1e-3 of their
leaf's largest |value|; the step counts equal.

* a (2, 1) and a (4, 1) group app (one module-scoped app each);
* a stream through the broker and the micro-batch engine rescaled
  1 -> 4 -> 2 -> 1 ranks mid-stream, with no checkpoint file written,
  against the JAX app with no rescale;
* a checkpoint saved from the (2, 1) group, resumed onto the (4, 1) group,
  onto one device and into the JAX app, all going on alike;
* a killed rank, which the next command names within the group's timeout;
* two threads sending commands to one group at once (the stream's thread
  steps while another syncs or rescales), each answer reaching its command.
"""
import pickle
import sys
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch_mesh_cases as cases

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs.registry import get_arch as jax_get_arch
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.miniapps.masa import LMTrainApp as JaxTrainApp
from repro.runtime.optimizer import OptimizerConfig as JaxConfig
from repro.utils.tree import tree_flatten_with_paths as jax_paths
from repro_torch.broker import Producer
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core import PilotComputeService
from repro_torch.launch.mesh import MeshSpec, RankGroup, RankPool
from repro_torch.miniapps import LMTrainApp
from repro_torch.miniapps.masa import GroupState
from repro_torch.models import train_state_from_jax
from repro_torch.runtime.optimizer import OptimizerConfig
from repro_torch.utils import tree_bytes, tree_flatten_with_paths

torch.set_num_threads(1)

CPU = torch.device("cpu")
KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
ROWS, SEQ, N_BATCHES = 4, 32, 8


class Msg:
    def __init__(self, value):
        self.value = value


def _app(**kw):
    return LMTrainApp(get_arch("smollm-135m").reduced(), opt_cfg=OptimizerConfig(**KW),
                      seqs_per_step=ROWS, seq_len=SEQ, **kw)


def _jax_app():
    return JaxTrainApp(jax_get_arch("smollm-135m").reduced(),
                       mesh=jax_make_mesh((1, 1), ("data", "model")), opt_cfg=JaxConfig(**KW),
                       seqs_per_step=ROWS, seq_len=SEQ)


def _host(state):
    """A numpy copy of a JAX state (the app donates its buffers)."""
    return jax.tree.map(np.array, state)


def _run_jax(app, state, batches) -> tuple[list, list]:
    """(losses, host state after each batch) of ``batches`` through ``app``."""
    first, states = len(app.losses), []
    for tokens in batches:
        state = app.process(state, [Msg(tokens)])
        states.append(_host(state))
    return app.losses[first:], states


@pytest.fixture(scope="module")
def ref():
    """The JAX app's N_BATCHES batches from its seed-0 state: the losses and
    the host state after each batch."""
    rng = np.random.default_rng(0)
    tokens = [rng.integers(0, 512, (ROWS, SEQ)).astype(np.int32) for _ in range(N_BATCHES)]
    app = _jax_app()
    state = app.init_state(0)
    start = _host(state)
    losses, states = _run_jax(app, state, tokens)
    return SimpleNamespace(app=app, tokens=tokens, start=start, losses=losses, states=states)


@pytest.fixture(scope="module")
def groups():
    """A (2, 1) and a (4, 1) group app, kept up for the module."""
    apps = {n: _app(mesh=MeshSpec((n, 1), [CPU] * n)) for n in (2, 4)}
    yield apps
    for app in apps.values():
        app.close()


def _close(losses, jax_losses, full, jax_state, start):
    """``full`` (the port's full state) against ``jax_state`` (host), both
    trained from ``start`` (host), under ``_close_step``'s tolerances."""
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    before = dict(jax_paths(start["params"]))
    for (path, a), (_, b) in zip(tree_flatten_with_paths(full["params"]),
                                 jax_paths(jax_state["params"])):
        du, dj = a.numpy() - before[path], np.asarray(b) - before[path]
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), path
    assert int(full["opt"]["step"]) == int(jax_state["opt"]["step"])
    for (path, a), (_, b) in zip(tree_flatten_with_paths(full["opt"]), jax_paths(jax_state["opt"])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-3 * float(np.abs(b).max(initial=0)), err_msg=path)


def _train(app, state, batches):
    """(losses, state) of ``batches`` through ``app.process`` from ``state``."""
    first = len(app.losses)
    for tokens in batches:
        state = app.process(state, [Msg(tokens)])
    return app.losses[first:], state


@pytest.mark.parametrize("n", [2, 4])
def test_a_group_app_matches_the_jax_app(ref, groups, n):
    """Three batches on an (n, 1) group from the JAX app's state: each
    rank keeps its tiles, the stream carries a small handle on them."""
    app = groups[n]
    state = app.place_state(train_state_from_jax(ref.start, "cpu"))
    assert isinstance(state, GroupState) and state.step == 0
    losses, state = _train(app, state, ref.tokens[:3])
    assert isinstance(state, GroupState) and state.group is app.group and state.step == 3
    assert len(pickle.dumps(state)) < 200  # the handle, never the tensors
    assert app.group.size == n and app.mesh.backend == "gloo"
    _close(losses, ref.losses[:3], state.gather(), ref.states[2], ref.start)
    assert len(app.groups[-1]["step_s"]) >= 3


def test_a_stream_rescaled_1_4_2_1_matches_the_jax_app(ref, monkeypatch):
    """Token messages through the broker and the micro-batch engine into a
    group app built with a (1, 1) mesh, rescaled by ``stream.rescale`` onto
    4, then 2, then 1 rank of the CPU every two batches: each move gathers
    the state into host memory and hands it to the new group (whose ranks
    are the old group's processes where there are enough), writing no
    checkpoint; the eight losses and the final state as the JAX app's."""
    def no_file(*_):
        raise AssertionError("a rescale wrote a checkpoint file")

    monkeypatch.setattr(CheckpointManager, "_write", no_file)
    app = _app(mesh=MeshSpec((1, 1), [CPU]))
    svc = PilotComputeService(devices=[CPU])
    try:
        cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
        cluster.create_topic("tokens", 1)
        ctx = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"}).get_context()
        s = ctx.stream(cluster, "tokens", group="lm", process_fn=app.process,
                       state=train_state_from_jax(ref.start, "cpu"),
                       batch_interval=0.02, max_batch_records=1, backpressure=False)
        s.on_rescale = lambda devices: app.on_rescale(devices)(s.state)
        producer = Producer(cluster, "tokens", serializer="npy")
        s.start()
        for i, ranks in enumerate((4, 2, 1, None)):
            for tokens in ref.tokens[2 * i:2 * i + 2]:
                producer.send(tokens)
            s.await_batches(2 * i + 2, timeout=120)
            if ranks is not None:
                s.rescale([CPU] * ranks)
                assert isinstance(s.state, GroupState) and s.state.group.size == ranks
                assert s.state.step == 2 * i + 2
        s.stop()
        full = s.state.gather()
    finally:
        svc.cancel()
        app.close()
    assert [g["shape"] for g in app.groups] == [[1, 1], [4, 1], [2, 1], [1, 1]]
    assert [g["spawned"] for g in app.groups] == [1, 3, 0, 0]  # the processes go on
    assert [r["to"] for r in app.rescales] == [(4, 1), (2, 1), (1, 1)]
    assert all(r["bytes"] == tree_bytes(full) for r in app.rescales)
    _close(app.losses, ref.losses, full, ref.states[-1], ref.start)


def test_a_checkpoint_saved_from_one_group_resumes_on_another(ref, groups, tmp_path):
    """Two batches on the (2, 1) group, saved (the group's tiles gathered
    into full leaves, the JAX package's format); restored onto the (4, 1)
    group (each rank reading its tiles), onto one device and into the JAX
    app, each then takes the next two batches: all alike."""
    two, four = groups[2], groups[4]
    state = two.place_state(train_state_from_jax(ref.start, "cpu"))
    _, state = _train(two, state, ref.tokens[:2])
    two.sync()
    CheckpointManager(str(tmp_path)).save(2, state, meta={"offsets": {"0": 2}})

    saved, _ = JaxManager(str(tmp_path)).restore(jax.tree.map(jax.numpy.asarray, ref.states[1]))
    saved = _host(saved)
    jax_losses, jax_states = _run_jax(ref.app, jax.tree.map(jax.numpy.asarray, saved),
                                      ref.tokens[2:4])
    _close([], [], train_state_from_jax(saved, "cpu"), ref.states[1], ref.start)

    resumed, meta = four.restore(CheckpointManager(str(tmp_path)))
    assert meta == {"offsets": {"0": 2}} and resumed.step == 2
    losses, resumed = _train(four, resumed, ref.tokens[2:4])
    _close(losses, jax_losses, resumed.gather(), jax_states[-1], saved)

    one = _app(device="cpu")
    state, meta = one.restore(CheckpointManager(str(tmp_path)))
    assert meta == {"offsets": {"0": 2}} and one.group is None
    losses, state = _train(one, state, ref.tokens[2:4])
    _close(losses, jax_losses, state, jax_states[-1], saved)


def test_a_killed_rank_fails_the_next_command_naming_it():
    """Rank 1 of a (2, 1) group killed between batches: the next batch
    raises within the group's timeout, naming the rank and its exit code,
    and so does every later command; the app does not go on with one."""
    app = _app(mesh=MeshSpec((2, 1), [CPU, CPU]))
    tokens = np.zeros((ROWS, SEQ), np.int32)
    try:
        state = app.process(None, [Msg(tokens)])
        app.sync()
        victim = app.group.processes[1]
        victim.kill()
        victim.join(timeout=10)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match=r"rank 1 \(cpu\) died \(exit code -9\)"):
            app.process(state, [Msg(tokens)])
            app.sync()
        assert time.monotonic() - t0 < app.group.timeout
        with pytest.raises(RuntimeError, match=r"rank 1 \(cpu\) died"):
            app.group.call("launches")
    finally:
        app.close()
    assert app.group is None


def test_answers_reach_their_commands_from_two_threads():
    """Two threads submit 40 commands each to one (2, 1) group and wait on
    them, the interpreter switching threads every microsecond: every reply
    holds both ranks' answers to its own command."""
    pool = RankPool()
    group = RankGroup(MeshSpec((2, 1), [CPU, CPU]), cases.Echo, (), pool)
    wrong, interval = [], sys.getswitchinterval()

    def send(name):
        replies = [(i, group.submit("echo", (name, i))) for i in range(40)]
        for i, reply in replies:
            if reply.result() != [(0, (name, i)), (1, (name, i))]:
                wrong.append((name, i, reply.result()))

    threads = [threading.Thread(target=send, args=(n,)) for n in ("a", "b")]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        group.stop()
        pool.close()
    assert not any(t.is_alive() for t in threads)
    assert wrong == []
