"""The port's checkpoint manager against the JAX package's: the JAX
package's own cases (round trip, retention, a given step, async save,
invisible tmp dirs, a missing leaf), then checkpoints crossing between
the packages bitwise (f32, bf16 and int32 leaves, each way), the same
leaf paths for the same nesting, and the on-disk format."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.utils.tree import tree_flatten_with_paths as jax_paths
from repro_torch.checkpoint import CheckpointManager, atomic_dir
from repro_torch.utils import (
    tree_bytes,
    tree_count,
    tree_flatten_with_paths,
    tree_map_with_paths,
    tree_zeros_like,
)

torch.set_num_threads(1)


def _state():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b16": torch.ones((5,), dtype=torch.bfloat16) * 1.5},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as numpy (bf16 as uint16), for bitwise equality."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _leaves(tree):
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


# -- the JAX package's cases ---------------------------------------------------


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(3, state, meta={"offsets": {"0": 42}})
    restored, meta = mgr.restore(state)
    assert meta["offsets"] == {"0": 42}
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_keep_last_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in range(5):
        mgr.save(s, _state())
    assert mgr.steps() == [3, 4]


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=10)
    s = _state()
    for step in (1, 2):
        s2 = tree_map_with_paths(lambda _, x: x * step if x.dtype != torch.int32 else x, s)
        mgr.save(step, s2)
    r1, _ = mgr.restore(s, step=1)
    r2, _ = mgr.restore(s, step=2)
    torch.testing.assert_close(r2["params"]["w"], 2 * r1["params"]["w"], rtol=0, atol=0)


def test_async_save_waits_and_snapshots_at_save_time(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _state()
    mgr.save(1, state)
    state["params"]["w"].add_(100.0)  # a later in-place update is not saved
    mgr.wait()
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(_state())
    assert int(restored["opt"]["step"]) == 7
    assert float(restored["params"]["w"][0, 0]) == 0.0


def test_tmp_dirs_invisible(tmp_path):
    """A crash mid-write must not surface a partial checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    assert mgr.steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state())


def test_missing_leaf_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError):
        mgr.restore({"a": torch.zeros(3), "b": torch.zeros(2)})


def test_atomic_dir_leaves_nothing_on_a_failed_write(tmp_path):
    final = str(tmp_path / "spool")
    with pytest.raises(RuntimeError):
        with atomic_dir(final) as tmp:
            open(os.path.join(tmp, "x"), "w").close()
            raise RuntimeError("disk full")
    assert os.listdir(tmp_path) == []
    with atomic_dir(final) as tmp:
        open(os.path.join(tmp, "y"), "w").close()
    assert os.listdir(final) == ["y"]


# -- across the packages ---------------------------------------------------------


def _numpy_state(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "layers": [{"w": rng.normal(size=(4, 6)).astype(np.float32),
                    "scale": rng.normal(size=(6,)).astype(np.float32)}
                   for _ in range(2)],
        "emb": rng.normal(size=(8, 4)).astype(np.float32),
        "counts": rng.integers(-1000, 1000, size=(3, 2)).astype(np.int32),
        "step": np.array(11, np.int32),
    }


def _to_torch(tree, bf16: tuple = ("emb",)):
    def conv(path, x):
        t = torch.from_numpy(np.array(x))
        return t.to(torch.bfloat16) if path.split("/")[0] in bf16 else t
    return tree_map_with_paths(conv, tree)


def _to_jax(tree, bf16: tuple = ("emb",)):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(x, jnp.bfloat16 if path[0].key in bf16 else None), tree)


def test_paths_and_leaf_order_equal_the_jax_package():
    tree = {"z": [np.zeros(1), (np.ones(2), None)], "a": {"y": np.zeros(3), "b": np.ones(1)},
            "m": (np.zeros(2),)}
    ours = tree_flatten_with_paths(tree)
    theirs = jax_paths(tree)
    assert [p for p, _ in ours] == [p for p, _ in theirs] == [
        "a/b", "a/y", "m/0", "z/0", "z/1/0"]
    for (_, a), (_, b) in zip(ours, theirs):
        assert a is b


def test_a_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    src = _numpy_state(0)
    j_state = _to_jax(src)
    JaxManager(str(tmp_path)).save(5, j_state, meta={"offsets": {"0": 9}})
    restored, meta = CheckpointManager(str(tmp_path)).restore(
        tree_zeros_like(_to_torch(src)))
    assert meta == {"offsets": {"0": 9}}
    assert restored["emb"].dtype == torch.bfloat16 and restored["counts"].dtype == torch.int32
    for (p, a), (q, b) in zip(jax_paths(j_state), tree_flatten_with_paths(restored)):
        assert p == q
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_a_port_checkpoint_restores_in_the_jax_package_bitwise(tmp_path):
    src = _numpy_state(1)
    t_state = _to_torch(src)
    CheckpointManager(str(tmp_path)).save(7, t_state, meta={"note": "port"})
    restored, meta = JaxManager(str(tmp_path)).restore(_to_jax(src))
    assert meta == {"note": "port"}
    assert restored["emb"].dtype == jnp.bfloat16
    for (p, a), (q, b) in zip(tree_flatten_with_paths(t_state), jax_paths(restored)):
        assert p == q
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_the_on_disk_format_is_the_jax_package_s(tmp_path):
    """Manifests equal but for the time, arrays.npz entries byte-equal."""
    src = _numpy_state(2)
    JaxManager(str(tmp_path / "j")).save(3, _to_jax(src), meta={"k": 1})
    CheckpointManager(str(tmp_path / "t")).save(3, _to_torch(src), meta={"k": 1})
    man = {}
    for side in ("j", "t"):
        step = tmp_path / side / "step_0000000003"
        m = json.loads((step / "manifest.json").read_text())
        m.pop("time")
        with np.load(step / "arrays.npz") as data:
            man[side] = (m, {k: (data[k].dtype.str, data[k].tobytes()) for k in data.files})
    assert man["t"] == man["j"]
    dtypes = {leaf["path"]: leaf["dtype"] for leaf in man["t"][0]["leaves"]}
    assert dtypes["emb"] == "bfloat16" and dtypes["counts"] == "int32"
    assert dtypes["layers/0/w"] == "float32"


def test_restore_places_leaves_on_the_device_asked(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    meta_t = tree_map_with_paths(lambda _, x: torch.empty_like(x, device="meta"), _state())
    on_meta, _ = mgr.restore(meta_t)
    assert {x.device.type for x in _leaves(on_meta)} == {"meta"}
    on_cpu, _ = mgr.restore(meta_t, device="cpu")
    assert {x.device.type for x in _leaves(on_cpu)} == {"cpu"}
    np.testing.assert_array_equal(_bits(on_cpu["params"]["b16"]), _bits(_state()["params"]["b16"]))


def test_tree_sizes_match_the_jax_package():
    src = _numpy_state(3)
    from repro.utils.tree import tree_bytes as j_bytes, tree_count as j_count

    assert tree_count(_to_torch(src)) == j_count(_to_jax(src)) == 2 * 30 + 32 + 6 + 1
    assert tree_bytes(_to_torch(src)) == j_bytes(_to_jax(src))
