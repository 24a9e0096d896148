"""The port's sequence-parallel cores (``runtime/sequence_parallel.py``) on
a 2 x 2 ("data", "model") mesh of gloo ranks on the CPU, against the JAX
package's one-device chunked cores (``wkv6_chunked``, ``ssd_chunked``) and
its causal conv on the whole sequence, in this process: the outputs and
final states at the reference's tolerances (2e-4 for WKV6 and SSD, and
3e-4 for WKV6's gradients, ``tests/test_sequence_parallel.py``; 3e-4 for
the conv). One rank group runs every case once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_mesh_cases as cases

from repro.models.mamba2 import conv1d_causal, ssd_chunked
from repro.models.rwkv6 import wkv6_chunked
from repro_torch.launch.mesh import spawn_ranks

B, H, T, N = 2, 3, 64, 16  # WKV6 (the reference test's shapes)
BT, HS, P, NS = 2, 3, 8, 16  # SSD
K, CH = 4, 24  # conv width and channels


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
    return {
        "r": rng.standard_normal((B, H, T, N)).astype(f32),
        "k": rng.standard_normal((B, H, T, N)).astype(f32),
        "v": rng.standard_normal((B, H, T, N)).astype(f32),
        "w": sig(rng.standard_normal((B, H, T, N)) - 1.0).astype(f32),
        "u": (rng.standard_normal((H, N)) * 0.1).astype(f32),
        "x": rng.standard_normal((BT, T, HS, P)).astype(f32),
        "dt": np.log1p(np.exp(rng.standard_normal((BT, T, HS)))).astype(f32),
        "A": (-np.exp(rng.standard_normal(HS) * 0.5)).astype(f32),
        "Bm": rng.standard_normal((BT, T, 1, NS)).astype(f32),
        "Cm": rng.standard_normal((BT, T, 1, NS)).astype(f32),
        "D": (rng.standard_normal(HS) * 0.1).astype(f32),
        "xc": rng.standard_normal((BT, T, CH)).astype(f32),
        "wc": (rng.standard_normal((K, CH)) * 0.5).astype(f32),
        "bc": (rng.standard_normal(CH) * 0.1).astype(f32),
    }


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    inp = _inputs()
    return inp, spawn_ranks(cases.sequence_parallel_cases, 4, init_method=f"file://{d}/store",
                            args=(inp,), timeout=120)


def _assemble(tiles, seq_dim):
    """rank 2 d + m holds rows block d and sequence block m."""
    return np.concatenate([np.concatenate(tiles[2 * d:2 * d + 2], axis=seq_dim)
                           for d in range(2)], axis=0)


def _state(res, key):
    """The final state: alike on the two "model" ranks of a row block."""
    for d in range(2):
        np.testing.assert_array_equal(res[2 * d][key][1], res[2 * d + 1][key][1])
    return np.concatenate([res[0][key][1], res[2][key][1]])


def test_wkv6_sharded_matches_chunked(group):
    inp, res = group
    j = {n: jnp.asarray(inp[n]) for n in ("r", "k", "v", "w", "u")}
    o_ref, s_ref = wkv6_chunked(j["r"], j["k"], j["v"], j["w"], j["u"],
                                jnp.zeros((B, H, N, N)), chunk=8)
    np.testing.assert_allclose(_assemble([r["wkv"][0] for r in res], 2), np.asarray(o_ref),
                               atol=2e-4)
    np.testing.assert_allclose(_state(res, "wkv"), np.asarray(s_ref), atol=2e-4)


def test_wkv6_sharded_gradients_match_chunked(group):
    inp, res = group
    j = {n: jnp.asarray(inp[n]) for n in ("r", "k", "v", "w", "u")}

    def loss(r, k, v, w):
        o, _ = wkv6_chunked(r, k, v, w, j["u"], jnp.zeros((B, H, N, N)), chunk=8)
        return jnp.sum(jnp.sin(o))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(j["r"], j["k"], j["v"], j["w"])
    for i, g in enumerate(ref):
        np.testing.assert_allclose(_assemble([r["wkv_grads"][i] for r in res], 2), np.asarray(g),
                                   atol=3e-4)


def test_ssd_sharded_matches_chunked(group):
    inp, res = group
    j = {n: jnp.asarray(inp[n]) for n in ("x", "dt", "A", "Bm", "Cm", "D")}
    y_ref, s_ref = ssd_chunked(j["x"], j["dt"], j["A"], j["Bm"], j["Cm"], j["D"],
                               jnp.zeros((BT, HS, P, NS)), chunk=8)
    np.testing.assert_allclose(_assemble([r["ssd"][0] for r in res], 1), np.asarray(y_ref),
                               atol=2e-4)
    np.testing.assert_allclose(_state(res, "ssd"), np.asarray(s_ref), atol=2e-4)


def test_conv1d_sharded_matches_the_whole_sequence(group):
    inp, res = group
    x, w, b = (jnp.asarray(inp[n]) for n in ("xc", "wc", "bc"))
    ref, _ = conv1d_causal(x, w, b, None)
    np.testing.assert_allclose(_assemble([r["conv"][0] for r in res], 1), np.asarray(ref),
                               atol=3e-4)
    g = jax.grad(lambda x: jnp.sum(jnp.sin(conv1d_causal(x, w, b, None)[0])))(x)
    np.testing.assert_allclose(_assemble([r["conv"][1] for r in res], 1), np.asarray(g),
                               atol=3e-4)
