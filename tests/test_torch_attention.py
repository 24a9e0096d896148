"""The port's attention plain versions and wrappers against the JAX package
(CPU): the Pallas flash and decode kernels in interpret mode and the JAX
plain paths, fed the same numpy inputs.

Tolerances are those of ``tests/test_kernels.py`` for the flash kernel:
2e-5 in f32 (the same f32 sums in another order) and 2e-2 in bf16 (inputs
of unit scale; one bf16 rounding of each output, 2^-8 relative, plus the
order of the f32 sums before it).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import flash_attention as jax_flash_attention
from repro.kernels.attention.decode_kernel import decode_attention_pallas
from repro.kernels.attention.ref import attention_ref as jax_attention_ref
from repro.models import attention as jattn
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.models import attention as tattn

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(seed, q_shape, kv_shape, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, th


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 32, 2, 1, 16), (2, 64, 4, 2, 32), (1, 48, 6, 3, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_kernel_and_ref(B, S, H, KV, hd, causal):
    (jq, jk, jv), (q, k, v) = _inputs(B * S + H, (B, S, H, hd), (B, S, KV, hd))
    out = attn_ref.flash_attention_plain(q, k, v, causal=causal, block_q=16, block_kv=16)
    ker = jax_flash_attention(jq, jk, jv, causal=causal, block_q=16, block_kv=16,
                              use_kernel=True, interpret=True)
    ref = jax_flash_attention(jq, jk, jv, causal=causal, use_kernel=False)
    np.testing.assert_allclose(_np(out), _np(ker), atol=2e-5)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5)
    # the (B, H, S, hd) oracle of the port agrees with the JAX oracle too
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    jt = [x.swapaxes(1, 2) for x in (jq, jk, jv)]
    np.testing.assert_allclose(_np(attn_ref.attention_ref(qt, kt, vt, causal=causal)),
                               _np(jax_attention_ref(*jt, causal=causal)), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2), (6, 2)])
def test_flash_plain_gqa_and_dtypes_match_pallas_kernel(dtype, H, KV):
    """G = H / KV in {1, 2, 3}."""
    (jq, jk, jv), (q, k, v) = _inputs(H + KV, (2, 32, H, 16), (2, 32, KV, 16), dtype)
    out = attn_ref.flash_attention_plain(q, k, v, block_q=16, block_kv=16)
    ker = jax_flash_attention(jq, jk, jv, block_q=16, block_kv=16, use_kernel=True,
                              interpret=True)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out), _np(ker), atol=_tol(dtype))


@pytest.mark.parametrize("Sq,Skv,causal", [(40, 40, True), (40, 56, True), (24, 56, False),
                                           (56, 24, True)])
def test_flash_plain_takes_ragged_lengths(Sq, Skv, causal):
    """Lengths that are no multiple of the blocks (the JAX blockwise form
    asserts divisibility; the oracle takes any length). Causal masks
    q_pos >= k_pos with both counted from 0, as the Pallas kernel does."""
    (jq, jk, jv), (q, k, v) = _inputs(Sq + Skv, (2, Sq, 4, 16), (2, Skv, 2, 16))
    out = attn_ref.flash_attention_plain(q, k, v, causal=causal, block_q=16, block_kv=16)
    ref = jax_attention_ref(*(x.swapaxes(1, 2) for x in (jq, jk, jv)), causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref.swapaxes(1, 2)), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2), (6, 2)])
def test_decode_plain_matches_pallas_kernel_and_jax_path(dtype, H, KV):
    """Ragged positions: 0, the last entry of a chunk, the first of the next,
    the last of the cache, and past the cache (every entry valid)."""
    B, S, hd = 5, 32, 16
    (jq, jk, jv), (q, k, v) = _inputs(H * 7 + KV, (B, 1, H, hd), (B, S, KV, hd), dtype)
    pos = np.array([0, 7, 8, 31, 40], np.int32)
    out = attn_ref.decode_attention_plain(q, k, v, torch.from_numpy(pos))
    ker = decode_attention_pallas(jq, jk, jv, jnp.asarray(pos), block_kv=8, interpret=True)
    plain = jattn.decode_attention(jq, jk, jv, positions=jnp.asarray(pos))
    tol = _tol(dtype)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, 1, H, hd)
    np.testing.assert_allclose(_np(out), _np(ker), atol=tol)
    np.testing.assert_allclose(_np(out), _np(plain), atol=tol)


def _flash_kernel_arithmetic(q, k, v, p_bits, tile=64):
    """The bf16 flash kernel's arithmetic in plain torch, causal: S in f32
    from the bf16 inputs, scaled in f32; an online softmax over 64-key
    tiles with P in f32 for the row sums; P V with P rounded as ``p_bits``
    says — "bf16" (one bf16 P) or "hilo" (P = bf16 hi + bf16 lo, the
    kernel's choice) — and V exact in f32 (bf16 products are exact)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, hd)
    kf, vf = k.float(), v.float()
    m = torch.full((B, KV, H // KV, S), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, H // KV, S, hd))
    rows = torch.arange(S)
    for k0 in range(0, S, tile):
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, k0:k0 + tile]) * (1.0 / math.sqrt(hd))
        keys = torch.arange(k0, k0 + s.shape[-1])
        s = torch.where(rows[:, None] >= keys[None, :], s, torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        parts = [hi] if p_bits == "bf16" else [hi, (p - hi).bfloat16().float()]
        acc = acc * alpha[..., None]
        for part in parts:
            acc = acc + torch.einsum("bkgqs,bskd->bkgqd", part, vf[:, k0:k0 + tile])
        m = m_new
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return out.bfloat16()


@pytest.mark.parametrize("B,S", [(1, 128), (4, 512)])
def test_flash_kernel_keeps_p_at_16_bits_to_meet_the_per_element_rule(B, S):
    """The serving path's head layout (9 query heads over 3 KV heads of
    64), unit-normal bf16 inputs from a numpy seed, against the plain
    version under the rule the card checks use: per element 2^-7 |ref| +
    2^-15 max|v|. A bf16 P fails it by more than 5x; the kernel's hi/lo
    split of P passes it."""
    rng = np.random.default_rng(B * S)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
               for shape in ((B, S, 9, 64), (B, S, 3, 64), (B, S, 3, 64)))
    ref = attn_ref.flash_attention_plain(q, k, v, causal=True).float()
    tol = 2.0 ** -7 * ref.abs() + 2.0 ** -15 * float(v.float().abs().max())
    worst = {bits: float(((_flash_kernel_arithmetic(q, k, v, bits).float() - ref).abs() / tol).max())
             for bits in ("bf16", "hilo")}
    assert worst["bf16"] > 5, worst
    assert worst["hilo"] <= 1, worst


def test_model_attention_routes_match_jax_on_cpu():
    """The model's entry points on CPU tensors: blockwise (the flash
    wrapper, so its plain version), naive and decode, against the same JAX
    functions; the plain blockwise form with blocks smaller than S too."""
    (jq, jk, jv), (q, k, v) = _inputs(3, (2, 64, 6, 16), (2, 64, 3, 16))
    assert tattn.blockwise_attention is attn_ops.flash_attention
    assert tattn.decode_attention is attn_ops.decode_attention
    np.testing.assert_allclose(_np(tattn.blockwise_attention(q, k, v)),
                               _np(jattn.blockwise_attention(jq, jk, jv)), atol=2e-5)
    np.testing.assert_allclose(
        _np(attn_ref.flash_attention_plain(q, k, v, block_q=16, block_kv=32)),
        _np(jattn.blockwise_attention(jq, jk, jv, block_q=16, block_kv=32)), atol=2e-5)
    np.testing.assert_allclose(_np(tattn.naive_attention(q, k, v)),
                               _np(jattn.naive_attention(jq, jk, jv)), atol=2e-5)
    pos = np.array([5, 63], np.int32)
    want = _np(jattn.decode_attention(jq[:, :1], jk, jv, positions=jnp.asarray(pos)))
    np.testing.assert_allclose(
        _np(tattn.decode_attention(q[:, :1], k, v, positions=torch.from_numpy(pos))), want,
        atol=2e-5)
    # int64 positions, as the paged steps make them
    np.testing.assert_allclose(
        _np(tattn.decode_attention(q[:, :1], k, v, positions=torch.from_numpy(pos).long())),
        want, atol=2e-5)


def test_update_cache_matches_jax_and_drops_out_of_range_rows():
    rng = np.random.default_rng(4)
    cache = rng.normal(size=(3, 8, 2, 4)).astype(np.float32)
    new = rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
    pos = np.array([0, 7, 9], np.int32)  # the last row is past the cache
    want = np.asarray(jattn.update_cache(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos)))
    got = torch.from_numpy(cache.copy())
    out = tattn.update_cache(got, torch.from_numpy(new), torch.from_numpy(pos))
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[2], cache[2])


def test_wrappers_refuse_mixed_devices_and_unknown_devices():
    q = torch.zeros(1, 4, 2, 16)
    kv = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="one device"):
        attn_ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="one device"):
        attn_ops.decode_attention(q[:, :1], torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16),
                                  torch.zeros(1, dtype=torch.int32, device="meta"))
    m = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no flash attention"):
        attn_ops.flash_attention(m, m, m)
