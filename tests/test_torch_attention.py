"""The port's attention plain versions and wrappers against the JAX package
(CPU): the Pallas flash and decode kernels in interpret mode and the JAX
plain paths, fed the same numpy inputs.

Tolerances are those of ``tests/test_kernels.py`` for the flash kernel:
2e-5 in f32 (the same f32 sums in another order) and 2e-2 in bf16 (inputs
of unit scale; one bf16 rounding of each output, 2^-8 relative, plus the
order of the f32 sums before it). The training backward is held to the
JAX package's explicit flash backward (``runtime/sharded_attention.py``,
differentiated with ``jax.vjp``) at 2e-5 in f32, the tolerance its own
test holds it to against ``naive_attention`` (``tests/test_kernels.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import flash_attention as jax_flash_attention
from repro.kernels.attention.decode_kernel import decode_attention_pallas
from repro.kernels.attention.ref import attention_ref as jax_attention_ref
from repro.models import attention as jattn
from repro.runtime.sharded_attention import flash_attention as jax_flash_vjp
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


# kimi-k2's attention: 64 query heads over 8 KV heads of 112 (G = 8); a
# head dim that is no multiple of 32, which the card's kernels take since
# they were instantiated for it. Here the plain versions at that width.
KIMI_HEADS = (64, 8, 112)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_kernel_at_head_dim_112(dtype, causal):
    H, KV, hd = KIMI_HEADS
    (jq, jk, jv), (q, k, v) = _inputs(112 + causal, (1, 32, H, hd), (1, 32, KV, hd), dtype)
    out = attn_ref.flash_attention_plain(q, k, v, causal=causal, block_q=16, block_kv=16)
    ker = jax_flash_attention(jq, jk, jv, causal=causal, block_q=16, block_kv=16,
                              use_kernel=True, interpret=True)
    assert out.dtype == getattr(torch, dtype) and out.shape == (1, 32, H, hd)
    np.testing.assert_allclose(_np(out), _np(ker), atol=_tol(dtype))
    np.testing.assert_allclose(_np(tattn.blockwise_attention(q, k, v, causal=causal)), _np(ker),
                               atol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_kernel_at_head_dim_112(dtype):
    """Positions 0, a chunk's last entry, the next chunk's first, the last
    entry and past the cache."""
    H, KV, hd = KIMI_HEADS
    B, S = 5, 32
    (jq, jk, jv), (q, k, v) = _inputs(1120, (B, 1, H, hd), (B, S, KV, hd), dtype)
    pos = np.array([0, 7, 8, 31, 40], np.int32)
    out = attn_ref.decode_attention_plain(q, k, v, torch.from_numpy(pos))
    ker = decode_attention_pallas(jq, jk, jv, jnp.asarray(pos), block_kv=8, interpret=True)
    plain = jattn.decode_attention(jq, jk, jv, positions=jnp.asarray(pos))
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, 1, H, hd)
    np.testing.assert_allclose(_np(out), _np(ker), atol=_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(plain), atol=_tol(dtype))


def test_one_head_dim_set_serves_every_kernel_and_48_is_refused(monkeypatch):
    """Forward, backward and decode kernels take one set of head dims,
    kimi-k2's 112 among them. A head dim no kernel takes (48) is refused by
    the wrappers' shared check before any launch (the device check is
    patched out so that CPU tensors reach it, the launches are recorded);
    the CPU's plain backward runs at 112 through autograd."""
    assert attn_ops.HEAD_DIMS == (32, 64, 112, 128)
    launched = []
    for kernel in (attn_ops.FLASH_ATTENTION, attn_ops.FLASH_BWD_DQ, attn_ops.FLASH_BWD_DKDV,
                   attn_ops.DECODE_ATTENTION):
        monkeypatch.setattr(kernel, "launch", lambda *a, n=kernel.name: launched.append(n))
    monkeypatch.setattr(attn_ops, "_check_cuda", lambda *tensors: None)
    q = torch.zeros(1, 8, 4, 48, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 2, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        attn_ops.flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="head dims"):
        attn_ops.flash_attention_bwd_cuda(q, kv, kv, q, torch.zeros(1, 4, 8), q)
    with pytest.raises(ValueError, match="head dims"):
        attn_ops.decode_attention_cuda(q[:, :1], kv, kv, torch.zeros(1, dtype=torch.int32))
    assert launched == []
    for hd in attn_ops.HEAD_DIMS:  # every kernel's head dim passes the shared check
        attn_ops._check_qkv("flash_attention", q.new_zeros(1, 8, 4, hd), kv.new_zeros(1, 8, 2, hd),
                            kv.new_zeros(1, 8, 2, hd))
    q = torch.randn(1, 8, 4, 112, dtype=torch.float64, requires_grad=True)
    k = torch.randn(1, 8, 2, 112, dtype=torch.float64, requires_grad=True)
    attn_ops.flash_attention(q, k, k).sum().backward()
    assert q.grad is not None and k.grad is not None


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


def _split_decode(q, k, v, pos, chunk):
    """The split decode kernel's arithmetic in plain torch: base-2 scores
    from q scaled by log2(e) / sqrt(hd) in f32; per chunk of ``chunk`` keys
    a partial (m, l, acc) over the row's live keys; the partials of the
    live chunks merged in chunk order by the log-sum-exp rule, as its merge
    kernel does; one rounding to v's dtype at the end."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, hd) * (math.log2(math.e) / math.sqrt(hd))
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    n = torch.where(pos >= S, torch.full_like(pos, S), pos + 1).long()
    live = torch.clamp((n + chunk - 1) // chunk, min=1)
    neg = torch.tensor(-1e30)
    m = torch.full((B, KV, H // KV), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, H // KV, hd))
    for c in range(-(-S // chunk)):
        keys = torch.arange(c * chunk, min((c + 1) * chunk, S))
        valid = (keys[None, :] < n[:, None])[:, None, None, :]  # (B, 1, 1, C)
        sc = torch.where(valid, s[..., keys], neg)
        m_c = sc.amax(-1)
        p = torch.where(valid, torch.exp2(sc - m_c[..., None]), torch.zeros(()))
        l_c = p.sum(-1)
        a_c = torch.einsum("bkgs,bskd->bkgd", p, v[:, keys].float())
        take = (c < live)[:, None, None]
        mn = torch.maximum(m, m_c)
        f_old, f_new = torch.exp2(m - mn), torch.exp2(m_c - mn)
        l = torch.where(take, l * f_old + l_c * f_new, l)
        acc = torch.where(take[..., None], acc * f_old[..., None] + a_c * f_new[..., None], acc)
        m = torch.where(take, mn, m)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(v.dtype)


@pytest.mark.parametrize("B,S", [(1, 128), (1, 256)])
def test_flash_kernel_arithmetic_meets_the_per_element_rule_at_head_dim_112(B, S):
    """kimi-k2's serving prefill layout (64 query heads over 8 KV heads of
    112, bf16) through the kernel's arithmetic (hi/lo P), against the plain
    version under the card checks' per-element rule; and the split decode's
    chunked merge at 112 under the same rule."""
    H, KV, hd = KIMI_HEADS
    rng = np.random.default_rng(S + 112)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    ref = attn_ref.flash_attention_plain(q, k, v, causal=True).float()
    tol = 2.0 ** -7 * ref.abs() + 2.0 ** -15 * float(v.float().abs().max())
    worst = float(((_flash_kernel_arithmetic(q, k, v, "hilo").float() - ref).abs() / tol).max())
    assert worst <= 1, worst
    pos = torch.tensor([S - 1], dtype=torch.int32)
    dref = attn_ref.decode_attention_plain(q[:, -1:], k, v, pos)
    dout = _split_decode(q[:, -1:], k, v, pos, 64)
    dtol = 2.0 ** -7 * dref.float().abs() + 2.0 ** -15 * float(v.float().abs().max())
    assert float(((dout.float() - dref.float()).abs() / dtol).max()) <= 1


@pytest.mark.parametrize("chunk", [16, 32, 64, 100, 256])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_split_decode_merge_matches_plain_under_the_per_element_rule(chunk, G):
    """The chunked, fixed-order merge of the split decode kernel against
    ``decode_attention_plain`` on bf16 inputs from a numpy seed, under the
    rule the card checks use (per element 2^-7 |ref| + 2^-15 max|v|), at
    ragged positions: 0, the chunk's edges (C - 1, C, C + 1), the last
    entry, past the cache, and scattered ones."""
    B, S, KV, hd = 10, 256, 3, 64
    rng = np.random.default_rng(chunk * 10 + G)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
               for shape in ((B, 1, G * KV, hd), (B, S, KV, hd), (B, S, KV, hd)))
    pos = torch.tensor([0, chunk - 1, chunk, chunk + 1, S - 1, S + 7, *rng.integers(0, S, 4)],
                       dtype=torch.int32).clamp(max=S + 7)
    ref = attn_ref.decode_attention_plain(q, k, v, pos)
    out = _split_decode(q, k, v, pos, chunk)
    tol = 2.0 ** -7 * ref.float().abs() + 2.0 ** -15 * float(v.float().abs().max())
    assert out.dtype == ref.dtype and out.shape == ref.shape
    worst = float(((out.float() - ref.float()).abs() / tol).max())
    assert worst <= 1, worst


# -- the training backward ------------------------------------------------------


def _flash_vjp_case(B, Sq, Skv, H, KV, hd, causal, seed, q_offset=0):
    """``flash_attention_plain_lse`` and ``flash_attention_bwd_plain`` against
    ``jax.vjp`` of the JAX package's custom-VJP flash attention (its
    ``_flash_fwd_core`` and ``_flash_bwd``, query row i at position
    ``q_offset + i``); then ``flash_attention`` with grad on
    (``FlashAttentionFn``) gives the same gradients through autograd."""
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, Sq, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, Skv, KV, hd)).astype(np.float32) for _ in range(2))
    q_pos = q_offset + jnp.arange(Sq, dtype=jnp.float32)

    def jax_fn(q, k, v):
        out = jax_flash_vjp(q.reshape(B, Sq, KV, H // KV, hd), k, v, q_pos, causal, 16, hd ** -0.5)
        return out.reshape(B, Sq, H, hd)

    jout, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = attn_ref.flash_attention_plain_lse(tq, tk, tv, causal=causal, q_offset=q_offset)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(jout), atol=2e-5)
    grads = attn_ref.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal=causal,
                                               q_offset=q_offset)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    y = attn_ops.flash_attention(*leaves, causal=causal, q_offset=q_offset)
    assert y.grad_fn is not None
    torch.testing.assert_close(y.detach(), out, rtol=0, atol=0)
    y.backward(tdo)
    for leaf, want in zip(leaves, grads):
        torch.testing.assert_close(leaf.grad, want, rtol=0, atol=0)


@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 64, 4, 2, 16), (2, 128, 9, 3, 32),
                                        (1, 64, 16, 2, 112)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_plain_matches_the_jax_flash_vjp(B, S, H, KV, hd, causal):
    """At the shapes of ``tests/test_kernels.py``'s gradient test, at S = 128
    with G = 3 and at kimi-k2's head dim of 112 with G = 8
    (``_flash_vjp_case``)."""
    _flash_vjp_case(B, S, S, H, KV, hd, causal, B * S + H + causal)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd", [(2, 128, 256, 4, 4, 16), (1, 128, 256, 8, 2, 32),
                                              (2, 128, 128, 4, 4, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_plain_matches_the_jax_flash_vjp_at_the_families_shapes(
        B, Sq, Skv, H, KV, hd, causal):
    """``_flash_vjp_case`` at the families' training layouts, scaled down:
    128 query rows over 256 keys (seamless's cross-attention) with G = 1 and
    G = 4, and G = 1 at Sq = Skv (seamless's MHA, zamba2's shared site)."""
    _flash_vjp_case(B, Sq, Skv, H, KV, hd, causal, B * Sq + Skv + H + causal)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,q_offset", [
    (2, 32, 64, 4, 2, 16, 32),     # the last of two sequence shards
    (2, 16, 64, 6, 3, 16, 16),     # an inner one of four
    (1, 64, 128, 9, 3, 64, 64),    # smollm's heads, the second of two shards
    (1, 48, 192, 8, 2, 112, 96),   # kimi-k2's head dim, the third of four
])
def test_flash_plain_with_a_query_offset_matches_the_jax_flash_vjp(B, Sq, Skv, H, KV, hd,
                                                                    q_offset):
    """A sequence shard's rows against the whole sequence's keys: the causal
    mask at ``q_offset + row`` (the JAX package's ``q_pos``), forward and
    gradients, f32, 2e-5 (``_flash_vjp_case``); and the forward against
    naive attention on the whole sequence, whose rows from ``q_offset`` on
    are the shard's."""
    _flash_vjp_case(B, Sq, Skv, H, KV, hd, True, B * Sq + q_offset + hd, q_offset=q_offset)
    rng = np.random.default_rng(q_offset)
    q = rng.normal(size=(B, Skv, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, Skv, KV, hd)).astype(np.float32) for _ in range(2))
    want = jattn.naive_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True)
    got = attn_ref.flash_attention_plain(torch.from_numpy(q[:, q_offset:q_offset + Sq]),
                                         torch.from_numpy(k), torch.from_numpy(v), causal=True,
                                         q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want)[:, q_offset:q_offset + Sq], atol=2e-5)


def test_a_negative_query_offset_is_refused():
    with pytest.raises(ValueError, match="q_offset"):
        attn_ops._check_offset(-1)


def _bf16_parts(x, lo: bool):
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if lo else (hi,)


def _flash_bwd_kernel_arithmetic(q, k, v, out, lse, dout, lo=("dq", "dk", "dv"), keys=32,
                                 groups=4, causal=True):
    """The bf16 backward kernels' arithmetic in plain torch, Sq and Skv
    multiples of 32 (Sq = Skv when causal): S and dP in f32 from the bf16
    operands, P = 2^(s log2(e) / sqrt(hd) - lse log2(e)), delta = rowsum(dO
    O) and dS = P (dP - delta) in f32; the P or dS entering each product as
    bf16 hi + lo where ``lo`` names the product's output (else hi alone),
    bf16 products exact in f32 and summed in f32 in the kernels' order: (a)
    dQ over 16-key chunks in key order; (b) per block of ``keys`` keys, its
    (head, 32-row query tile) items round-robin over ``groups`` warp groups,
    the tiles from the block's first key (causal) or from row 0, 16 rows a
    chunk, the groups' sums added in group order. dQ and dK scaled by 1 /
    sqrt(hd) at the end."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    c2 = math.log2(math.e)

    def heads(x):  # (B, Sq, H, hd) -> (B, KV, G, Sq, hd)
        return x.float().reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)

    qf, dof = heads(q), heads(dout)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (B, KV, Skv, hd)
    delta = (dof * heads(out)).sum(-1)
    l2 = lse.reshape(B, KV, G, Sq) * c2
    q_pos, k_pos = torch.arange(Sq), torch.arange(Skv)

    def p_ds(g, rows, ks):  # P and dS of heads g, query rows, keys (slices)
        s = torch.einsum("bkgqd,bksd->bkgqs", qf[:, :, g, rows], kf[:, :, ks])
        dp = torch.einsum("bkgqd,bksd->bkgqs", dof[:, :, g, rows], vf[:, :, ks])
        p = torch.exp2(s * (c2 / math.sqrt(hd)) - l2[:, :, g, rows, None])
        if causal:
            p = torch.where(q_pos[rows][:, None] >= k_pos[ks][None, :], p, torch.zeros(()))
        return p, p * (dp - delta[:, :, g, rows, None])

    every = slice(None)
    dq = torch.zeros_like(qf)
    for k0 in range(0, Skv, 16):
        ks = slice(k0, k0 + 16)
        for part in _bf16_parts(p_ds(every, every, ks)[1], "dq" in lo):
            dq = dq + torch.einsum("bkgqs,bksd->bkgqd", part, kf[:, :, ks])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, Skv, keys):
        r_begin = k0 if causal else 0
        ks, n_qt = slice(k0, k0 + keys), (Sq - r_begin + 31) // 32
        total_k = total_v = None
        for grp in range(groups):
            gk, gv = torch.zeros_like(kf[:, :, ks]), torch.zeros_like(vf[:, :, ks])
            for i in range(grp, G * n_qt, groups):
                g, r0 = slice(i // n_qt, i // n_qt + 1), r_begin + i % n_qt * 32
                for rows in (slice(r0, r0 + 16), slice(r0 + 16, r0 + 32)):
                    p, ds = p_ds(g, rows, ks)
                    for part in _bf16_parts(p, "dv" in lo):
                        gv = gv + torch.einsum("bkgqs,bkgqd->bksd", part, dof[:, :, g, rows])
                    for part in _bf16_parts(ds, "dk" in lo):
                        gk = gk + torch.einsum("bkgqs,bkgqd->bksd", part, qf[:, :, g, rows])
            total_k = gk if total_k is None else total_k + gk
            total_v = gv if total_v is None else total_v + gv
        dk[:, :, ks], dv[:, :, ks] = total_k, total_v
    scale = 1.0 / math.sqrt(hd)
    return ((dq * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).bfloat16(),
            (dk * scale).permute(0, 2, 1, 3).bfloat16(), dv.permute(0, 2, 1, 3).bfloat16())


def _kernel_arithmetic_case(B, Sq, Skv, H, KV, hd, causal, seed):
    """Unit-normal bf16 inputs from a numpy seed, through the backward
    kernels' arithmetic, against ``flash_attention_bwd_plain`` under the
    rule the card checks use: per element 2^-7 |ref| + 2^-15 max|ref| for
    each of dq, dk and dv. With P and dS as bf16 hi + lo in all three
    products it passes; dropping lo in any one product alone fails that
    product's output."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
                   for shape in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd),
                                 (B, Sq, H, hd)))
    out, lse = attn_ref.flash_attention_plain_lse(q, k, v, causal=causal)
    ref = attn_ref.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)

    def worst(got):
        return {name: float(((g.float() - r.float()).abs() / (
            2.0 ** -7 * r.float().abs() + 2.0 ** -15 * float(r.float().abs().max()))).max())
            for name, g, r in zip(("dq", "dk", "dv"), got, ref)}

    kept = worst(_flash_bwd_kernel_arithmetic(q, k, v, out, lse, do, causal=causal))
    assert max(kept.values()) <= 1, kept
    for product in ("dq", "dk", "dv"):
        lo = tuple(n for n in ("dq", "dk", "dv") if n != product)
        dropped = worst(_flash_bwd_kernel_arithmetic(q, k, v, out, lse, do, lo=lo, causal=causal))
        assert dropped[product] > 2, (product, dropped)


@pytest.mark.parametrize("B,S,H,KV,hd", [(8, 128, 9, 3, 64), (1, 128, 64, 8, 112),
                                        (1, 256, 64, 8, 112)])
def test_flash_backward_kernels_keep_p_and_ds_at_16_bits_to_meet_the_rule(B, S, H, KV, hd):
    """``_kernel_arithmetic_case`` at the training layout (9 query heads over
    3 KV heads of 64) and kimi-k2's (64 over 8 of 112), causal."""
    _kernel_arithmetic_case(B, S, S, H, KV, hd, True, B * S + hd)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", [(2, 128, 256, 16, 16, 64, False),
                                                     (2, 128, 128, 32, 32, 64, True)])
def test_flash_backward_kernels_keep_p_and_ds_at_16_bits_at_the_families_shapes(
        B, Sq, Skv, H, KV, hd, causal):
    """``_kernel_arithmetic_case`` at seamless's non-causal cross-attention
    (128 query rows over 256 keys, 16 heads over 16 KV heads of 64) and at
    zamba2's shared site (32 over 32 of 64, causal), batch cut to 2."""
    _kernel_arithmetic_case(B, Sq, Skv, H, KV, hd, causal, B * Sq + Skv + hd)


@pytest.mark.parametrize("Sq,Skv,causal", [(6, 6, True), (5, 7, True), (7, 5, False)])
def test_flash_attention_fn_passes_gradcheck_in_f64(Sq, Skv, causal):
    """``FlashAttentionFn`` on CPU tensors (plain forward with its
    log-sum-exp, plain backward) against finite differences in f64
    (``torch.autograd.gradcheck``), G = 2, ragged lengths."""
    rng = np.random.default_rng(Sq * 10 + Skv)
    q = torch.from_numpy(rng.normal(size=(1, Sq, 4, 8))).requires_grad_(True)
    k, v = (torch.from_numpy(rng.normal(size=(1, Skv, 2, 8))).requires_grad_(True)
            for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: attn_ops.FlashAttentionFn.apply(q, k, v, causal), (q, k, v))


def test_flash_attention_without_grad_takes_the_serving_route(monkeypatch):
    """With grad off (or no input requiring grad) the wrapper runs the
    plain forward as before, no log-sum-exp and no graph."""
    q, k, v = (torch.zeros(1, 4, 2, 16) for _ in range(3))
    monkeypatch.setattr(attn_ops, "flash_attention_plain_lse", lambda *a, **kw: 1 / 0)
    assert attn_ops.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert attn_ops.flash_attention(q.requires_grad_(True), k, v).grad_fn is None
    with pytest.raises(ZeroDivisionError):
        attn_ops.flash_attention(q, k, v)
