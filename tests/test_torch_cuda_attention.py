"""The port's attention kernels against their plain PyTorch versions on the
card, over the edge cases the smoke run's main-path shapes do not reach:
``pos`` = 0, at and across chunk edges and past the cache, one row over a
long cache, ragged Sq/Skv, GQA groups of 1, 3, 8 and 12 query heads, head
dims 32/64/128 and kimi-k2's 112, f32 and bf16, a side stream, the launch
counts and the error paths; the training forward's log-sum-exp and the
backward kernels (``flash_attention_bwd_dq`` / ``_dkdv``) against their
plain versions over the same cases, bitwise across repeats; and the serving path and a training loss's gradients on
the card against the same paths on the CPU.

Marked ``cuda``: a CUDA kernel has no CPU mode, so without a card every test
here skips (the ``dev`` fixture decides, at run time). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_attention.py

Tolerances: the kernels and the plain versions compute in f32 and differ
only in the order of their sums, so f32 outputs agree to 1e-5 of unit-scale
inputs; bf16 outputs are rounded once from f32 on both sides, so each
element agrees to one bf16 step of itself, 2^-7 |ref|, plus 2^-15 max|v|
for the order of the f32 sums (the rule ``chip_smoke.py`` uses). The
backward's dq, dk and dv are held to the same rule with the sum-order term
taken from the largest |gradient| (2^-15 max|ref|; f32 outputs take that
term alone): each is a sum over up to G x Sq (query, key) pairs in f32 on
both sides, from the same operands. The log-sum-exp is f32 on both sides:
1e-5 absolute.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.attention import ops as A
from repro_torch.kernels.attention import ref as R
from repro_torch.miniapps import LMServeApp
from repro_torch.models import build_model
from repro_torch.utils import tree_flatten_with_paths, tree_map_with_paths

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda", 0)


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _close(out, ref, v):
    if out.dtype == torch.float32:
        tol = torch.full_like(ref, 1e-5)
    else:
        tol = 2.0 ** -7 * ref.float().abs() + 2.0 ** -15 * float(v.float().abs().max())
    err = (out.float() - ref.float()).abs()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool((err <= tol).all()), (float(err.max()), float((err / tol).max()))


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (4, 256, 9, 3, 64), (1, 4096, 9, 3, 64), (3, 37, 8, 8, 64), (2, 100, 8, 1, 128),
    (5, 64, 24, 2, 128), (2, 33, 4, 2, 32),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(dev, B, S, H, KV, hd, dtype):
    """Positions S - 1 (the whole cache: 4096 entries for the one-row
    case), 0, a chunk edge and the entry after it, past S, cycled over the
    rows; G = 3, 1, 8, 12 and 2."""
    g = _gen(dev, B * S + H)
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    edges = [S - 1, 0, min(15, S - 1), min(16, S - 1), S + 5, min(31, S - 1), min(32, S - 1)]
    pos = torch.tensor([edges[i % len(edges)] for i in range(B)], dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    _close(out, R.decode_attention_plain(q, k, v, pos), v)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", [
    (4, 128, 128, 9, 3, 64, True), (1, 512, 512, 9, 3, 64, True), (2, 100, 100, 9, 3, 64, True),
    (2, 70, 130, 8, 1, 128, True), (1, 130, 70, 8, 8, 64, True), (3, 65, 33, 4, 2, 32, False),
    (1, 1, 1, 2, 1, 64, True), (2, 200, 300, 24, 2, 128, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dev, B, Sq, Skv, H, KV, hd, causal, dtype):
    g = _gen(dev, B * Sq + Skv + H)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=g, device=dev).to(dtype)
    out = A.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    # the plain version returns v's dtype, the kernel q's: the same here
    _close(out, R.flash_attention_plain(q, k, v, causal=causal, block_q=64, block_kv=64), v)


@pytest.mark.parametrize("Sq,Skv", [(1, 1), (17, 17), (63, 65), (65, 63), (200, 200),
                                     (1, 200), (200, 17)])
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_tensor_core_tiles_at_ragged_edges(dev, Sq, Skv, G, hd, causal):
    """The bf16 kernel packs the G query heads of a KV head as rows of one
    block and stages K/V in 64-key tiles: lengths off every tile edge (1,
    17, 63, 65, 200), groups of 1, 3 and 8 heads (packed tiles that end
    inside a position's group), every head dim, causal or not, each against
    the plain version under the per-element rule."""
    KV = 2
    g = _gen(dev, Sq * 1000 + Skv * 10 + G + hd)
    q = torch.randn((2, Sq, G * KV, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((2, Skv, KV, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((2, Skv, KV, hd), generator=g, device=dev).bfloat16()
    out = A.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(out, R.flash_attention_plain(q, k, v, causal=causal, block_q=64, block_kv=64), v)


def test_kernels_use_the_current_stream_and_count_launches(dev):
    g = _gen(dev, 9)
    q = torch.randn((2, 64, 9, 64), generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn((2, 64, 3, 64), generator=g, device=dev, dtype=torch.bfloat16)
    pos = torch.tensor([10, 63], dtype=torch.int32, device=dev)
    before = (A.FLASH_ATTENTION.launches, A.DECODE_ATTENTION.launches)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fo = A.flash_attention(q, k, k)
        do = A.decode_attention(fo[:, :1].contiguous(), k, k, pos)
    side.synchronize()
    assert (A.FLASH_ATTENTION.launches, A.DECODE_ATTENTION.launches) == (before[0] + 1, before[1] + 1)
    fr = R.flash_attention_plain(q, k, k)
    _close(fo, fr, k)
    _close(do, R.decode_attention_plain(fo[:, :1], k, k, pos), k)


def test_wrappers_take_views_and_int64_positions(dev):
    """The model hands the wrappers strided views (q, k, v split from one
    projection) and int64 positions; the wrappers make them contiguous and
    int32 before the launch."""
    g = _gen(dev, 11)
    qkv = torch.randn((2, 40, 15, 64), generator=g, device=dev, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :9], qkv[:, :, 9:12], qkv[:, :, 12:]
    assert not q.is_contiguous()
    _close(A.flash_attention(q, k, v), R.flash_attention_plain(q, k, v), v)
    pos = torch.tensor([0, 39], device=dev)
    _close(A.decode_attention(q[:, :1], k, v, pos), R.decode_attention_plain(q[:, :1], k, v, pos), v)


def test_kernels_reject_what_they_cannot_take(dev):
    q = torch.zeros((1, 4, 2, 64), device=dev)
    kv = torch.zeros((1, 4, 1, 64), device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="one device"):
        A.flash_attention(q, kv.cpu(), kv)
    with pytest.raises(ValueError, match="one device"):
        A.decode_attention(q[:, :1], kv, kv, pos.cpu())
    with pytest.raises(TypeError):
        A.flash_attention_cuda(q, kv.bfloat16(), kv)
    with pytest.raises(TypeError):
        A.decode_attention_cuda(q[:, :1].double(), kv.double(), kv.double(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention_cuda(q.transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        A.decode_attention_cuda(q[:, :1], torch.zeros((1, 8, 1, 64), device=dev)[:, ::2], kv, pos)
    with pytest.raises(ValueError, match="head dims"):
        A.flash_attention_cuda(torch.zeros((1, 4, 2, 48), device=dev),
                               torch.zeros((1, 4, 1, 48), device=dev),
                               torch.zeros((1, 4, 1, 48), device=dev))
    with pytest.raises(ValueError):
        A.decode_attention_cuda(q[:, :1], kv, kv, pos.long())
    with pytest.raises(ValueError):
        A.flash_attention_cuda(torch.zeros((1, 4, 3, 64), device=dev),  # H % KV != 0
                               torch.zeros((1, 4, 2, 64), device=dev),
                               torch.zeros((1, 4, 2, 64), device=dev))


def test_serving_on_the_card_matches_the_cpu(dev):
    """The reduced config (f32, hd 32) served on the card through both
    kernels emits the same greedy tokens as on the CPU through the plain
    versions, in both modes."""
    cfg = get_arch("smollm-135m").reduced()
    rng = np.random.default_rng(0)
    msgs = [type("Msg", (), {"value": rng.integers(1, 512, (2, 20)).astype(np.int32)})()
            for _ in range(2)]
    for mode in ("lockstep", "continuous"):
        on_cpu = LMServeApp(cfg, prompt_len=20, gen_tokens=6, batch=2, mode=mode,
                            n_pages=32, page_size=8, device="cpu")
        params = on_cpu.model.init(torch.Generator().manual_seed(1))
        on_card = LMServeApp(cfg, prompt_len=20, gen_tokens=6, batch=2, mode=mode,
                             n_pages=32, page_size=8, device=dev)
        before = (A.FLASH_ATTENTION.launches, A.DECODE_ATTENTION.launches)
        got = on_card.generate_tokens({k: (v.to(dev) if isinstance(v, torch.Tensor) else
                                           {kk: vv.to(dev) for kk, vv in v.items()})
                                       for k, v in params.items()}, msgs)
        assert A.FLASH_ATTENTION.launches > before[0] and A.DECODE_ATTENTION.launches > before[1]
        np.testing.assert_array_equal(got, on_cpu.generate_tokens(params, msgs))


def _decode_chunk(q, k):
    B, _, H, hd = q.shape
    code = {torch.float32: 0, torch.bfloat16: 1}[q.dtype]
    return A.decode_chunk(A.DECODE_LIB, q.device, B, k.shape[1], H, k.shape[2], hd, code)


@pytest.mark.parametrize("B", [1, 4, 64])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 12])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_at_chunk_edges(dev, B, G, hd, dtype):
    """The split kernel: positions at C - 1, C and C + 1 for the chunk C
    the launcher picks, 0, S - 1 and past S, cycled over the rows; B from 1
    (split) to 64 (no split at G <= 8), G = 1 to 12 (12: two blocks of 6
    query heads), every head dim, f32 and bf16."""
    S, KV = 256, 2
    g = _gen(dev, B * 100 + G * 10 + hd)
    q = torch.randn((B, 1, G * KV, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    C = _decode_chunk(q, k)
    edges = [min(p, S + 3) for p in (C - 1, C, C + 1, 0, S - 1, S, S + 3, 2 * C + 1)]
    pos = torch.tensor([edges[i % len(edges)] for i in range(B)], dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    _close(out, R.decode_attention_plain(q, k, v, pos), v)


@pytest.mark.parametrize("B", [1, 4, 64])
@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_on_a_cache_shard_writes_its_log_sum_exp(dev, B, G, hd, dtype):
    """A shard of a cache from global position ``start``: rows before it
    (0 and -inf), at its edges, inside and past it, split and not split;
    the output and LSE against the plain version; with start 0 and no LSE
    the output is the unsharded call's, bitwise."""
    S, KV, start = 256, 2, 300
    g = _gen(dev, 7000 + B * 100 + G * 10 + hd)
    q = torch.randn((B, 1, G * KV, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    edges = [0, start - 1, start, start + 1, start + 100, start + S - 1, start + S + 9]
    pos = torch.tensor([edges[i % len(edges)] for i in range(B)], dtype=torch.int32, device=dev)
    out, lse = A.decode_attention_lse(q, k, v, pos, start=start)
    ref, ref_lse = R.decode_attention_plain(q, k, v, pos, start=start, with_lse=True)
    torch.cuda.synchronize()
    empty = pos < start
    assert bool((out[empty] == 0).all()) and bool((lse[empty] == -math.inf).all())
    _close(out, ref, v)
    torch.testing.assert_close(lse[~empty], ref_lse[~empty], atol=1e-5, rtol=1e-5)
    plain0 = A.decode_attention(q, k, v, pos)
    with_lse0, _ = A.decode_attention_lse(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.equal(plain0, with_lse0)


@pytest.mark.parametrize("B,S", [(1, 256), (4, 256), (4, 1000), (64, 256)])
def test_decode_is_bitwise_repeatable_across_calls_and_graph_replays(dev, B, S):
    """Two calls, then a CUDA graph of one call replayed three times: all
    five outputs bitwise equal. The split kernel's partials are merged in
    chunk order by a second kernel, launched as its programmatic dependent,
    which the capture must keep."""
    g = _gen(dev, B + S)
    q = torch.randn((B, 1, 9, 64), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, 3, 64), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, 3, 64), generator=g, device=dev).bfloat16()
    pos = torch.randint(0, S + 8, (B,), generator=g, device=dev, dtype=torch.int32)
    first = A.decode_attention_cuda(q, k, v, pos)
    second = A.decode_attention_cuda(q, k, v, pos)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        A.decode_attention_cuda(q, k, v, pos)  # warm-up outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = A.decode_attention_cuda(q, k, v, pos)
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(captured.clone())
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for r in replays:
        assert torch.equal(first, r)
    _close(first, R.decode_attention_plain(q, k, v, pos), v)


def test_decode_entry_point_checks_the_chunk_it_is_given(dev):
    """The wrapper makes the split choice once (``decode_chunk``, per device)
    and passes it on; the C entry point refuses a chunk that is not a
    positive multiple of its round instead of indexing the workspace with
    a split count of its own."""
    B, S, H, KV, hd = 4, 256, 9, 3, 64
    q = torch.zeros((B, 1, H, hd), device=dev).bfloat16()
    kv = torch.zeros((B, S, KV, hd), device=dev).bfloat16()
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    chunk = _decode_chunk(q, kv)
    ws = torch.empty(B * H * S * (hd + 2), device=dev)  # room for any split
    stream = torch.cuda.current_stream(dev).cuda_stream
    for bad in (0, -chunk, chunk + 1):
        with pytest.raises(RuntimeError, match="decode_attention"):
            A.DECODE_ATTENTION.launch(q.data_ptr(), kv.data_ptr(), kv.data_ptr(), pos.data_ptr(),
                                      out.data_ptr(), None, ws.data_ptr(), B, S, H, KV, hd, 1,
                                      bad, 0, stream)


# -- training: the forward's log-sum-exp and the backward kernels ---------------


def _grad_close(name, out, ref):
    """The backward's per-element rule: one rounding step of the output's
    dtype (bf16 only) plus 2^-15 of the largest |ref| for the f32 sums."""
    rho = 2.0 ** -7 if out.dtype == torch.bfloat16 else 0.0
    tol = rho * ref.float().abs() + 2.0 ** -15 * float(ref.float().abs().max())
    err = (out.float() - ref.float()).abs()
    assert out.dtype == ref.dtype and out.shape == ref.shape, name
    assert bool(out.isfinite().all()), name
    assert bool((err <= tol).all()), (name, float(err.max()), float((err / tol).max()))


def _train_inputs(dev, B, Sq, Skv, H, KV, hd, dtype, seed):
    g = _gen(dev, seed)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=g, device=dev).to(dtype)
    dout = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    return q, k, v, dout


TRAIN_CASES = [
    (8, 128, 128, 9, 3, 64, True), (1, 300, 300, 9, 3, 64, True), (2, 70, 130, 8, 1, 128, True),
    (1, 130, 70, 8, 8, 64, True), (3, 65, 33, 4, 2, 32, False), (1, 1, 1, 2, 1, 64, True),
    (2, 200, 300, 24, 2, 128, False), (2, 17, 17, 6, 2, 32, True),
    # kimi-k2's head dim of 112 with G = 8, ragged Sq and Skv
    (1, 128, 128, 64, 8, 112, True), (2, 70, 130, 16, 2, 112, True),
    (1, 130, 70, 64, 8, 112, False),
    # the families' training layouts, lengths cut by 4: llava (576 + 128
    # positions), seamless's encoder, cross-attention and decoder, zamba2's
    # shared site (G = 1)
    (2, 176, 176, 32, 8, 128, True), (2, 64, 64, 16, 16, 64, False),
    (2, 32, 64, 16, 16, 64, False), (2, 32, 32, 16, 16, 64, True),
    (2, 32, 32, 32, 32, 64, True),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", TRAIN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_writes_the_plain_log_sum_exp(dev, B, Sq, Skv, H, KV, hd, causal, dtype):
    """The training forward: the same output as the serving forward, bitwise,
    and each row's log-sum-exp in (B, H, Sq) against the plain version."""
    q, k, v, _ = _train_inputs(dev, B, Sq, Skv, H, KV, hd, dtype, B * Sq + Skv + hd)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    out = A.flash_attention_cuda(q, k, v, causal=causal, lse=lse)
    plain_out, plain_lse = R.flash_attention_plain_lse(q, k, v, causal=causal, block_q=64,
                                                       block_kv=64)
    torch.cuda.synchronize()
    assert torch.equal(out, A.flash_attention_cuda(q, k, v, causal=causal))
    _close(out, plain_out, v)
    assert float((lse - plain_lse).abs().max()) <= 1e-5


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", TRAIN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_match_plain(dev, B, Sq, Skv, H, KV, hd, causal, dtype):
    """dq (kernel a) and dk, dv (kernel b) against ``flash_attention_bwd_plain``
    on the same q, k, v, forward output, log-sum-exp and dout: ragged Sq
    and Skv (past and short of 64-row tiles, Sq above and below Skv), G = 3,
    8, 1, 2 and 12, head dims 32, 64, 112 and 128, both causal flags."""
    q, k, v, dout = _train_inputs(dev, B, Sq, Skv, H, KV, hd, dtype, B * Sq + Skv + hd + 1)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    out = A.flash_attention_cuda(q, k, v, causal=causal, lse=lse)
    dq, dk, dv = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal)
    rq, rk, rv = R.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        _grad_close(name, got, ref)


OFFSET_CASES = [
    # (B, Sq, Skv, H, KV, hd, q_offset): sequence shards against the whole
    # sequence's keys (smollm's second of two, llava's four of 704), ragged
    # ones that start and end inside a 64-key tile, kimi-k2's head dim
    (8, 64, 128, 9, 3, 64, 64), (2, 176, 704, 32, 8, 128, 0), (2, 176, 704, 32, 8, 128, 528),
    (1, 37, 130, 4, 2, 32, 61), (2, 50, 100, 16, 2, 112, 50), (1, 1, 70, 8, 8, 64, 69),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,q_offset", OFFSET_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_a_query_offset(dev, B, Sq, Skv, H, KV, hd, q_offset, dtype):
    """Causal rows at positions ``q_offset``..: the forward (with its
    log-sum-exp) and the backward pair against the plain versions at the
    same offset, the pair bitwise on a second launch; and the plain
    forward one position off fails the rule."""
    q, k, v, dout = _train_inputs(dev, B, Sq, Skv, H, KV, hd, dtype, Sq + Skv + q_offset)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    out = A.flash_attention_cuda(q, k, v, causal=True, q_offset=q_offset, lse=lse)
    plain_out, plain_lse = R.flash_attention_plain_lse(q, k, v, causal=True, q_offset=q_offset)
    grads = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=True, q_offset=q_offset)
    again = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=True, q_offset=q_offset)
    ref = R.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True, q_offset=q_offset)
    torch.cuda.synchronize()
    _close(out, plain_out, v)
    assert float((lse - plain_lse).abs().max()) <= 1e-5
    for name, got, want, rep in zip(("dq", "dk", "dv"), grads, ref, again):
        _grad_close(name, got, want)
        assert torch.equal(got, rep), name
    # one position early (every row loses its last key), or late from 0
    off = q_offset - 1 if q_offset else 1
    wrong, _ = R.flash_attention_plain_lse(q, k, v, causal=True, q_offset=off)
    with pytest.raises(AssertionError):
        _close(out, wrong, v)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_on_the_card_counts_its_launches(dev, causal):
    """Through ``flash_attention`` with grad on: one forward (log-sum-exp
    written), then one launch of each backward kernel; the gradients equal
    the plain backward's, and with grad off the serving launch runs alone."""
    q, k, v, dout = _train_inputs(dev, 2, 96, 96, 9, 3, 64, torch.bfloat16, 5)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    before = (A.FLASH_ATTENTION.launches, A.FLASH_BWD_DQ.launches, A.FLASH_BWD_DKDV.launches)
    out = A.flash_attention(q, k, v, causal=causal)
    assert out.grad_fn is not None
    out.backward(dout)
    torch.cuda.synchronize()
    assert (A.FLASH_ATTENTION.launches, A.FLASH_BWD_DQ.launches, A.FLASH_BWD_DKDV.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    _, lse = R.flash_attention_plain_lse(q.detach(), k.detach(), v.detach(), causal=causal)
    rq, rk, rv = R.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(),
                                             lse, dout, causal=causal)
    for name, got, ref in (("dq", q.grad, rq), ("dk", k.grad, rk), ("dv", v.grad, rv)):
        _grad_close(name, got, ref)
    with torch.no_grad():
        assert A.flash_attention(q, k, v, causal=causal).grad_fn is None
    assert A.FLASH_BWD_DQ.launches == before[1] + 1


@pytest.mark.parametrize("B,S,H,KV,hd", [(8, 128, 9, 3, 64), (1, 512, 64, 8, 112),
                                        (1, 512, 32, 8, 128), (1, 2048, 9, 3, 64)])
def test_flash_backward_kernels_repeat_bitwise(dev, B, S, H, KV, hd):
    """No atomics and every sum in a fixed order: a second launch of the
    pair on the same inputs gives the same bits (bf16, causal), at the
    training layout and at the layouts of kimi-k2 and phi3.5-moe."""
    q, k, v, dout = _train_inputs(dev, B, S, S, H, KV, hd, torch.bfloat16, S + hd)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    out = A.flash_attention_cuda(q, k, v, causal=True, lse=lse)
    first = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    again = A.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


def test_backward_kernels_reject_what_they_cannot_take(dev):
    q = torch.zeros((1, 4, 2, 64), device=dev)
    kv = torch.zeros((1, 4, 1, 64), device=dev)
    lse = torch.zeros((1, 2, 4), device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_attention_bwd_cuda(q.cpu(), kv.cpu(), kv.cpu(), q.cpu(), lse.cpu(), q.cpu())
    with pytest.raises(TypeError):
        A.flash_attention_bwd_cuda(q, kv, kv, q, lse, q.bfloat16())
    with pytest.raises(ValueError, match="f32"):
        A.flash_attention_bwd_cuda(q, kv, kv, q, lse[:, :1], q)
    with pytest.raises(ValueError, match="f32"):
        A.flash_attention_bwd_cuda(q, kv, kv, q, lse.double(), q)
    with pytest.raises(ValueError, match="q's shape"):
        A.flash_attention_bwd_cuda(q, kv, kv, q[:, :2], lse, q)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention_bwd_cuda(q, kv, kv, q, lse, q.transpose(1, 2))
    q48, kv48 = torch.zeros((1, 4, 2, 48), device=dev), torch.zeros((1, 4, 1, 48), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        A.flash_attention_bwd_cuda(q48, kv48, kv48, q48, lse, q48)
    with pytest.raises(ValueError, match="f32"):
        A.flash_attention_cuda(q, kv, kv, lse=lse[..., :3])


@pytest.mark.parametrize("remat", ["none", "full"])
def test_training_gradients_on_the_card_match_the_cpu(dev, remat):
    """The graph-cut repair: ``DecoderLM.loss(...).backward()`` on CUDA
    tensors (the reduced config: f32, hd 32) reaches every leaf, ``wqkv``
    included, through the flash kernels, and every gradient is nonzero and
    equal to the CPU's (plain versions) within 1e-4 of its largest entry:
    two layers of f32 products in other orders on the two devices."""
    cfg = get_arch("smollm-135m").reduced(remat=remat)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (4, 48)).astype(np.int32))
    grads = {}
    for where in ("cpu", dev):
        p = tree_map_with_paths(lambda _, x: x.detach().to(where).requires_grad_(True), params)
        before = (A.FLASH_ATTENTION.launches, A.FLASH_BWD_DQ.launches, A.FLASH_BWD_DKDV.launches)
        loss, _ = model.loss(p, {"tokens": toks.to(where)})
        loss.backward()
        launched = (A.FLASH_ATTENTION.launches - before[0], A.FLASH_BWD_DQ.launches - before[1],
                    A.FLASH_BWD_DKDV.launches - before[2])
        grads[str(where)] = ({path: x.grad.cpu() for path, x in tree_flatten_with_paths(p)},
                             float(loss), launched)
    cpu, card = grads["cpu"], grads[str(dev)]
    n = cfg.n_layers
    assert cpu[2] == (0, 0, 0)
    assert card[2] == ((2 if remat == "full" else 1) * n, n, n)
    assert abs(cpu[1] - card[1]) <= 1e-5
    for path, g in cpu[0].items():
        got = card[0][path]
        scale = float(g.abs().max())
        assert scale > 0 and float(got.abs().max()) > 0, path
        assert float((got - g).abs().max()) <= 1e-4 * scale, path


# -- head dim 112 (kimi-k2: 64 query heads over 8 KV heads of 112) ---------------


@pytest.mark.parametrize("B,Sq,Skv,H,KV,causal", [
    (1, 128, 128, 64, 8, True), (2, 70, 130, 16, 2, True), (2, 65, 33, 8, 8, False),
    (1, 1, 1, 8, 1, True), (1, 200, 200, 24, 2, True), (3, 17, 63, 6, 2, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_at_head_dim_112(dev, B, Sq, Skv, H, KV, causal, dtype):
    """The instantiations at 112: bf16 on the tensor cores (seven k-steps of
    16, the last one alone), f32 with 32-key tiles; kimi's serving prefill
    (B=1 S=128, G=8), lengths off the tile edges, G = 8, 8, 1, 8, 12, 3."""
    g = _gen(dev, B * Sq + Skv + H + 112)
    q = torch.randn((B, Sq, H, 112), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Skv, KV, 112), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Skv, KV, 112), generator=g, device=dev).to(dtype)
    out = A.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(out, R.flash_attention_plain(q, k, v, causal=causal, block_q=64, block_kv=64), v)


@pytest.mark.parametrize("B,S,H,KV", [(1, 256, 64, 8), (4, 256, 64, 8), (64, 256, 64, 8),
                                      (3, 37, 8, 8), (2, 100, 8, 1), (5, 64, 24, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_at_chunk_edges_at_head_dim_112(dev, B, S, H, KV, dtype):
    """The decode kernel at 112: 16 lanes a key row with 2 idle (bf16), 32
    with 4 idle (f32); positions at the chunk the launcher picks (C - 1, C,
    C + 1), 0, S - 1 and past S, cycled over the rows."""
    g = _gen(dev, B * 100 + H + S)
    q = torch.randn((B, 1, H, 112), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, 112), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, 112), generator=g, device=dev).to(dtype)
    C = _decode_chunk(q, k)
    edges = [min(p, S + 3) for p in (C - 1, C, C + 1, 0, S - 1, S, S + 3, 2 * C + 1)]
    pos = torch.tensor([edges[i % len(edges)] for i in range(B)], dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    _close(out, R.decode_attention_plain(q, k, v, pos), v)
    assert torch.equal(out, A.decode_attention(q, k, v, pos))  # a fixed merge order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_at_head_dim_112(dev, dtype):
    """At 112 the backward kernels take what the forward takes: through
    ``flash_attention`` with grad on, one forward (log-sum-exp written) and
    one launch of each backward kernel, the gradients held to the plain
    backward per element (bf16 on the tensor cores: seven k-steps of 16
    and 14 n-tiles; f32 on the CUDA cores); a head dim no kernel takes (48)
    is refused before any forward launches."""
    q, k, v, dout = _train_inputs(dev, 2, 96, 80, 16, 2, 112, dtype, 112)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    before = (A.FLASH_ATTENTION.launches, A.FLASH_BWD_DQ.launches, A.FLASH_BWD_DKDV.launches)
    out = A.flash_attention(q, k, v, causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (A.FLASH_ATTENTION.launches, A.FLASH_BWD_DQ.launches, A.FLASH_BWD_DKDV.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    _, lse = R.flash_attention_plain_lse(q.detach(), k.detach(), v.detach(), causal=True)
    ref = R.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(), lse,
                                      dout, causal=True)
    for name, got, want in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad), ref):
        _grad_close(name, got, want)
    q48 = torch.zeros((1, 4, 2, 48), device=dev, dtype=dtype, requires_grad=True)
    kv48 = torch.zeros((1, 4, 1, 48), device=dev, dtype=dtype)
    with pytest.raises(ValueError, match="head dims"):
        A.flash_attention(q48, kv48, kv48)
    assert A.FLASH_ATTENTION.launches == before[0] + 1


def test_moe_serving_on_the_card_matches_the_cpu_at_head_dim_112(dev):
    """kimi-k2's reduced config at its head dim of 112 (f32, the router
    scaled to logits of order 1, so no top-2 choice is close) served on the
    card through both kernels emits the CPU's greedy tokens."""
    cfg = get_arch("kimi-k2-1t-a32b").reduced(head_dim=112)
    rng = np.random.default_rng(0)
    msgs = [type("Msg", (), {"value": rng.integers(1, 512, (2, 20)).astype(np.int32)})()
            for _ in range(2)]
    on_cpu = LMServeApp(cfg, prompt_len=20, gen_tokens=6, batch=2, mode="continuous",
                        n_pages=32, page_size=8, device="cpu")
    params = on_cpu.model.init(torch.Generator().manual_seed(1))
    params["layers"]["router"] *= 100
    on_card = LMServeApp(cfg, prompt_len=20, gen_tokens=6, batch=2, mode="continuous",
                         n_pages=32, page_size=8, device=dev)
    before = (A.FLASH_ATTENTION.launches, A.DECODE_ATTENTION.launches)
    got = on_card.generate_tokens(tree_map_with_paths(lambda _, x: x.to(dev), params), msgs)
    assert A.FLASH_ATTENTION.launches > before[0] and A.DECODE_ATTENTION.launches > before[1]
    np.testing.assert_array_equal(got, on_cpu.generate_tokens(params, msgs))


# -- the families phase's shapes (llava-next, seamless-m4t, zamba2) ------------

FAMILY_FLASH = [  # (B, Sq, Skv, H, KV, hd, causal)
    (4, 704, 704, 32, 8, 128, True),  # llava: 576 patches + 128 tokens, G = 4
    (4, 256, 256, 16, 16, 64, False),  # seamless encoder: non-causal, G = 1
    (4, 128, 256, 16, 16, 64, False),  # seamless cross-attention: Sq != Skv
    (4, 128, 128, 16, 16, 64, True),  # seamless decoder
    (4, 128, 128, 32, 32, 64, True),  # zamba's shared sites, G = 1
    (4, 192, 192, 32, 32, 64, True),  # zamba's re-score prefill
    (2, 143, 256, 16, 16, 64, False),  # a cross-attention off the tile edges
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", FAMILY_FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_at_the_families_shapes(dev, B, Sq, Skv, H, KV, hd, causal,
                                                           dtype):
    """Non-causal flash (the enc-dec encoder and cross-attention, Sq != Skv),
    G = 1 (seamless and zamba), llava's S = 704 with G = 4; the same check
    must fail the plain version with the causal flag flipped."""
    g = _gen(dev, B * Sq + Skv + H + hd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=g, device=dev).to(dtype)
    out = A.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(out, R.flash_attention_plain(q, k, v, causal=causal, block_q=64, block_kv=64), v)
    with pytest.raises(AssertionError):
        _close(out, R.flash_attention_plain(q, k, v, causal=not causal), v)


@pytest.mark.parametrize("B,S,H,KV,hd", [(4, 720, 32, 8, 128), (4, 144, 16, 16, 64),
                                         (4, 193, 32, 32, 64), (1, 720, 32, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_at_the_families_shapes(dev, B, S, H, KV, hd, dtype):
    """llava's decode over 720 entries (G = 4, hd 128), seamless's and
    zamba's (G = 1, hd 64), positions at the launcher's chunk edges, 0,
    S - 1 and past S; bitwise equal on a second call."""
    g = _gen(dev, B * S + H + hd)
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    C = _decode_chunk(q, k)
    edges = [min(p, S + 3) for p in (C - 1, C, C + 1, 0, S - 1, S, 2 * C + 1)]
    pos = torch.tensor([edges[i % len(edges)] for i in range(B)], dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    _close(out, R.decode_attention_plain(q, k, v, pos), v)
    assert torch.equal(out, A.decode_attention(q, k, v, pos))


@pytest.mark.parametrize("name", ["llava-next-mistral-7b", "seamless-m4t-medium", "rwkv6-3b",
                                  "zamba2-1.2b"])
def test_families_on_the_card_match_the_cpu(dev, name):
    """Each family's reduced config in f32 (llava at hd 128 over G = 4, the
    others as reduced), the same weights and stub inputs: a prefill and
    three decode steps on the card equal the CPU's logits to 1e-4 of their
    largest value, and the attention kernels launch (none for rwkv6)."""
    over = {"head_dim": 128, "n_heads": 8, "n_kv_heads": 2} if name.startswith("llava") else {}
    cfg = get_arch(name).reduced(**over)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(1, 512, (2, 64)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.normal(size=(2, 16, 128)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.from_numpy(rng.normal(size=(2, 40, 128)).astype(np.float32))
    steps = torch.from_numpy(rng.integers(1, 512, (3, 2, 1)).astype(np.int32))
    s = 64 + (16 if cfg.family == "vlm" else 0)

    def run(device):
        p = tree_map_with_paths(lambda _, x: x.to(device), params)
        logits, cache = model.prefill(p, {k: v.to(device) for k, v in batch.items()},
                                      cache_len=s + 3)
        outs = [logits]
        for i, tok in enumerate(steps):
            pos = torch.full((2,), s + i, dtype=torch.int32, device=device)
            logits, cache = model.decode(p, cache, {"tokens": tok.to(device), "positions": pos})
            outs.append(logits)
        return torch.stack(outs).cpu()

    before = (A.FLASH_ATTENTION.launches, A.DECODE_ATTENTION.launches)
    card = run(dev)
    launched = (A.FLASH_ATTENTION.launches - before[0], A.DECODE_ATTENTION.launches - before[1])
    cpu = run(torch.device("cpu"))
    assert float((card - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())
    if cfg.family == "ssm":
        assert launched == (0, 0)
    else:
        assert launched[0] > 0 and launched[1] > 0
