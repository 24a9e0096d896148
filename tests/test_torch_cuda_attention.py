"""The port's attention kernels against their plain PyTorch versions on the
card, over the edge cases the smoke run's main-path shapes do not reach:
``pos`` = 0, at and across chunk edges and past the cache, one row over a
long cache, ragged Sq/Skv, GQA groups of 1, 3, 8 and 12 query heads, head
dims 32/64/128, f32 and bf16, a side stream, the launch counts and the
error paths; and the serving path on the card against the same path on the
CPU.

Marked ``cuda``: a CUDA kernel has no CPU mode, so without a card every test
here skips (the ``dev`` fixture decides, at run time). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_attention.py

Tolerances: the kernels and the plain versions compute in f32 and differ
only in the order of their sums, so f32 outputs agree to 1e-5 of unit-scale
inputs; bf16 outputs are rounded once from f32 on both sides, so each
element agrees to one bf16 step of itself, 2^-7 |ref|, plus 2^-15 max|v|
for the order of the f32 sums (the rule ``chip_smoke.py`` uses).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.attention import ops as A
from repro_torch.kernels.attention import ref as R
from repro_torch.miniapps import LMServeApp

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
                                      out.data_ptr(), ws.data_ptr(), B, S, H, KV, hd, 1, bad,
                                      stream)
