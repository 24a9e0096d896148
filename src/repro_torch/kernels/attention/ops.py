"""Prefill (flash) and decode attention, over the CUDA kernels.

:func:`flash_attention` and :func:`decode_attention` are the wrappers: CPU
tensors take the plain versions (:mod:`~repro_torch.kernels.attention.ref`),
CUDA tensors launch ``flash_attention`` (``kernels/csrc/flash_attention.cu``)
or ``decode_attention`` (``kernels/csrc/decode_attention.cu``) or raise.
There is no fallback between the two. Both keep the JAX package's layouts:
q (B, S, H, hd), k and v (B, S, KV, hd), H a multiple of KV.

Training: where grad mode is on and an input requires grad,
:func:`flash_attention` goes through :class:`FlashAttentionFn`, whose
forward also writes each row's log-sum-exp and whose backward launches
``flash_attention_bwd_dq`` and then ``flash_attention_bwd_dkdv``
(``kernels/csrc/flash_attention_bwd.cu``) on CUDA tensors, and runs
:func:`~repro_torch.kernels.attention.ref.flash_attention_bwd_plain` on CPU
tensors. Elsewhere the forward launches as for serving, with no
log-sum-exp written.

The kernels are ``torch.library`` ops (``repro_torch::flash_attention``,
``flash_attention_lse``, ``flash_attention_bwd``, ``decode_attention``,
``decode_attention_lse``), defined with ``torch.library.Library``
(``kernels/_library.py``, beside the Mini-App kernels' ops): the
dispatcher sends CUDA tensors to the kernel's launch and CPU tensors to
the plain version; a fake tensor (``FakeTensorMode``) takes the op's fake
implementation, which gives the outputs' shapes and dtypes only, and any
other device raises, a ``meta`` tensor outside fake mode included.
(``torch.library.custom_op`` is not used: its kernels import
``torch._dynamo`` on their first call, seconds.) Each op has a FLOP
formula (``torch.utils.flop_counter``): the kernel's own work, as
``PERF.md`` §6 counts its bound, 4 hd per live (query, key) pair and query
head forward and 10 hd for the backward pair, causal pairs counted from
``q_offset`` and decode pairs from the valid entries of the shard.
``FlopCounterMode`` counts the formula once and does not descend into the
plain version, so a step counts the same FLOPs whichever implementation
runs (``runtime/cost_analysis.py``).

Kernel notes (each source opens with the full note). All three are
instantiated for head dims 32, 64, 112 (kimi-k2) and 128 (``HEAD_DIMS``);
nothing is padded to another head dim, and any other head dim is refused
before a launch.

* ``flash_attention`` replaces ``repro/kernels/attention/kernel.py``
  (``flash_attention_pallas``). Bound by operations at prefill lengths of
  a few hundred tokens and more, by latency at the serving path's 128. In
  bf16 its products run on the tensor cores (``mma.sync`` m16n8k16, f32
  accumulate): the G query heads of a KV head are packed as the rows of
  one block, so they share every K/V tile, which comes into shared memory
  by ``cp.async``, double-buffered, and stays bf16; P is kept at about 16
  bits as bf16 hi + lo parts, since a bf16 P alone leaves the per-element
  tolerance against the f32-P reference. Causal blocks stop at their last
  row. The f32 instantiation stays on the CUDA cores (f32 products, no
  path runs it) to keep its 2e-5 agreement with the reference.
* ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkdv`` replace no TPU
  kernel (the Pallas kernel has no backward); they compute the JAX
  package's explicit flash backward (``runtime/sharded_attention.py``
  ``_flash_bwd``). Bound by operations (10 hd flop per pair) at training
  lengths. In bf16 on the tensor cores, as the forward: (a) packs the G
  query heads of a KV head as the rows of a block, keeps Q and dO in
  registers, writes each row's delta and walks the double-buffered K/V
  tiles up to the diagonal (dQ += dS K); (b) keeps a block's keys' K and
  V, and its warp groups walk the G heads' query tiles from the diagonal
  on (dV += P^T dO, dK += dS^T Q), merged in group order and written
  once. P and dS enter the products as bf16 hi + lo. No atomics: two
  launches give the same bits. f32 stays on the CUDA cores.
* ``decode_attention`` replaces ``repro/kernels/attention/decode_kernel.py``
  (``decode_attention_pallas``). Its bound is the bytes of the live cache
  entries, but at the serving path's sizes that bound is far below one
  launch, and latency sets the time: the chain of memory round trips and
  the launches. So when (row, KV head) pairs are fewer than the SMs, the
  cache is split into chunks of at least 64 keys, a block each
  (:func:`decode_chunk` chooses once per device and sizes; the wrapper
  sizes the workspace from it and passes it to the kernel); each block
  issues all its K and V loads (and the row's position) at once, and a
  second kernel, launched as the first one's programmatic dependent,
  merges the chunks' partials in chunk order (deterministic). With as many
  pairs as SMs (B=64) there is no split. Blocks past a row's position
  exit at once. A cache shard (``start``: the global position of its
  first entry) counts entry j valid where ``start + j <= pos``; a row with
  no valid entry gives 0, and, with the log-sum-exp asked for, -inf.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import CudaKernel, CudaLibrary
from repro_torch.kernels._library import define_op, fake_only
from repro_torch.kernels.attention.ref import (
    decode_attention_plain,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_plain_lse,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
FLASH_LIB = CudaLibrary("flash_attention.cu", {
    "flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
})
FLASH_ATTENTION = CudaKernel("flash_attention", FLASH_LIB, "flash_attention")
FLASH_BWD_LIB = CudaLibrary("flash_attention_bwd.cu", {
    "flash_attention_bwd_dq": [_P] * 8 + [_I] * 9 + [_P],
    "flash_attention_bwd_dkdv": [_P] * 8 + [_I] * 9 + [_P],
})
FLASH_BWD_DQ = CudaKernel("flash_attention_bwd_dq", FLASH_BWD_LIB, "flash_attention_bwd_dq")
FLASH_BWD_DKDV = CudaKernel("flash_attention_bwd_dkdv", FLASH_BWD_LIB, "flash_attention_bwd_dkdv")
DECODE_LIB = CudaLibrary("decode_attention.cu", {
    "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "decode_attention_chunk": [_I, _I, _I, _I, _I, _I, _I],
})
DECODE_ATTENTION = CudaKernel("decode_attention", DECODE_LIB, "decode_attention")

#: dtypes the kernels take -> their dtype code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims every attention kernel (forward, backward, decode) is
#: instantiated for: kimi-k2's 112 beside the powers of two
HEAD_DIMS = (32, 64, 112, 128)


def _one_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"attention inputs on {dev} and {t.device}: want one device")
    return dev


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels' common contract: one CUDA device, f32 or bf16 alike,
    contiguous and 16-byte aligned (the kernels load 16 bytes a lane)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODE or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{name} takes f32 or bf16 (all alike), got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} takes 16-byte aligned tensors")


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}: "
                         f"want (B, Sq, H, hd) and two (B, Skv, KV, hd)")
    B, _, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV or Skv < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not fit: "
                         f"same B and hd, H a multiple of KV, Skv >= 1")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} takes head dims {HEAD_DIMS}, got {hd}")


def _check_rows(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    """``t`` must be the (B, H, Sq) contiguous f32 tensor of q's rows."""
    B, Sq, H, _ = q.shape
    if t.shape != (B, H, Sq) or t.dtype != torch.float32 or t.device != q.device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous ({B}, {H}, {Sq}) f32 tensor on {q.device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_offset(q_offset: int) -> int:
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return q_offset


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, q_offset: int = 0,
                         lse: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``flash_attention``: q (B, Sq, H, hd), k and v (B, Skv, KV,
    hd) -> (B, Sq, H, hd) in q's dtype; causal query row i sits at position
    ``q_offset + i``. Given ``lse``, a (B, H, Sq) f32 tensor, the kernel
    also writes each row's log-sum-exp into it."""
    _check_cuda("flash_attention", q, k, v)
    _check_qkv("flash_attention", q, k, v)
    q_offset = _check_offset(q_offset)
    if lse is not None:
        _check_rows("flash_attention lse", lse, q)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_ATTENTION.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               lse.data_ptr() if lse is not None else None,
                               B, Sq, Skv, H, KV, hd, int(bool(causal)), q_offset,
                               _DTYPE_CODE[q.dtype], stream)
    return out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, q_offset: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``flash_attention_bwd_dq`` then ``flash_attention_bwd_dkdv``
    on the current stream: q, out, dout (B, Sq, H, hd), k, v (B, Skv, KV,
    hd), all one dtype, and the forward's lse (B, H, Sq) f32 -> (dq, dk, dv)
    in that dtype. (a) also writes each row's delta into a (B, H, Sq) f32
    workspace that (b) reads. Causal rows sit at ``q_offset + i``, as in
    the forward."""
    q_offset = _check_offset(q_offset)
    _check_cuda("flash_attention_bwd", q, k, v, out, dout)
    _check_qkv("flash_attention_bwd", q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape {tuple(q.shape)}")
    _check_rows("flash_attention_bwd lse", lse, q)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if Sq < 1:
        raise ValueError("flash_attention_bwd takes Sq >= 1")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sizes = (B, Sq, Skv, H, KV, hd, int(bool(causal)), q_offset, _DTYPE_CODE[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_BWD_DQ.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                            *sizes, stream)
        FLASH_BWD_DKDV.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                              lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                              *sizes, stream)
    return dq, dk, dv


@functools.lru_cache(maxsize=256)
def decode_chunk(library: CudaLibrary, device: torch.device, B: int, S: int, H: int, KV: int,
                 hd: int, code: int) -> int:
    """Keys per block the decode kernel of ``library`` takes at these sizes
    on ``device`` (its SM count sets the split): the cache is split into
    ceil(S / chunk) chunks per (row, head group), not at all when
    chunk >= S."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunk = library.load().decode_attention_chunk(B, S, H, KV, hd, code, sms)
    if chunk < 1:
        raise ValueError(f"decode_attention takes no B={B} S={S} H={H} KV={KV} hd={hd}")
    return chunk


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          positions: torch.Tensor, *, start: int = 0,
                          lse: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``decode_attention``: q (B, 1, H, hd), caches (B, S, KV, hd),
    positions (B,) int32 on the same device -> (B, 1, H, hd) in v's dtype.
    The cache is the shard of a longer one that starts at global position
    ``start`` >= 0: entry j is valid where ``start + j <= positions``; a row
    with none gives 0. Given ``lse``, a (B, H) f32 tensor, the kernel also
    writes each row's log-sum-exp of its scaled scores into it (-inf for a
    row with no valid entry)."""
    _check_cuda("decode_attention", q, k_cache, v_cache)
    if positions.device != q.device or positions.dtype != torch.int32 \
            or not positions.is_contiguous():
        raise ValueError(f"positions must be contiguous int32 on {q.device}, "
                         f"got {positions.dtype} on {positions.device}")
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}: want (B, 1, H, hd) and two (B, S, KV, hd)")
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != hd or H % KV or S < 1 \
            or positions.shape != (B,):
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)} and positions "
                         f"{tuple(positions.shape)} do not fit")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention takes head dims {HEAD_DIMS}, got {hd}")
    start = _check_offset(start)
    if lse is not None and (lse.shape != (B, H) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"decode_attention lse: want a contiguous ({B}, {H}) f32 tensor on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    out = torch.empty((B, 1, H, hd), dtype=v_cache.dtype, device=q.device)
    code = _DTYPE_CODE[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        chunk = decode_chunk(DECODE_ATTENTION.library, q.device, B, S, H, KV, hd, code)
        splits = -(-S // chunk)
        # partial (acc, m, l) of every (row, head, chunk); none without a split
        ws = torch.empty(B * H * splits * (hd + 2) if splits > 1 else 0, dtype=torch.float32,
                         device=q.device)
        DECODE_ATTENTION.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                positions.data_ptr(), out.data_ptr(),
                                lse.data_ptr() if lse is not None else None, ws.data_ptr(), B, S,
                                H, KV, hd, code, chunk, start, stream)
    return out


# ---------------------------------------------------------------------------
# the torch.library ops (``kernels/_library.py``): CUDA -> the kernel, CPU
# -> the plain version, fake tensors -> the shapes
# ---------------------------------------------------------------------------


def _flash_cuda(q, k, v, causal, q_offset):
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                                q_offset=q_offset)


def _flash_cpu(q, k, v, causal, q_offset):
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)


def _flash_fake(q, k, v, causal, q_offset):
    fake_only("flash attention", q, k, v)
    return q.new_empty(q.shape, dtype=v.dtype)


def _flash_lse_cuda(q, k, v, causal, q_offset):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, Sq, H, _ = q.shape
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset, lse=lse), lse


def _flash_lse_cpu(q, k, v, causal, q_offset):
    out, lse = flash_attention_plain_lse(q, k, v, causal=causal, q_offset=q_offset)
    return out, lse.to(torch.float32)


def _flash_lse_fake(q, k, v, causal, q_offset):
    fake_only("flash attention", q, k, v)
    B, Sq, H, _ = q.shape
    return q.new_empty(q.shape, dtype=v.dtype), q.new_empty((B, H, Sq), dtype=torch.float32)


def _flash_bwd_cuda(q, k, v, out, lse, dout, causal, q_offset):
    return flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(), causal=causal,
                                    q_offset=q_offset)


def _flash_bwd_cpu(q, k, v, out, lse, dout, causal, q_offset):
    return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal, q_offset=q_offset)


def _flash_bwd_fake(q, k, v, out, lse, dout, causal, q_offset):
    fake_only("flash attention backward", q, k, v, out, lse, dout)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _decode_cuda(q, k_cache, v_cache, positions, start):
    return decode_attention_cuda(q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
                                 positions.to(torch.int32).contiguous(), start=start)


def _decode_cpu(q, k_cache, v_cache, positions, start):
    return decode_attention_plain(q, k_cache, v_cache, positions, start=start)


def _decode_fake(q, k_cache, v_cache, positions, start):
    fake_only("decode attention", q, k_cache, v_cache, positions)
    return q.new_empty(q.shape, dtype=v_cache.dtype)


def _decode_lse_cuda(q, k_cache, v_cache, positions, start):
    B, _, H, _ = q.shape
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    out = decode_attention_cuda(q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
                                positions.to(torch.int32).contiguous(), start=start, lse=lse)
    return out, lse


def _decode_lse_cpu(q, k_cache, v_cache, positions, start):
    return decode_attention_plain(q, k_cache, v_cache, positions, start=start, with_lse=True)


def _decode_lse_fake(q, k_cache, v_cache, positions, start):
    fake_only("decode attention", q, k_cache, v_cache, positions)
    B, _, H, _ = q.shape
    return q.new_empty(q.shape, dtype=v_cache.dtype), q.new_empty((B, H), dtype=torch.float32)


#: prefill attention (B, Sq, H, hd) in v's dtype
flash_attention_op = define_op(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int q_offset) -> Tensor",
    _flash_cuda, _flash_cpu, _flash_fake)
#: (out (B, Sq, H, hd) in v's dtype, lse (B, H, Sq) f32)
flash_attention_lse_op = define_op(
    "flash_attention_lse(Tensor q, Tensor k, Tensor v, bool causal, int q_offset) -> "
    "(Tensor, Tensor)", _flash_lse_cuda, _flash_lse_cpu, _flash_lse_fake)
#: (dq, dk, dv) in the dtypes of q, k and v: the backward pair
flash_attention_bwd_op = define_op(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout, "
    "bool causal, int q_offset) -> (Tensor, Tensor, Tensor)", _flash_bwd_cuda, _flash_bwd_cpu,
    _flash_bwd_fake)
#: one-token attention over a cache shard, (B, 1, H, hd) in v's dtype
decode_attention_op = define_op(
    "decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, Tensor positions, int start) "
    "-> Tensor", _decode_cuda, _decode_cpu, _decode_fake)
#: (out (B, 1, H, hd) in v's dtype, lse (B, H) f32; -inf and 0 out where a
#: row has no valid entry in the shard)
decode_attention_lse_op = define_op(
    "decode_attention_lse(Tensor q, Tensor k_cache, Tensor v_cache, Tensor positions, "
    "int start) -> (Tensor, Tensor)", _decode_lse_cuda, _decode_lse_cpu, _decode_lse_fake)


# -- FLOP formulas: the kernels' own work (PERF.md §6's bounds) --------------


def causal_pairs(sq: int, skv: int, causal: bool, q_offset: int) -> int:
    """Live (query, key) pairs of one head: every pair, or, causal, row i
    (at position ``q_offset + i``) against keys 0..q_offset + i (at most skv)."""
    if not causal:
        return sq * skv
    first = q_offset + 1  # keys of row 0
    below = min(max(skv - first, 0), sq)  # rows short of all skv keys
    return below * first + below * (below - 1) // 2 + (sq - below) * skv


def decode_pairs(positions: torch.Tensor, s: int, start: int) -> int | None:
    """Valid (row, entry) pairs of a cache shard: min(max(pos - start + 1,
    0), s) a row. Fake positions are read from the cost trace's known
    values (``runtime/cost_analysis.py``); None where none is known."""
    from torch._subclasses.fake_tensor import is_fake, unset_fake_temporarily

    if is_fake(positions) or positions.device.type == "meta":
        from repro_torch.runtime.cost_analysis import known_value

        positions = known_value(positions)
        if positions is None:
            return None
    with unset_fake_temporarily():
        pos = positions.detach().to("cpu", torch.int64)
        return int(torch.clamp(pos - start + 1, min=0, max=s).sum())


def _attn_flops(q, k, causal, q_offset, per_pair: int) -> int:
    B, Sq, H, hd = q.shape
    return per_pair * hd * B * H * causal_pairs(Sq, k.shape[1], causal, q_offset)


def _decode_flops(q, k_cache, positions, start) -> int:
    B, _, H, hd = q.shape
    S = k_cache.shape[1]
    pairs = decode_pairs(positions, S, start)
    return 4 * hd * H * (B * S if pairs is None else pairs)  # unknown: every entry


@register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)
def _flash_flop(q, k, v, causal, q_offset, *args, out_val=None, **kwargs) -> int:
    return _attn_flops(q, k, causal, q_offset, 4)


@register_flop_formula(torch.ops.repro_torch.flash_attention_lse, get_raw=True)
def _flash_lse_flop(q, k, v, causal, q_offset, *args, out_val=None, **kwargs) -> int:
    return _attn_flops(q, k, causal, q_offset, 4)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd, get_raw=True)
def _flash_bwd_flop(q, k, v, out, lse, dout, causal, q_offset, *args, out_val=None,
                    **kwargs) -> int:
    return _attn_flops(q, k, causal, q_offset, 10)


@register_flop_formula([torch.ops.repro_torch.decode_attention,
                        torch.ops.repro_torch.decode_attention_lse], get_raw=True)
def _decode_flop(q, k_cache, v_cache, positions, start, *args, out_val=None, **kwargs) -> int:
    return _decode_flops(q, k_cache, positions, start)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the forward (``flash_attention_lse``)
    saves q, k, v, the output and each row's log-sum-exp; the backward is
    ``flash_attention_bwd``: the backward kernels on CUDA tensors,
    :func:`flash_attention_bwd_plain` on CPU tensors (any other device
    raises; nothing falls back from one to the other). The causal query
    offset goes with the saved tensors into the backward."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, q_offset: int = 0) -> torch.Tensor:
        _one_device(q, k, v)
        q_offset = _check_offset(q_offset)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_lse_op(q, k, v, bool(causal), q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = bool(causal), q_offset
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout: torch.Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_op(q, k, v, out, lse, dout, ctx.causal, ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Prefill attention, (B, Sq, H, hd) out: the model's
    ``blockwise_attention``. The plain version (in the JAX model's default
    512 x 1024 blocks) for CPU tensors; the CUDA kernel (its own tiles), on
    contiguous copies of the inputs, for CUDA tensors. Differentiable
    (:class:`FlashAttentionFn`) where grad mode is on and an input requires
    grad. Causal query row i sits at position ``q_offset + i`` (a sequence
    shard against the whole sequence's keys)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, q_offset)
    _one_device(q, k, v)
    return flash_attention_op(q, k, v, bool(causal), _check_offset(q_offset))


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward with each row's log-sum-exp, not differentiable: (out
    (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) f32). The plain version for
    CPU tensors, the kernel writing its LSE for CUDA tensors (the ring's
    partials, ``runtime/ring_attention.py``)."""
    _one_device(q, k, v)
    return flash_attention_lse_op(q, k, v, bool(causal), _check_offset(q_offset))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, *, start: int = 0) -> torch.Tensor:
    """One-token attention over a cache, (B, 1, H, hd) out: the model's
    ``decode_attention``. The plain version for CPU tensors; the CUDA
    kernel, on contiguous copies and int32 positions, for CUDA tensors.
    ``start``: the global position of the cache's first entry, where it is
    the shard of a longer cache (a row with no valid entry gives 0)."""
    _one_device(q, k_cache, v_cache, positions)
    return decode_attention_op(q, k_cache, v_cache, positions, _check_offset(start))


def decode_attention_lse(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         positions: torch.Tensor, *, start: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_attention` and each row's log-sum-exp, (B, H) f32:
    -inf where the shard holds no valid entry (the partial of a
    ``cache_seq``-sharded cache, ``runtime/sharded_attention.py``)."""
    _one_device(q, k_cache, v_cache, positions)
    return decode_attention_lse_op(q, k_cache, v_cache, positions, _check_offset(start))
