"""Prefill (flash) and decode attention, over the CUDA kernels.

:func:`flash_attention` and :func:`decode_attention` are the wrappers: CPU
tensors take the plain versions (:mod:`~repro_torch.kernels.attention.ref`),
CUDA tensors launch ``flash_attention`` (``kernels/csrc/flash_attention.cu``)
or ``decode_attention`` (``kernels/csrc/decode_attention.cu``) or raise.
There is no fallback between the two. Both keep the JAX package's layouts:
q (B, S, H, hd), k and v (B, S, KV, hd), H a multiple of KV.

Kernel notes (each source opens with the full note):

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
* ``decode_attention`` replaces ``repro/kernels/attention/decode_kernel.py``
  (``decode_attention_pallas``). Bound by the bytes of the live cache
  entries (launch-bound at the serving path's sizes); one block per
  (row, KV head) walks the cache only up to the row's position with
  16-byte loads.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, CudaLibrary
from repro_torch.kernels.attention.ref import decode_attention_plain, flash_attention_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
FLASH_LIB = CudaLibrary("flash_attention.cu", {
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
})
FLASH_ATTENTION = CudaKernel("flash_attention", FLASH_LIB, "flash_attention")
DECODE_LIB = CudaLibrary("decode_attention.cu", {
    "decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
})
DECODE_ATTENTION = CudaKernel("decode_attention", DECODE_LIB, "decode_attention")

#: dtypes the kernels take -> their dtype code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """Launch ``flash_attention``: q (B, Sq, H, hd), k and v (B, Skv, KV,
    hd) -> (B, Sq, H, hd) in q's dtype."""
    _check_cuda("flash_attention", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}: "
                         f"want (B, Sq, H, hd) and two (B, Skv, KV, hd)")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV or Skv < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not fit: "
                         f"same B and hd, H a multiple of KV, Skv >= 1")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, got {hd}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_ATTENTION.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               B, Sq, Skv, H, KV, hd, int(bool(causal)),
                               _DTYPE_CODE[q.dtype], stream)
    return out


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          positions: torch.Tensor) -> torch.Tensor:
    """Launch ``decode_attention``: q (B, 1, H, hd), caches (B, S, KV, hd),
    positions (B,) int32 >= 0 on the same device -> (B, 1, H, hd) in v's
    dtype."""
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
    out = torch.empty((B, 1, H, hd), dtype=v_cache.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        DECODE_ATTENTION.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                positions.data_ptr(), out.data_ptr(), B, S, H, KV, hd,
                                _DTYPE_CODE[q.dtype], stream)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Prefill attention, (B, Sq, H, hd) out: the model's
    ``blockwise_attention``. The plain version (in the JAX model's default
    512 x 1024 blocks) for CPU tensors; the CUDA kernel (its own tiles), on
    contiguous copies of the inputs, for CUDA tensors."""
    dev = _one_device(q, k, v)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if dev.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    raise ValueError(f"no flash attention for device {dev}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """One-token attention over a cache, (B, 1, H, hd) out: the model's
    ``decode_attention``. The plain version for CPU tensors; the CUDA
    kernel, on contiguous copies and int32 positions, for CUDA tensors."""
    dev = _one_device(q, k_cache, v_cache, positions)
    if dev.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, positions)
    if dev.type == "cuda":
        return decode_attention_cuda(q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
                                     positions.to(torch.int32).contiguous())
    raise ValueError(f"no decode attention for device {dev}")
