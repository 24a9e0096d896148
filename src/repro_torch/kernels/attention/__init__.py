from repro_torch.kernels.attention.ops import (
    DECODE_ATTENTION,
    FLASH_ATTENTION,
    HEAD_DIMS,
    decode_attention,
    decode_attention_cuda,
    flash_attention,
    flash_attention_cuda,
)
from repro_torch.kernels.attention.ref import (
    attention_ref,
    decode_attention_plain,
    flash_attention_plain,
)

__all__ = [
    "DECODE_ATTENTION",
    "FLASH_ATTENTION",
    "HEAD_DIMS",
    "attention_ref",
    "decode_attention",
    "decode_attention_cuda",
    "decode_attention_plain",
    "flash_attention",
    "flash_attention_cuda",
    "flash_attention_plain",
]
