"""Rounding of operands to the precisions the controls compute in."""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even of f32 values to TF32 (10 mantissa bits), as
    the tensor cores read a TF32 product's operands; returned as f32."""
    x = x.to(torch.float32).contiguous()
    b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    out = (((b + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)
    out = out.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to float8 e4m3 and back to f32."""
    return x.to(torch.float32).to(torch.float8_e4m3fn).to(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


OPERAND = {"bf16": round_bf16, "fp8": round_fp8, "tf32": round_tf32}
