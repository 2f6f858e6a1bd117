"""Integer helpers for the places where torch and the reference differ.

- H2: torch's `>>` on int32 is arithmetic; the reference shifts u32
  values (or calls `shift_right_logical`). `srl32` masks after the shift.
- H3: torch has no usable uint32 arithmetic, so u32 words ride in int64
  and are wrapped with `& U32` wherever the reference's u32 ops wrap.
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF


def srl32(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by a constant 0 < n < 32."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> the same u32 value carried in int64."""
    return x.to(torch.int64) & U32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 value carried in int64 -> int32 with the same bit pattern."""
    x = x & U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)
