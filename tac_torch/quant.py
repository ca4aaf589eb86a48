"""Sign-magnitude midtread quantization + block floating point
(counterpart of tac/quant.py, SPEC.md §4).

Elementwise over whole line tensors; all bit manipulation is integer-exact.
Integer arithmetic runs in int64, where ``(1 << 31) - 1`` (the level count
of a 16-bit mantissa) is representable without the wrap that int32 relies
on, and results come back as int32. The float→code rounding uses the input
tensor's dtype: f64 in parity mode, f32 in fast mode.
"""

from __future__ import annotations

import torch


def _i64(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=like.device)


def _quantize(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """quantize_uniform with r already an int64 tensor; returns int64."""
    levels = (1 << r) - 1
    sign = (a < 0).to(torch.int64)
    code = torch.floor((levels.to(a.dtype) * torch.abs(a) + 1) * 0.5).to(torch.int64)
    code = torch.minimum(code, (1 << (r - 1)) - 1)
    return (sign << (r - 1)) | code


def quantize_uniform(a: torch.Tensor, r) -> torch.Tensor:
    """Midtread sign-magnitude quantizer (SPEC.md §4).

    a: float[...]; r: total bits incl. sign (int or int tensor
    broadcastable to a). code = min(floor(((2^r-1)|a| + 1)/2), 2^(r-1)-1),
    sign in bit r-1. Returns int32.
    """
    return _quantize(a, _i64(r, a)).to(torch.int32)


def scale_factor(a: torch.Tensor, n_scale_bits: int, n_mant_bits) -> torch.Tensor:
    """Capped leading-zero count of |a| quantized at R = 2^S - 1 + m bits.

    lz >= j  ⟺  code < 2^(Rm - j), so the count is a sum of comparisons.
    Returns int32 in [0, 2^S - 1].
    """
    max_scale = (1 << n_scale_bits) - 1
    r = max_scale + _i64(n_mant_bits, a)
    rm = r - 1
    code = _quantize(torch.abs(a), r)
    j = torch.arange(1, max_scale + 1, dtype=torch.int64, device=a.device)
    j = j.reshape((max_scale,) + (1,) * code.dim())
    thresh = 1 << torch.clamp(rm - j, min=0)
    return (code < thresh).sum(0).to(torch.int32)


def mantissa(a: torch.Tensor, scale, n_scale_bits: int, n_mant_bits) -> torch.Tensor:
    """Block-FP mantissa: sign bit + (m-1) magnitude bits after `scale`
    leading zeros. m may be 0 (returns 0)."""
    max_scale = (1 << n_scale_bits) - 1
    m = _i64(n_mant_bits, a)
    r = max_scale + m
    rm = r - 1
    q = _quantize(a, r)
    sign = (q >> rm) & 1
    mag = q & ((1 << rm) - 1)
    shift = rm - _i64(scale, a) - (m - 1)       # == max_scale - scale >= 0
    mant = (sign << torch.clamp(m - 1, min=0)) | (mag >> shift)
    return torch.where(m > 0, mant, 0).to(torch.int32)


def dequantize_mantissa(mant, scale, n_scale_bits: int, n_mant_bits,
                        dtype=torch.float32) -> torch.Tensor:
    """Inverse of `mantissa`, round-to-middle of the dropped field."""
    mant = mant.to(torch.int64)
    max_scale = (1 << n_scale_bits) - 1
    m = _i64(n_mant_bits, mant)
    r = max_scale + m
    rm = r - 1
    mbits = torch.clamp(m - 1, min=0)
    sign = (mant >> mbits) & 1
    gm = mant & ((1 << mbits) - 1)
    shift = rm - _i64(scale, mant) - (m - 1)
    g = gm << shift
    g = torch.where((gm != 0) & (shift > 0),
                    g + (1 << torch.clamp(shift - 1, min=0)), g)
    levels = ((1 << r) - 1).to(dtype)
    one = torch.ones((), dtype=dtype, device=mant.device)
    val = torch.where(sign == 1, -one, one) * 2.0 * g.to(dtype) / levels
    return torch.where(m > 0, val, torch.zeros((), dtype=dtype, device=mant.device))
