"""Device-side MSB-first bit unpacking (counterpart of tac/ops/bitunpack.py).

Every field is ≤ 16 < 32 bits, so it spans at most two adjacent big-endian
words: a field at bit offset p with width w is
    v = ((hi << (p&31)) | (lo >> (32 - p&31))) >> (32 - w)
with hi = word p//32 and lo the word after it. On the card the two words
are plain gathers (tac's select-accumulate only avoided TPU gathers).
Words beyond the row read as 0, as in tac.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def read_fields(words: torch.Tensor, offsets: torch.Tensor,
                widths: torch.Tensor) -> torch.Tensor:
    """Read MSB-first fields from per-row word buffers.

    words:   int32 [K, W32] (32-bit patterns, big-endian bit order)
    offsets: int [K, NF] absolute bit offsets within the row
    widths:  int [K, NF] field widths (0 → 0)
    Returns int32 [K, NF]."""
    k, w32 = words.shape
    wz = torch.cat([words.to(torch.int64) & _MASK32,
                    torch.zeros((k, 1), dtype=torch.int64, device=words.device)],
                   dim=1)                          # column W32 reads as 0
    off = offsets.to(torch.int64)
    word0 = off >> 5
    r = off & 31
    hi = torch.gather(wz, 1, torch.clamp(word0, max=w32))
    lo = torch.gather(wz, 1, torch.clamp(word0 + 1, max=w32))
    merged = ((hi << r) & _MASK32) | torch.where(r > 0, lo >> (32 - r), 0)
    w = widths.to(torch.int64)
    return torch.where(w > 0, merged >> (32 - w), 0).to(torch.int32)
