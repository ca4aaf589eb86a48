"""Device-side MSB-first bit packing (counterpart of tac/ops/bitpack.py).

``pack_rows`` turns per-row (value, width) field matrices into each field's
contributions to its first word (c0) and to the next word (c1), then hands
the placement to kernel K2 (tac_torch/ops/pack.py). Stream bit p is bit
(31 - p%32) of word p//32: big-endian within a word. The host side turns
rows of words into the PAC-T block stream and back.
"""

from __future__ import annotations

import numpy as np
import torch

from tac_torch.bitstream import CorruptStreamError
from tac_torch.ops.pack import as_int32_bits, scatter_words_rows


def field_words(vals: torch.Tensor, wids: torch.Tensor):
    """Per-field word contributions of MSB-first packing.

    vals, wids: int [R, NF] field values (< 2^width, width ≤ 16) and widths
    (0 = absent). Returns (c0, c1, word0) int32 [R, NF] — each field's bits
    in its first word, its spill into the next word, and that first word's
    index (non-decreasing along a row) — and nbits int64 [R]."""
    v = vals.to(torch.int64)
    w = wids.to(torch.int64)
    end = torch.cumsum(w, dim=-1)                    # [R, NF] field ends
    start = end - w
    r = start & 31                                   # MSB-first offset
    n0 = torch.clamp(r + w, max=32) - r              # bits in word0
    n1 = w - n0                                      # spill into word0+1
    c0 = torch.where(w > 0, (v >> (w - n0)) << (32 - r - n0), 0)
    c1 = torch.where(n1 > 0, (v & ((1 << n1) - 1)) << (32 - n1), 0)
    return (as_int32_bits(c0), as_int32_bits(c1), (start >> 5).to(torch.int32),
            end[:, -1])


def pack_rows(vals: torch.Tensor, wids: torch.Tensor, cap_bits: int):
    """Pack fields MSB-first per row, on the device of `vals`.

    vals: int[..., NF] field values (< 2^width, width ≤ 16); wids:
    int[..., NF] field widths (0 = absent); cap_bits: per-row capacity.
    Returns (words int32[..., W32] holding 32-bit patterns, nbits
    int64[...]) where row r's stream is the big-endian byte view of
    words[r, :ceil(nbits/32)]."""
    w32 = -(-cap_bits // 32)
    lead, nf = vals.shape[:-1], vals.shape[-1]
    c0, c1, word0, nbits = field_words(vals.reshape(-1, nf),
                                       wids.reshape(-1, nf))
    words = scatter_words_rows(c0, c1, word0, w32=w32)
    return words.reshape(*lead, w32), nbits.reshape(lead)


def _check_capacity(words: np.ndarray, nbits: np.ndarray) -> None:
    """Fail loudly if any row's packed bits exceed its word capacity
    (K2 drops fields beyond it, which would corrupt the stream silently)."""
    cap = 32 * words.shape[-1]
    nb = np.asarray(nbits)
    if nb.size and int(nb.max()) > cap:
        raise ValueError(
            f"packed payload overflow: row needs {int(nb.max())} bits but "
            f"capacity is {cap} — field layout and capacity_bits drifted")


def rows_to_stream(words: np.ndarray, nbits: np.ndarray) -> bytes:
    """Host finalization into the PAC-T block stream: u16 length prefix per
    row + payload bytes, rows in storage order. words: uint32[..., W32]."""
    words = np.asarray(words)
    _check_capacity(words, nbits)
    k = int(np.prod(words.shape[:-1]))
    flat = words.reshape(k, words.shape[-1]).astype(">u4", order="C") \
        .view(np.uint8)
    nbytes = (-(-np.asarray(nbits).reshape(k) // 8)).astype(np.int64)
    out = np.empty(int(nbytes.sum()) + 2 * k, np.uint8)
    dst_end = np.cumsum(nbytes + 2)
    dst_start = dst_end - nbytes
    le = nbytes.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[dst_start - 2] = le[:, 0]
    out[dst_start - 1] = le[:, 1]
    fid = np.repeat(np.arange(k), nbytes)
    pos = np.arange(int(nbytes.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(nbytes) - nbytes, nbytes)
    out[dst_start[fid] + pos] = flat[fid, pos]
    return out.tobytes()


def stream_to_rows(data: bytes, offsets: np.ndarray, lens: np.ndarray,
                   w32: int) -> np.ndarray:
    """Gather each u16-prefixed payload into a zero-padded uint32 [K, W32]
    row buffer (big-endian bit order). Rejects payloads longer than the
    config-implied capacity with CorruptStreamError."""
    cap = 4 * w32
    if len(lens) and int(np.max(lens)) > cap:
        raise CorruptStreamError(
            f"block payload of {int(np.max(lens))} bytes exceeds the "
            f"{cap}-byte capacity implied by the stream header — "
            f"corrupt length prefix or header")
    buf = np.frombuffer(data, np.uint8)
    k = len(offsets)
    out = np.zeros((k, 4 * w32), np.uint8)
    lens = np.asarray(lens, np.int64)
    fid = np.repeat(np.arange(k), lens)
    pos = np.arange(int(lens.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(lens) - lens, lens)
    out[fid, pos] = buf[np.asarray(offsets, np.int64)[fid] + pos]
    return out.view(">u4").astype(np.uint32)
