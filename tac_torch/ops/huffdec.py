"""Kernel K4: the canonical-Huffman mantissa decode walk over payload rows.

Replaces tac/ops/pallas_huffdec.py:huffman_decode_rows (_kernel). The
per-line codeword lengths chain the bit offsets, so a row's H lines decode
serially from ``mant_start`` (SPEC.md §8); rows are independent. Per line
with mantissa size m:
  * m ∈ [2, 8]: peek at ``pos``, find the codeword's length ln and symbol;
    ESCAPE (= 2^m) is followed by the m raw bits; pos += ln (+ m). A peek no
    codeword covers gives ln = 0 and symbol 0: the walk stalls in place.
  * otherwise the value is m raw bits and pos += m.
Reads take two adjacent big-endian words whose indices both clip to
[0, W32 − 1] (tac/codec.py:_read_bits_at), in the kernel and in the plain
version alike, so a walk that runs past its payload gives the same
(discarded) values in both.

The CUDA source is tac_torch/csrc/huffdec.cu (one thread per row, decoding
by canonical-code arithmetic); ``huffman_decode_rows_plain`` is the walk in
plain PyTorch through the packed peek LUT, the mirror of tac's
_huffman_decode_scan, and is what the wrapper runs for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from tac_torch import _build
from tac_torch.huffman import MAX_M, MIN_M, N_TAB, HuffConsts

_MASK32 = 0xFFFFFFFF


def read_bits_at(wz: torch.Tensor, pos: torch.Tensor, width) -> torch.Tensor:
    """Per-row bit read: wz int64 [K, W32] words (values in [0, 2^32)), pos
    int64 [K] bit offsets, width int or int64 [K] (0 → 0) → int64 [K]. Word
    indices past either end of the row clip to its first / last word."""
    w32 = wz.shape[1]
    word0 = pos >> 5
    r = pos & 31
    hi = torch.gather(wz, 1, torch.clamp(word0, 0, w32 - 1)[:, None])[:, 0]
    lo = torch.gather(wz, 1, torch.clamp(word0 + 1, 0, w32 - 1)[:, None])[:, 0]
    merged = ((hi << r) & _MASK32) | torch.where(r > 0, lo >> (32 - r), 0)
    w = torch.as_tensor(width, dtype=torch.int64, device=wz.device)
    return torch.where(w > 0, merged >> (32 - w), 0)


def huffman_decode_rows_plain(words: torch.Tensor, mant_start: torch.Tensor,
                              m_line: torch.Tensor, hc: HuffConsts
                              ) -> torch.Tensor:
    """Plain PyTorch K4: a loop over the H lines, all K rows per step.

    words int32 [K, W32] (32-bit patterns); mant_start int [K]; m_line int
    [K, H] with values in [0, 16]. Returns int32 [K, H]."""
    wz = words.to(torch.int64) & _MASK32
    pak_t = hc.dec_pak.to(torch.int64)
    pos = mant_start.to(torch.int64)
    out = torch.empty(m_line.shape, dtype=torch.int32, device=words.device)
    for j in range(m_line.shape[1]):
        m = m_line[:, j].to(torch.int64)
        codable = (m >= MIN_M) & (m <= MAX_M)
        tab = torch.clamp(m - MIN_M, 0, N_TAB - 1)
        pak = pak_t[tab, read_bits_at(wz, pos, hc.lmax)]
        sym = pak & 0xFFFF
        esc = codable & (sym == (1 << (tab + MIN_M)))
        code_bits = torch.where(codable, pak >> 16, 0)
        raw_bits = torch.where(codable, torch.where(esc, m, 0), m)
        rawv = read_bits_at(wz, pos + code_bits, raw_bits)
        out[:, j] = torch.where(codable & ~esc, sym, rawv)
        pos = pos + code_bits + raw_bits
    return out


def _lib():
    fn = _build.load("huffdec").tac_huffman_decode_rows
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def huffman_decode_rows(words: torch.Tensor, mant_start: torch.Tensor,
                        m_line: torch.Tensor, hc: HuffConsts) -> torch.Tensor:
    """K4: decode every row's mantissa run with one trained table set.

    words int32 [K, W32] payload rows (32-bit patterns); mant_start int32
    [K] absolute bit offset of each row's mantissa run; m_line int32 [K, H]
    mantissa size per line, in [0, 16]; hc: the set's tables on the same
    device. Returns int32 [K, H].

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count the launch in ``huffman_decode_rows.launches``) or raise."""
    if words.device.type == "cpu":
        return huffman_decode_rows_plain(words, mant_start, m_line, hc)
    if words.device.type != "cuda":
        raise ValueError(f"huffman_decode_rows: unsupported device {words.device}")
    for name, t in (("words", words), ("mant_start", mant_start),
                    ("m_line", m_line), ("canon", hc.canon), ("perm", hc.perm)):
        if (t.device != words.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(f"huffman_decode_rows: {name} must be a contiguous "
                             f"int32 tensor on {words.device}")
    if (words.dim() != 2 or m_line.dim() != 2 or words.shape[1] < 1
            or m_line.shape[0] != words.shape[0]
            or mant_start.shape != words.shape[:1]):
        raise ValueError("huffman_decode_rows: words must be [K, W32], "
                         "mant_start [K] and m_line [K, H]")
    k, w32 = words.shape
    h = m_line.shape[1]
    out = torch.empty((k, h), dtype=torch.int32, device=words.device)
    if k == 0 or h == 0:
        return out
    err = _lib()(words.data_ptr(), mant_start.data_ptr(), m_line.data_ptr(),
                 hc.canon.data_ptr(), hc.perm.data_ptr(), out.data_ptr(), k, h,
                 w32, hc.lmax, words.device.index or 0,
                 torch.cuda.current_stream(words.device).cuda_stream)
    if err:
        raise RuntimeError(f"huffdec kernel launch failed: CUDA error {err}")
    huffman_decode_rows.launches += 1
    return out


huffman_decode_rows.launches = 0
