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
(discarded) values in both. The plain version reads each line's bits once:
a codeword (at most 16 bits) and the raw bits after it (at most 16) lie in
the 32 bits from ``pos`` on, inside the two words at ``pos``.

A decode holds rows of every tableId: ``huffman_decode_sets`` walks each
row with its own set (tid s ∈ [1, len(huff)]) and leaves the others'
raw mantissas, in one launch of the CUDA kernel tac_torch/csrc/huffdec.cu
(one thread per row, every set's compact peek LUT in shared memory).
``huffman_decode_rows_plain`` is the walk of one set in plain PyTorch
through the packed peek LUT, the mirror of tac's _huffman_decode_scan;
``huffman_decode_sets_plain`` is the same walk with each row under its own
set, as the kernel runs it, and is what the wrapper runs for tensors on
the CPU. Both entries consume
``mant_raw``: they write the Huffman rows into it and return it.
"""

from __future__ import annotations

import ctypes

import torch

from tac_torch import _build
from tac_torch.huffman import MAX_M, MIN_M, N_TAB, HuffConsts

_MASK32 = 0xFFFFFFFF


def _word_pairs(words: torch.Tensor) -> torch.Tensor:
    """int32 [K, W32] → int64 [K, W32 + 1]: entry i holds the 64-bit pair of
    words (i − 1, i) of the row, indices clipped to [0, W32 − 1], so that a
    read at bit offset pos finds its two words at i = pos // 32 + 1, clipped
    to [0, W32]."""
    wz = words.to(torch.int64) & _MASK32
    wz = torch.cat([wz[:, :1], wz, wz[:, -1:]], dim=1)
    return (wz[:, :-1] << 32) | wz[:, 1:]


# (1 << w) - 1 for each field width w in [0, 32]
_LOW_BITS = [(1 << w) - 1 for w in range(33)]


def _flat_luts(huff: tuple):
    """The sets' packed peek LUTs (length << 16 | symbol), flattened into
    one int64 [E] with 2^lmax zero entries at its end (no codeword: length
    0, symbol 0) → (the LUTs, int64 [S] where each set starts, where the
    zero entries start)."""
    paks = [hc.dec_pak.to(torch.int64).reshape(-1) for hc in huff]
    dev = paks[0].device
    top = max(hc.lmax for hc in huff)
    starts = torch.tensor([0] + [p.shape[0] for p in paks], device=dev).cumsum(0)
    pak = torch.cat(paks + [torch.zeros(1 << top, dtype=torch.int64, device=dev)])
    return pak, starts[:-1], starts[-1]


def _walk(words, mant_start, m_line, luts, sid, lmax) -> torch.Tensor:
    """tac's _huffman_decode_scan, all K rows per step over the lines that
    some row codes: luts from ``_flat_luts``, sid int64 [K] the set of each
    row (an index into the LUTs), lmax int64 [K] its peek width. Returns
    int32 [K, H]."""
    pak, starts, zero = luts
    out = torch.zeros(m_line.shape, dtype=torch.int32, device=words.device)
    # a line of m = 0 reads no bit and gives 0: only the lines some row
    # codes are walked
    cols = torch.nonzero(m_line.ne(0).any(0)).flatten()
    if cols.numel() == 0:
        return out
    pairs = _word_pairs(words)
    top = pairs.shape[1] - 1
    row0 = torch.arange(pairs.shape[0], device=words.device) * pairs.shape[1]
    pairs = pairs.reshape(-1)
    m = m_line[:, cols].to(torch.int64)
    codable = (m >= MIN_M) & (m <= MAX_M)
    # per line: where its table starts in pak (the zero entries where no
    # table covers m: no codeword is read), its escape symbol 2^m (-1:
    # none) and its raw bits where no table covers m
    base = torch.where(codable,
                       starts[sid][:, None] + ((m - MIN_M) << lmax[:, None]),
                       zero)
    esc_sym = torch.where(codable, 1 << m, -1)
    raw_m = torch.where(codable, 0, m)
    peek = 32 - lmax
    low = torch.tensor(_LOW_BITS, device=words.device)
    pos = mant_start.to(torch.int64)
    vals = []
    for b, e, rm, mj in zip(base.T, esc_sym.T, raw_m.T, m.T):
        # the 32 bits from pos on, from the pair of words at pos
        i = torch.clamp((pos >> 5) + 1, 0, top)
        win = (pairs[row0 + i] >> (32 - (pos & 31))) & _MASK32
        code = pak[b + (win >> peek)]
        sym, ln = code & 0xFFFF, code >> 16
        esc = sym == e
        raw_bits = torch.where(esc, mj, rm)
        used = ln + raw_bits
        vals.append(torch.where(esc, 0, sym)
                    | ((win >> (32 - used)) & low[raw_bits]))
        pos = pos + used
    out[:, cols] = torch.stack(vals, dim=1).to(torch.int32)
    return out


def huffman_decode_rows_plain(words: torch.Tensor, mant_start: torch.Tensor,
                              m_line: torch.Tensor, hc: HuffConsts
                              ) -> torch.Tensor:
    """Plain PyTorch K4 under one set: a loop over the lines, all K rows
    per step.

    words int32 [K, W32] (32-bit patterns); mant_start int [K]; m_line int
    [K, H] with values in [0, 16]. Returns int32 [K, H]."""
    k = words.shape[0]
    sid = torch.zeros(k, dtype=torch.int64, device=words.device)
    return _walk(words, mant_start, m_line, _flat_luts((hc,)), sid,
                 torch.full_like(sid, hc.lmax))


def huffman_decode_sets_plain(words: torch.Tensor, mant_start: torch.Tensor,
                              m_line: torch.Tensor, tid: torch.Tensor,
                              mant_raw: torch.Tensor, huff: tuple) -> torch.Tensor:
    """Plain PyTorch K4 over a decode's rows, as the kernel runs them: one
    walk, each row under its own tableId's set, written into mant_raw in
    place where tid = s ∈ [1, len(huff)] (a host-side check skips a decode
    with no such row). Returns mant_raw."""
    here = (tid >= 1) & (tid <= len(huff))
    if not bool(here.any()):
        return mant_raw
    sid = torch.clamp(tid.to(torch.int64), 1, len(huff)) - 1
    lmax = torch.tensor([hc.lmax for hc in huff], device=words.device)[sid]
    dec = _walk(words, mant_start, m_line, _flat_luts(huff), sid, lmax)
    mant_raw[here] = dec[here]
    return mant_raw


MAX_SETS = 3           # tableId is two bits: raw + three trained sets
_ready: set = set()    # devices where the kernel's shared-memory opt-in is set


def _lib(device: int):
    """The kernel's C entry; opts in to its shared memory on `device` once."""
    fn = _build.entry("huffdec", "tac_huffman_decode_sets",
                      [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_void_p)] * 2
                      + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
    if device not in _ready:
        setup = _build.entry("huffdec", "tac_huffdec_setup", [ctypes.c_int])
        err = setup(device)
        if err:
            raise RuntimeError("huffdec: shared-memory opt-in refused: CUDA "
                               f"error {err}")
        _ready.add(device)
    return fn


def huffman_decode_sets(words: torch.Tensor, mant_start: torch.Tensor,
                        m_line: torch.Tensor, tid: torch.Tensor,
                        mant_raw: torch.Tensor, huff: tuple) -> torch.Tensor:
    """K4: every Huffman-coded row's mantissas, each row with its own set.

    words int32 [K, W32] payload rows (32-bit patterns); mant_start int32
    [K] absolute bit offset of each row's mantissa run; m_line int32 [K, H]
    mantissa size per line, in [0, 16]; tid int32 [K] tableIds; mant_raw
    int32 [K, H] the rows' raw reading; huff: the trained sets (HuffConsts,
    index = tid − 1) on the same device. Returns mant_raw, holding set s's
    walk where tid = s ∈ [1, len(huff)] and the raw reading elsewhere.

    The Huffman rows are written into mant_raw in place, which is returned:
    on the CPU by the plain version, on CUDA by one launch of the kernel
    (counted in ``huffman_decode_sets.launches``), or the call raises."""
    if words.device.type == "cpu":
        return huffman_decode_sets_plain(words, mant_start, m_line, tid,
                                         mant_raw, huff)
    if words.device.type != "cuda":
        raise ValueError(f"huffman_decode_sets: unsupported device {words.device}")
    if not 1 <= len(huff) <= MAX_SETS:
        raise ValueError(f"huffman_decode_sets takes 1..{MAX_SETS} table sets")
    named = [("words", words), ("mant_start", mant_start), ("m_line", m_line),
             ("tid", tid), ("mant_raw", mant_raw)]
    for i, hc in enumerate(huff):
        named += [(f"huff[{i}].lut_tab", hc.lut_tab)]
    for name, t in named:
        if (t.device != words.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(f"huffman_decode_sets: {name} must be a contiguous "
                             f"int32 tensor on {words.device}")
    for i, hc in enumerate(huff):
        if (hc.lut.device != words.device or hc.lut.dtype != torch.int16
                or not hc.lut.is_contiguous() or hc.lut.numel() % 8
                or hc.lut.data_ptr() % 16 or hc.lut_tab.shape != (N_TAB,)):
            raise ValueError(f"huffman_decode_sets: huff[{i}] has no compact "
                             f"peek LUT on {words.device} (huffman.device_tables)")
    if (words.dim() != 2 or m_line.dim() != 2 or words.shape[1] < 1
            or m_line.shape[0] != words.shape[0]
            or mant_start.shape != words.shape[:1] or tid.shape != words.shape[:1]
            or mant_raw.shape != m_line.shape):
        raise ValueError("huffman_decode_sets: words must be [K, W32], "
                         "mant_start and tid [K], m_line and mant_raw [K, H]")
    k, w32 = words.shape
    h = m_line.shape[1]
    if k == 0 or h == 0:
        return mant_raw
    device = words.device.index or 0
    n = len(huff)
    luts = (ctypes.c_void_p * n)(*(hc.lut.data_ptr() for hc in huff))
    tabs = (ctypes.c_void_p * n)(*(hc.lut_tab.data_ptr() for hc in huff))
    sizes = (ctypes.c_int * n)(*(hc.lut.numel() for hc in huff))
    err = _lib(device)(words.data_ptr(), mant_start.data_ptr(), m_line.data_ptr(),
                       tid.data_ptr(), mant_raw.data_ptr(), luts, tabs, sizes, n,
                       k, h, w32, device,
                       torch.cuda.current_stream(words.device).cuda_stream)
    if err:
        raise RuntimeError(f"huffdec kernel launch failed: CUDA error {err}")
    huffman_decode_sets.launches += 1
    return mant_raw


huffman_decode_sets.launches = 0
