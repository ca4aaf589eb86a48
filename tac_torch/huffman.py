"""Huffman entropy coding of mantissas (counterpart of tac/huffman.py,
SPEC.md §8).

Tables are canonical and trained offline; three sets fill the 2-bit tableId
(0 = raw, 1/2/3 = trained sets; the package keeps its own copy of the three
table files). Symbols are the raw m-bit mantissa codes plus ESCAPE (= 2^m),
which is followed by the raw m bits.

On the card every table lookup is a plain gather into a small device
tensor: ``HuffConsts`` holds one set's cost rows [7, 256], encode rows
[9, 256], the packed decode LUT [7, 2^lmax] that the plain decode walk
reads, and the compact peek LUT (each table at its own longest codeword)
that kernel K4 (tac_torch/ops/huffdec.py) holds in shared memory.
``host_tables`` builds them in NumPy; ``device_tables`` uploads any such
set of arrays. The host serializers of api.py code and walk on the host
(``encode_fields``, ``decode_lines``).
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

MIN_M, MAX_M = 2, 8          # Huffman-codable mantissa sizes
N_TAB = MAX_M - MIN_M + 1
MAX_LEN = 16                 # longest codeword the decode kernel's tables hold
_DIR = os.path.dirname(__file__)
SET_PATHS = {1: os.path.join(_DIR, "huffman_tables.json"),
             2: os.path.join(_DIR, "huffman_tables_t.json"),
             3: os.path.join(_DIR, "huffman_tables_s.json")}

# Array leaves of one table set, as ``host_tables`` returns them.
HUFF_LEAVES = ("cost", "enc_code", "enc_len", "enc_esc", "dec_pak")


class HuffConsts(NamedTuple):
    """One trained table set on one device."""
    cost: torch.Tensor       # [7, 256] int32 coded bits of symbol s at size m
    enc_code: torch.Tensor   # [9, 256] int32 codeword (ESCAPE's where escaped)
    enc_len: torch.Tensor    # [9, 256] int32 codeword length
    enc_esc: torch.Tensor    # [9, 256] bool symbol has no codeword of its own
    dec_pak: torch.Tensor    # [7, 2^lmax] int32 peek LUT: length << 16 | symbol
    lmax: int                # peek width of dec_pak
    lut: torch.Tensor        # [E] int16 compact peek LUT: length << 9 | symbol
    lut_tab: torch.Tensor    # [7] int32 per table: offset in lut << 5 | width


def n_sets() -> int:
    """Contiguous trained table sets available on disk (2/3 optional)."""
    n = 1
    while n + 1 in SET_PATHS and os.path.exists(SET_PATHS[n + 1]):
        n += 1
    return n


@lru_cache(maxsize=4)
def load_tables(set_id: int = 1) -> dict[int, dict[str, np.ndarray]]:
    """{m: {lengths[2^m + 1], codes[2^m + 1]}} (last symbol = ESCAPE)."""
    with open(SET_PATHS[set_id]) as f:
        raw = json.load(f)
    return {int(m): {"lengths": np.asarray(t["lengths"], np.int64),
                     "codes": np.asarray(t["codes"], np.int64)}
            for m, t in raw.items()}


@lru_cache(maxsize=4)
def cost_table_np(set_id: int = 1) -> np.ndarray:
    """int32[MAX_M - 1, 2^MAX_M]: effective coded bits of symbol s at
    mantissa size m (row m - MIN_M). Escaped symbols cost esc_len + m."""
    tabs = load_tables(set_id)
    out = np.zeros((N_TAB, 2 ** MAX_M), np.int32)
    for m in range(MIN_M, MAX_M + 1):
        lens = tabs[m]["lengths"]
        out[m - MIN_M, : 2 ** m] = np.where(lens[:-1] > 0, lens[:-1],
                                            lens[-1] + m)
    return out


@lru_cache(maxsize=4)
def _enc_arrays(set_id: int = 1):
    """Per-m encode arrays padded to [MAX_M+1 rows, 2^MAX_M cols]:
    (code, len, escaped?). Row index = m (0/1 rows unused)."""
    tabs = load_tables(set_id)
    codes = np.zeros((MAX_M + 1, 2 ** MAX_M), np.int64)
    lens = np.zeros((MAX_M + 1, 2 ** MAX_M), np.int64)
    escaped = np.zeros((MAX_M + 1, 2 ** MAX_M), bool)
    for m in range(MIN_M, MAX_M + 1):
        t = tabs[m]
        n = 2 ** m
        has = t["lengths"][:-1] > 0
        codes[m, :n] = np.where(has, t["codes"][:-1], t["codes"][-1])
        lens[m, :n] = np.where(has, t["lengths"][:-1], t["lengths"][-1])
        escaped[m, :n] = ~has
    return codes, lens, escaped


@lru_cache(maxsize=4)
def _dec_luts(set_id: int = 1):
    """Per-m peek LUTs: {m: (lut_sym[2^L], lut_len[2^L], L, escape_symbol)}."""
    luts = {}
    for m, t in load_tables(set_id).items():
        lens, codes = t["lengths"], t["codes"]
        width = int(max(lens))
        sym_lut = np.zeros(1 << width, np.int32)
        len_lut = np.zeros(1 << width, np.int32)
        for s, (ln, c) in enumerate(zip(lens, codes)):
            if ln == 0:
                continue
            base = c << (width - ln)
            sym_lut[base:base + (1 << (width - ln))] = s
            len_lut[base:base + (1 << (width - ln))] = ln
        luts[m] = (sym_lut, len_lut, width, 2 ** m)
    return luts


def packed_dec_lut(set_id: int = 1) -> np.ndarray:
    """int32[7, 2^lmax]: every table's peek LUT widened to the set's longest
    codeword lmax, each entry length << 16 | symbol (0 = uncovered peek)."""
    luts = _dec_luts(set_id)
    lmax = max(v[2] for v in luts.values())
    pak = np.zeros((N_TAB, 1 << lmax), np.int32)
    for m in range(MIN_M, MAX_M + 1):
        sym_lut, len_lut, width, _ = luts[m]
        pak[m - MIN_M] = np.repeat((len_lut << 16) | sym_lut,
                                   1 << (lmax - width))
    return pak


def compact_dec_lut(dec_pak: np.ndarray):
    """The compact peek LUT of a packed one [7, 2^lmax]: (lut int16[E],
    tab int32[7]). Table t is taken at its own width w_t, its longest
    codeword (0 for a table without codes), so the peek p of lmax bits has
    the entry lut[off_t + (p >> (lmax - w_t))], which holds
    length << 9 | symbol (0 = uncovered peek); tab[t] = off_t << 5 | w_t.
    E is padded to a multiple of 8 (16-byte rows for the kernel's copy).
    Raises ValueError when dec_pak[t] is not constant over each block of
    2^(lmax - w_t) peeks, or a length or symbol does not fit its field."""
    dec_pak = np.asarray(dec_pak)
    lmax = int(dec_pak.shape[1]).bit_length() - 1
    if dec_pak.shape != (N_TAB, 1 << lmax) or lmax > MAX_LEN:
        raise ValueError(f"peek LUT of shape {dec_pak.shape} is not "
                         f"[{N_TAB}, 2^lmax] with lmax <= {MAX_LEN}")
    lens, syms = dec_pak >> 16, dec_pak & 0xFFFF
    if lens.max() > MAX_LEN or syms.max() > 2 ** MAX_M or (dec_pak < 0).any():
        raise ValueError("peek LUT entry out of range")
    parts, tab, off = [], np.zeros(N_TAB, np.int32), 0
    for t in range(N_TAB):
        w = int(lens[t].max())
        blocks = (lens[t] << 9 | syms[t]).reshape(1 << w, -1)
        if (blocks != blocks[:, :1]).any():
            raise ValueError(f"huffman table m={t + MIN_M}: peek LUT not "
                             f"constant over its {blocks.shape[1]}-peek blocks")
        parts.append(blocks[:, 0])
        tab[t] = off << 5 | w
        off += 1 << w
    lut = np.zeros(-(-off // 8) * 8, np.int16)
    lut[:off] = np.concatenate(parts)
    return lut, tab


def host_tables(set_id: int) -> dict:
    """One table set's arrays in NumPy (HUFF_LEAVES)."""
    codes, lens, escaped = _enc_arrays(set_id)
    return {"cost": cost_table_np(set_id), "enc_code": codes, "enc_len": lens,
            "enc_esc": escaped, "dec_pak": packed_dec_lut(set_id)}


def device_tables(arrays: dict, device) -> HuffConsts:
    """Upload one table set (see ``host_tables``) to `device`."""
    def up(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    lut, tab = compact_dec_lut(arrays["dec_pak"])
    return HuffConsts(
        cost=up(arrays["cost"], torch.int32),
        enc_code=up(arrays["enc_code"], torch.int32),
        enc_len=up(arrays["enc_len"], torch.int32),
        enc_esc=up(arrays["enc_esc"], torch.bool),
        dec_pak=up(arrays["dec_pak"], torch.int32),
        lmax=int(np.asarray(arrays["dec_pak"]).shape[1]).bit_length() - 1,
        lut=up(lut, torch.int16), lut_tab=up(tab, torch.int32))


def encode_fields(mant: np.ndarray, m_line: np.ndarray, set_id: int = 1):
    """Host form of ``encode_fields_device`` (tac/huffman.py:encode_fields):
    mant, m_line int[..., H] → (vals, wids) int64[..., H, 2]."""
    codes, lens, escaped = _enc_arrays(set_id)
    m = np.clip(m_line, 0, MAX_M)
    codable = (m_line >= MIN_M) & (m_line <= MAX_M)
    sym = np.clip(mant, 0, 2 ** MAX_M - 1)
    cw = np.where(codable, codes[m, sym], mant)
    cl = np.where(codable, lens[m, sym], m_line)
    esc = codable & escaped[m, sym]
    vals = np.stack([cw, np.where(esc, mant, 0)], axis=-1)
    wids = np.stack([cl, np.where(esc, m_line, 0)], axis=-1)
    return vals, wids


def decode_lines(bits: np.ndarray, start: int, m_per_line: np.ndarray,
                 set_id: int = 1) -> tuple[np.ndarray, int]:
    """Serial canonical decode of one block's mantissas on the host
    (tac/huffman.py:decode_lines, the bounds-checked walk).

    bits: uint8[*] unpacked bit array; start: absolute bit offset;
    m_per_line: int[H] mantissa size per line (0 = absent). Returns
    (mant int64[H], end offset). Raises CorruptStreamError when a consuming
    read crosses the end of the bits."""
    from tac_torch.bitstream import CorruptStreamError

    luts = _dec_luts(set_id)
    out = np.zeros(len(m_per_line), np.int64)
    pos = start
    total = len(bits)

    def read_raw(pos, m):
        if pos + m > total:
            raise CorruptStreamError("mantissa walk past end of payload")
        v = 0
        for _ in range(m):
            v = (v << 1) | int(bits[pos])
            pos += 1
        return v, pos

    for i, m in enumerate(m_per_line):
        m = int(m)
        if m == 0:
            continue
        if m < MIN_M or m > MAX_M:
            out[i], pos = read_raw(pos, m)
            continue
        sym_lut, len_lut, width, esc = luts[m]
        peek = 0
        for j in range(width):
            b = int(bits[pos + j]) if pos + j < total else 0
            peek = (peek << 1) | b
        s = int(sym_lut[peek])
        pos += int(len_lut[peek])
        if pos > total:
            raise CorruptStreamError("huffman codeword past end of payload")
        if s == esc:
            out[i], pos = read_raw(pos, m)
        else:
            out[i] = s
    return out, pos


def encode_fields_device(mant: torch.Tensor, m_line: torch.Tensor,
                         hc: HuffConsts):
    """Huffman-coded field pairs for frames' mantissas, on their device.

    mant, m_line: int32[..., H] → (vals, wids) int32[..., H, 2]: per line a
    codeword field and an escape-raw field (width 0 when not escaped or m
    outside [MIN_M, MAX_M] — then the codeword field IS the raw mantissa).
    Integer-identical to tac's encode_fields_device for the same set."""
    m = torch.clamp(m_line, 0, MAX_M).long()
    codable = (m_line >= MIN_M) & (m_line <= MAX_M)
    sym = torch.clamp(mant, 0, 2 ** MAX_M - 1).long()
    cw = torch.where(codable, hc.enc_code[m, sym], mant)
    cl = torch.where(codable, hc.enc_len[m, sym], m_line)
    esc = codable & hc.enc_esc[m, sym]
    vals = torch.stack([cw, torch.where(esc, mant, 0)], dim=-1)
    wids = torch.stack([cl, torch.where(esc, m_line, 0)], dim=-1)
    return vals.to(torch.int32), wids.to(torch.int32)
