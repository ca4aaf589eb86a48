"""PAC-T container: header, block framing and host bit packing
(counterpart of tac/bitstream.py and the framing walk of tac/native.py).

Format: SPEC.md §7. Header little-endian; each (block, channel) payload is
preceded by its u16 byte length; fields are MSB-first. The host packer and
reader (``pack_fields`` / ``unpack_at``) and the FrameCode field layout
(``field_matrix``, ``parse_head``, ``read_raw_lines``) serve the host
(de)serializers of api.py and blockswitch.py; the codec's own path packs
on the device.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from tac_torch import bands
from tac_torch.config import CodecConfig

MAGIC = b"PACT"
VERSION = 1
FLAG_HUFFMAN = 1
FLAG_BLOCKSWITCH = 2
FLAG_MS = 4          # mid/side pairs (SPEC.md §11)

_HEAD = "<HHIHQIHHBBB"
_B = bands.N_BANDS


class CorruptStreamError(ValueError):
    """A decode read ran past the end of the payload or its capacity."""


def pack_fields(values: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Pack (value, width) fields MSB-first into uint8[ceil(bits / 8)].
    values: int[M], each < 2**width; widths: int[M], 0 allowed (the field
    contributes nothing)."""
    values = np.asarray(values, np.uint64)
    widths = np.asarray(widths, np.int64)
    total = int(widths.sum())
    if total == 0:
        return np.zeros(0, np.uint8)
    fid = np.repeat(np.arange(len(widths)), widths)
    end = np.cumsum(widths)
    pos = np.arange(total, dtype=np.int64) - (end[fid] - widths[fid])
    shift = (widths[fid] - 1 - pos).astype(np.uint64)
    bits = ((values[fid] >> shift) & np.uint64(1)).astype(np.uint8)
    pad = (-total) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits)


def unpack_at(bits: np.ndarray, offsets: np.ndarray,
              widths: np.ndarray) -> np.ndarray:
    """Read fields at absolute bit offsets of an unpacked bit array (uint8,
    np.unpackbits) → int64[M]; zero-width fields read 0. Raises
    CorruptStreamError when a field lies outside the array."""
    offsets = np.asarray(offsets, np.int64)
    widths = np.asarray(widths, np.int64)
    m = len(widths)
    total = int(widths.sum())
    if total == 0:
        return np.zeros(m, np.int64)
    fid = np.repeat(np.arange(m), widths)
    end = np.cumsum(widths)
    pos = np.arange(total, dtype=np.int64) - (end[fid] - widths[fid])
    idx = offsets[fid] + pos
    if int(idx.min()) < 0 or int(idx.max()) >= len(bits):
        raise CorruptStreamError("field read past end of payload")
    b = bits[idx].astype(np.int64)
    weight = np.int64(1) << (widths[fid] - 1 - pos)
    vals = np.bincount(fid, weights=(b * weight).astype(np.float64),
                       minlength=m)
    return vals.astype(np.int64)


def assemble_blocks(payloads: np.ndarray, nbytes: np.ndarray) -> bytes:
    """Interleave u16 length prefixes with the (block, channel) payloads:
    payloads uint8[total], all payload bytes back to back in stream order;
    nbytes int[K], the length of each."""
    nbytes = np.asarray(nbytes, np.int64)
    k = len(nbytes)
    out = np.empty(int(nbytes.sum()) + 2 * k, np.uint8)
    dst_start = np.cumsum(nbytes + 2) - nbytes
    le = nbytes.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[dst_start - 2] = le[:, 0]
    out[dst_start - 1] = le[:, 1]
    src_end = np.cumsum(nbytes)
    fid = np.repeat(np.arange(k), nbytes)
    pos = np.arange(int(nbytes.sum()), dtype=np.int64) - (src_end[fid]
                                                           - nbytes[fid])
    out[dst_start[fid] + pos] = payloads
    return out.tobytes()


# ------------------------------------------- FrameCode field layout ----

def to_rows(x: np.ndarray) -> np.ndarray:
    """[C, F, ...] → [F·C, ...]: stream order, block-major, channel-minor."""
    return x.swapaxes(0, 1).reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def from_rows(x: np.ndarray, n_blocks: int, c: int, device) -> torch.Tensor:
    """[F·C, ...] in stream order → int32 [C, F, ...] on `device`."""
    cf = x.reshape(n_blocks, c, *x.shape[1:]).swapaxes(0, 1)
    return torch.tensor(np.ascontiguousarray(cf).astype(np.int32),
                        device=device)


def field_matrix(code_np: dict, cfg: CodecConfig, h: int):
    """FrameCode numpy arrays [K, ...] → (values, widths) [K, 2B+H+2] and
    the payload bytes [K] of the raw layout."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    alloc_code = code_np["alloc_code"]
    k = alloc_code.shape[0]
    alloc = np.where(alloc_code > 0, alloc_code + 1, 0).astype(np.int64)
    vals = np.zeros((k, 2 * _B + h + 2), np.int64)
    wids = np.zeros((k, 2 * _B + h + 2), np.int64)
    vals[:, 0] = code_np["ovs"]
    wids[:, 0] = s
    vals[:, 1:1 + _B] = alloc_code
    wids[:, 1:1 + _B] = a
    vals[:, 1 + _B:1 + 2 * _B] = code_np["scale"]
    wids[:, 1 + _B:1 + 2 * _B] = np.where(alloc > 0, s, 0)
    vals[:, 1 + 2 * _B:1 + 2 * _B + h] = code_np["mant"]
    wids[:, 1 + 2 * _B:1 + 2 * _B + h] = alloc[
        :, bands.band_of_line(cfg.sample_rate, h)]
    bits = wids[:, :-1].sum(axis=1)
    wids[:, -1] = (-bits) % 8                            # pad field (value 0)
    return vals, wids, (bits + wids[:, -1]) // 8


def parse_head(data: bytes, offset: int, k: int, cfg: CodecConfig,
               pre: tuple):
    """The head of k blocks from `offset` on: fixed fields of widths `pre`,
    the B alloc codes, then the scale factors (width 0 where alloc = 0).
    Returns (bits, pre fields [K, len(pre)], alloc_code [K, B], alloc,
    scale [K, B], mantissa start bit [K])."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    offs, _ = split_blocks(data, offset, k)
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    base = offs * 8
    head_w = np.concatenate([list(pre), np.full(_B, a)]).astype(np.int64)
    head_off = base[:, None] + (np.cumsum(head_w) - head_w)
    head = unpack_at(bits, head_off.ravel(), np.tile(head_w, k)
                     ).reshape(k, len(pre) + _B)
    alloc_code = head[:, len(pre):]
    alloc = np.where(alloc_code > 0, alloc_code + 1, 0)
    sf_w = np.where(alloc > 0, s, 0).astype(np.int64)
    sf_end = np.cumsum(sf_w, axis=1)
    first = int(head_w.sum())
    sf = unpack_at(bits, (base[:, None] + first + (sf_end - sf_w)).ravel(),
                   sf_w.ravel()).reshape(k, _B)
    return (bits, head[:, :len(pre)], alloc_code, alloc, sf,
            base + first + sf_end[:, -1])


def read_raw_lines(bits: np.ndarray, start: np.ndarray,
                   m_line: np.ndarray) -> np.ndarray:
    """Raw mantissas of widths m_line [K, H] from bits start [K] on."""
    m_end = np.cumsum(m_line, axis=1)
    return unpack_at(bits, (start[:, None] + (m_end - m_line)).ravel(),
                     m_line.ravel()).reshape(m_line.shape)


@dataclass
class PacHeader:
    """Parsed PAC-T header (SPEC.md §7)."""
    sample_rate: int
    n_channels: int
    num_samples: int            # per channel
    bitrate_bps: int
    n_mdct_lines: int
    n_mdct_lines_short: int
    n_scale_bits: int
    n_mant_size_bits: int
    n_lines_long: np.ndarray    # int[nBandsLong]
    n_lines_short: np.ndarray | None
    huffman: bool
    blockswitch: bool
    ms: bool = False            # mid/side stereo (SPEC.md §11)


def write_header(h: PacHeader) -> bytes:
    flags = (FLAG_HUFFMAN if h.huffman else 0) | \
            (FLAG_BLOCKSWITCH if h.blockswitch else 0) | \
            (FLAG_MS if h.ms else 0)
    out = [MAGIC,
           struct.pack(_HEAD, VERSION, flags, h.sample_rate,
                       h.n_channels, h.num_samples, h.bitrate_bps,
                       h.n_mdct_lines, h.n_mdct_lines_short,
                       h.n_scale_bits, h.n_mant_size_bits,
                       len(h.n_lines_long)),
           np.asarray(h.n_lines_long, "<u2").tobytes()]
    if h.blockswitch:
        out.append(struct.pack("<B", len(h.n_lines_short)))
        out.append(np.asarray(h.n_lines_short, "<u2").tobytes())
    return b"".join(out)


def read_header(data: bytes) -> tuple[PacHeader, int]:
    """Parse a PAC-T header; returns (header, byte offset of first block)."""
    if data[:4] != MAGIC:
        raise ValueError("not a PAC-T stream (bad magic)")
    off = 4
    (ver, flags, fs, nch, nsamp, bps, h_long, h_short, sbits, abits,
     nbl) = struct.unpack_from(_HEAD, data, off)
    if ver != VERSION:
        raise ValueError(f"unsupported PAC-T version {ver}")
    off += struct.calcsize(_HEAD)
    n_lines_long = np.frombuffer(data, "<u2", nbl, off).astype(np.int32)
    off += 2 * nbl
    n_lines_short = None
    if flags & FLAG_BLOCKSWITCH:
        (nbs,) = struct.unpack_from("<B", data, off)
        off += 1
        n_lines_short = np.frombuffer(data, "<u2", nbs, off).astype(np.int32)
        off += 2 * nbs
    if flags & FLAG_MS and nch % 2:
        raise ValueError("mid/side flag on an odd-channel stream "
                         "(corrupt header)")
    hdr = PacHeader(sample_rate=fs, n_channels=nch, num_samples=nsamp,
                    bitrate_bps=bps, n_mdct_lines=h_long,
                    n_mdct_lines_short=h_short, n_scale_bits=sbits,
                    n_mant_size_bits=abits, n_lines_long=n_lines_long,
                    n_lines_short=n_lines_short,
                    huffman=bool(flags & FLAG_HUFFMAN),
                    blockswitch=bool(flags & FLAG_BLOCKSWITCH),
                    ms=bool(flags & FLAG_MS))
    return hdr, off


def split_blocks(data: bytes, offset: int, k: int):
    """Walk k u16-prefixed payloads from `offset`: the chained length
    prefixes force a serial walk. Returns (offs int64[k], lens int64[k]),
    offsets absolute into `data`; raises CorruptStreamError when a prefix
    or a payload crosses the end of the buffer."""
    buf = np.frombuffer(data, np.uint8)
    n = len(buf)
    offs = np.empty(k, np.int64)
    lens = np.empty(k, np.int64)
    o = offset
    for i in range(k):
        if o + 2 > n:
            raise CorruptStreamError("block framing past end of stream")
        lens[i] = int(buf[o]) | (int(buf[o + 1]) << 8)
        offs[i] = o + 2
        o += 2 + int(lens[i])
        if o > n:
            raise CorruptStreamError("block framing past end of stream")
    return offs, lens
