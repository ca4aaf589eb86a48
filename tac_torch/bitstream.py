"""PAC-T container: header and block framing (counterpart of the header
parts of tac/bitstream.py and the framing walk of tac/native.py).

Format: SPEC.md §7. Header little-endian; each (block, channel) payload is
preceded by its u16 byte length.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"PACT"
VERSION = 1
FLAG_HUFFMAN = 1
FLAG_BLOCKSWITCH = 2
FLAG_MS = 4          # mid/side pairs (SPEC.md §11)

_HEAD = "<HHIHQIHHBBB"


class CorruptStreamError(ValueError):
    """A decode read ran past the end of the payload or its capacity."""


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
