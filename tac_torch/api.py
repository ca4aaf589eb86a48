"""Public API: audio arrays ⇄ PAC-T bytes (counterpart of tac/api.py for
every stream family: fixed-rate or Huffman VBR, with or without block
switching, L/R or mid/side).

The device pipeline (tac_torch.family) produces packed payload words; the
host adds the PAC-T header and the u16-prefixed block framing. Entry points
run on CUDA unless the caller passes another device (``device="cpu"`` runs
the plain PyTorch path); without a card and without ``device``, they raise.

The FrameCode (de)serializers (``frames_to_payload[_vbr]``,
``payload_to_frames[_vbr]``) are the host reference of the payload layout
(SPEC.md §7, §8): a rectangular field matrix per (block, channel) — ovs |
[tableId] | B alloc codes | B scale factors (width 0 where alloc = 0) | H
mantissas or Huffman pairs | pad to a byte — packed and parsed with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from tac_torch import bands, family
from tac_torch import bitstream as bs
from tac_torch import huffman as hf
from tac_torch import tracing
from tac_torch.codec import FrameCode
from tac_torch.config import CodecConfig, resolve_device
from tac_torch.dsp.mdct import num_frames
from tac_torch.io.wav import read_wav, write_wav
from tac_torch.ops.bitpack import rows_to_stream, stream_to_rows

_B = bands.N_BANDS


def host_array(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    return (tracing.to_host(x).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


# ------------------------------------------------------------- serialize ----

def frames_to_payload(code: FrameCode, cfg: CodecConfig, h: int) -> bytes:
    """FrameCode with [C, F, ...] leaves (tensors or arrays) → the
    u16-prefixed block stream of the raw layout (tac/api.py)."""
    code_np = {k: bs.to_rows(host_array(v))
               for k, v in code._asdict().items()}
    vals, wids, nbytes = bs.field_matrix(code_np, cfg, h)
    return bs.assemble_blocks(bs.pack_fields(vals.ravel(), wids.ravel()),
                              nbytes)


def payload_to_frames(data: bytes, offset: int, n_blocks: int,
                      cfg: CodecConfig, h: int, device=None) -> FrameCode:
    """Inverse of ``frames_to_payload``: parsed on the host, a FrameCode
    with int32 [C, F, ...] leaves on `device` (CUDA unless named)."""
    dev = resolve_device(device)
    c = cfg.n_channels
    bits, pre, alloc_code, alloc, sf, start = bs.parse_head(
        data, offset, n_blocks * c, cfg, (cfg.n_scale_bits,))
    m_line = alloc[:, bands.band_of_line(cfg.sample_rate, h)].astype(np.int64)
    mant = bs.read_raw_lines(bits, start, m_line)
    return FrameCode(*(bs.from_rows(v, n_blocks, c, dev)
                       for v in (pre[:, 0], alloc_code, sf, mant)))


# ------------------------------------------------------- vbr serialization --

def frames_to_payload_vbr(code: FrameCode, table_id, cfg: CodecConfig,
                          h: int) -> bytes:
    """FrameCode [C, F, ...] and tableIds [C, F] (0 = raw, 1..3 = trained
    sets) → the block stream of the Huffman layout (SPEC.md §7, §8): ovs |
    2-bit tableId | allocs | sfs | coded mantissa pairs | pad."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    ovs, alloc_code, sf, mant = (bs.to_rows(host_array(v)) for v in code)
    tid = bs.to_rows(host_array(table_id))
    k = tid.shape[0]
    alloc = np.where(alloc_code > 0, alloc_code + 1, 0).astype(np.int64)
    m_line = alloc[:, bands.band_of_line(cfg.sample_rate, h)]
    # every line's pair under its row's set; raw rows overwrite below
    hvals, hwids = hf.encode_fields(mant, m_line)
    for sid in range(2, hf.n_sets() + 1):
        rows = tid == sid
        if rows.any():
            hvals[rows], hwids[rows] = hf.encode_fields(
                mant[rows], m_line[rows], set_id=sid)
    raw = tid == 0
    hvals[raw, :, 0], hwids[raw, :, 0] = mant[raw], m_line[raw]
    hvals[raw, :, 1], hwids[raw, :, 1] = 0, 0

    nf = 2 + 2 * _B + 2 * h + 1
    vals = np.zeros((k, nf), np.int64)
    wids = np.zeros((k, nf), np.int64)
    vals[:, 0], wids[:, 0] = ovs, s
    vals[:, 1], wids[:, 1] = tid, 2
    vals[:, 2:2 + _B], wids[:, 2:2 + _B] = alloc_code, a
    vals[:, 2 + _B:2 + 2 * _B] = sf
    wids[:, 2 + _B:2 + 2 * _B] = np.where(alloc > 0, s, 0)
    vals[:, 2 + 2 * _B:-1] = hvals.reshape(k, 2 * h)
    wids[:, 2 + 2 * _B:-1] = hwids.reshape(k, 2 * h)
    bits = wids[:, :-1].sum(axis=1)
    wids[:, -1] = (-bits) % 8
    return bs.assemble_blocks(bs.pack_fields(vals.ravel(), wids.ravel()),
                              (bits + wids[:, -1]) // 8)


def payload_to_frames_vbr(data: bytes, offset: int, n_blocks: int,
                          cfg: CodecConfig, h: int, device=None) -> FrameCode:
    """Inverse of ``frames_to_payload_vbr`` (SPEC.md §8): raw rows by
    offsets, Huffman rows by the host walk (``huffman.decode_lines``, which
    raises CorruptStreamError past the payload). A FrameCode with int32
    [C, F, ...] leaves on `device` (CUDA unless named)."""
    dev = resolve_device(device)
    c = cfg.n_channels
    bits, pre, alloc_code, alloc, sf, start = bs.parse_head(
        data, offset, n_blocks * c, cfg, (cfg.n_scale_bits, 2))
    tid = pre[:, 1]
    m_line = alloc[:, bands.band_of_line(cfg.sample_rate, h)].astype(np.int64)
    mant = np.zeros(m_line.shape, np.int64)
    raw = np.nonzero(tid == 0)[0]
    if raw.size:
        mant[raw] = bs.read_raw_lines(bits, start[raw], m_line[raw])
    for sid in range(1, hf.n_sets() + 1):
        for i in np.nonzero(tid == sid)[0]:
            mant[i] = hf.decode_lines(bits, int(start[i]), m_line[i], sid)[0]
    return FrameCode(*(bs.from_rows(v, n_blocks, c, dev)
                       for v in (pre[:, 0], alloc_code, sf, mant)))


# ------------------------------------------------------------ public api ----


def encode_array(x: np.ndarray, cfg: CodecConfig, device=None) -> bytes:
    """x: float[T] or [T, C] in [-1, 1) → PAC-T bytes."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    t, c = x.shape
    if c > 64:
        # a [C, T] array passed where [T, C] is expected would silently
        # become a T-channel encode; PAC-T caps channels well under 64
        raise ValueError(
            f"encode_array expects float[T] or [T, C] (got {x.shape}: "
            f"{c} channels) — transpose [C, T] input")
    if c != cfg.n_channels:
        if cfg.stereo_mode == "ms" and c % 2:
            raise ValueError(
                f"stereo_mode='ms' requires even channel count, got {c}")
        cfg = cfg.replace(n_channels=c)
    with tracing.span("tac.encode"):
        words, nbits = family.encode_clip_packed(x.T, cfg, device)
        return stream_header(cfg, t) + words_to_stream(words, nbits)


def words_to_stream(words, nbits) -> bytes:
    """Payload words int32 [C, F, W32] and bit counts [C, F] (tensors) → the
    u16-prefixed block stream (``host_words_to_stream``)."""
    with tracing.span("tac.api.serialize"):
        return host_words_to_stream(
            tracing.to_host(words).numpy().view(np.uint32),
            tracing.to_host(nbits).numpy())


def host_words_to_stream(words: np.ndarray, nbits: np.ndarray) -> bytes:
    """Payload words uint32 [C, F, W32] and bit counts [C, F] (host arrays,
    any strides) → the u16-prefixed block stream, block-major and
    channel-minor ([F, C])."""
    return rows_to_stream(words.swapaxes(0, 1), nbits.swapaxes(0, 1))


def stream_words(data: bytes, offs, lens, c: int, w32: int) -> np.ndarray:
    """The payloads at (offs, lens) of a stream, whole frames of c blocks
    in its block-major, channel-minor order → payload words uint32
    [c, F, w32]. Raises CorruptStreamError on a block longer than the
    capacity."""
    rows = stream_to_rows(data, offs, lens, w32)
    return np.ascontiguousarray(rows.reshape(-1, c, w32).swapaxes(0, 1))


def stream_header(cfg: CodecConfig, num_samples: int) -> bytes:
    """The PAC-T header of a stream of `cfg` (SPEC.md §7)."""
    h = cfg.n_mdct_lines
    bsw_on = cfg.use_block_switch
    with tracing.span("tac.api.serialize"):
        return bs.write_header(bs.PacHeader(
            sample_rate=cfg.sample_rate, n_channels=cfg.n_channels,
            num_samples=num_samples, bitrate_bps=cfg.bitrate_bps,
            n_mdct_lines=h,
            n_mdct_lines_short=cfg.n_mdct_lines_short if bsw_on else 0,
            n_scale_bits=cfg.n_scale_bits,
            n_mant_size_bits=cfg.n_mant_size_bits,
            n_lines_long=bands.lines_per_band(cfg.sample_rate, h),
            n_lines_short=(bands.lines_per_band(cfg.sample_rate,
                                                cfg.n_mdct_lines_short)
                           if bsw_on else None),
            huffman=cfg.use_huffman, blockswitch=bsw_on,
            ms=cfg.stereo_mode == "ms"))


def header_config(hdr: bs.PacHeader, precision: str = "fast") -> CodecConfig:
    """The decode-side CodecConfig implied by a PAC-T header."""
    return CodecConfig(
        sample_rate=hdr.sample_rate, n_channels=hdr.n_channels,
        bitrate_bps=hdr.bitrate_bps, n_mdct_lines=hdr.n_mdct_lines,
        n_scale_bits=hdr.n_scale_bits, n_mant_size_bits=hdr.n_mant_size_bits,
        use_huffman=hdr.huffman, use_block_switch=hdr.blockswitch,
        n_mdct_lines_short=max(hdr.n_mdct_lines_short, 1),
        stereo_mode="ms" if hdr.ms else "lr",
        use_psy=False, precision=precision)


def _decode_blocks(data: bytes, off: int, hdr: bs.PacHeader, cfg: CodecConfig,
                   fa: int, fb: int, t: int, device):
    """Frames [fa, fb) of a stream → [C, t] audio: t ≤ (fb-fa-1)·H samples
    from fa·H on, each covered by two adjacent frames of the range."""
    f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
    c = cfg.n_channels
    offs, lens = bs.split_blocks(data, off, f * c)
    words = stream_words(data, offs[fa * c:fb * c], lens[fa * c:fb * c], c,
                         family.payload_words(cfg))
    return family.decode_clip_packed(words.view(np.int32), cfg, t, device)


def decode_array(data: bytes, precision: str = "parity", device=None
                 ) -> tuple[np.ndarray, int]:
    """PAC-T bytes → (float32[T, C], sample_rate)."""
    hdr, off = bs.read_header(data)
    cfg = header_config(hdr, precision)
    f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
    x = _decode_blocks(data, off, hdr, cfg, 0, f, hdr.num_samples, device)
    return tracing.to_host(x).numpy().T.astype(np.float32), hdr.sample_rate


def decode_range(data: bytes, start: int, stop: int, precision: str = "fast",
                 device=None) -> tuple[np.ndarray, int]:
    """Sample-accurate random access (tac/api.py:decode_range): PAC-T bytes
    → (float32[stop-start, C], sample_rate), the output samples [start,
    stop), indices clamped to [0, num_samples], in every stream family.

    Sample s depends on frames s//H and s//H + 1 only (the 50 % overlap),
    and every per-frame decision rides in its frame's payload, so decoding
    exactly the covering frames [start//H, (stop-1)//H + 2) gives the full
    decode's samples: exactly in parity precision, and in fast precision
    up to f32 rounding of another batch shape. The u16 length prefixes
    still need a host walk over every block before the range."""
    hdr, off = bs.read_header(data)
    cfg = header_config(hdr, precision)
    h, c = hdr.n_mdct_lines, hdr.n_channels
    start = max(0, min(int(start), hdr.num_samples))
    stop = max(start, min(int(stop), hdr.num_samples))
    if stop == start:
        return np.zeros((0, c), np.float32), hdr.sample_rate
    fa = start // h
    fb = min(num_frames(hdr.num_samples, h), (stop - 1) // h + 2)
    x = _decode_blocks(data, off, hdr, cfg, fa, fb, stop - fa * h, device)
    out = x[..., start - fa * h:]
    return tracing.to_host(out).numpy().T.astype(np.float32), hdr.sample_rate


def encode(wav_path: str, pac_path: str, cfg: CodecConfig, device=None) -> dict:
    """WAV file → PAC-T file at the WAV's sample rate. Returns a stats
    record: seconds, bytes, kbps."""
    x, fs = read_wav(wav_path)
    if fs != cfg.sample_rate:
        cfg = cfg.replace(sample_rate=fs)
    data = encode_array(x, cfg, device)
    with open(pac_path, "wb") as fo:
        fo.write(data)
    dur = x.shape[0] / fs
    return {"seconds": dur, "bytes": len(data),
            "kbps": len(data) * 8 / dur / 1000.0}


def decode(pac_path: str, wav_path: str, precision: str = "parity",
           device=None) -> dict:
    """PAC-T file → 16-bit WAV file. Returns seconds, sample_rate,
    channels."""
    with open(pac_path, "rb") as fi:
        data = fi.read()
    x, fs = decode_array(data, precision, device)
    write_wav(wav_path, x, fs)
    return {"seconds": x.shape[0] / fs, "sample_rate": fs,
            "channels": x.shape[1]}
