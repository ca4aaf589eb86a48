"""Public API: audio arrays ⇄ PAC-T bytes (counterpart of tac/api.py for
every stream family: fixed-rate or Huffman VBR, with or without block
switching, L/R or mid/side).

The device pipeline (tac_torch.codec) produces packed payload words; the
host adds the PAC-T header and the u16-prefixed block framing. Entry points
run on CUDA unless the caller passes another device (``device="cpu"`` runs
the plain PyTorch path); without a card and without ``device``, they raise.
"""

from __future__ import annotations

import numpy as np

from tac_torch import bands, codec
from tac_torch import bitstream as bs
from tac_torch import blockswitch as bsw
from tac_torch.config import CodecConfig, resolve_device
from tac_torch.dsp.mdct import num_frames
from tac_torch.ops.bitpack import rows_to_stream, stream_to_rows


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
    if cfg.use_block_switch:
        enc = (bsw.encode_clip_bs_vbr_packed if cfg.use_huffman
               else bsw.encode_clip_bs_packed)
    else:
        enc = (codec.encode_clip_vbr_packed if cfg.use_huffman
               else codec.encode_clip_packed)
    words, nbits = enc(x.T, cfg, device)
    return stream_header(cfg, t) + words_to_stream(words, nbits)


def words_to_stream(words, nbits) -> bytes:
    """Payload words int32 [C, F, W32] and bit counts [C, F] (tensors) → the
    u16-prefixed block stream, block-major and channel-minor ([F, C])."""
    w = words.cpu().numpy().view(np.uint32).swapaxes(0, 1)
    return rows_to_stream(w, nbits.cpu().numpy().swapaxes(0, 1))


def stream_header(cfg: CodecConfig, num_samples: int) -> bytes:
    """The PAC-T header of a stream of `cfg` (SPEC.md §7)."""
    h = cfg.n_mdct_lines
    bsw_on = cfg.use_block_switch
    return bs.write_header(bs.PacHeader(
        sample_rate=cfg.sample_rate, n_channels=cfg.n_channels,
        num_samples=num_samples, bitrate_bps=cfg.bitrate_bps, n_mdct_lines=h,
        n_mdct_lines_short=cfg.n_mdct_lines_short if bsw_on else 0,
        n_scale_bits=cfg.n_scale_bits, n_mant_size_bits=cfg.n_mant_size_bits,
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


def payload_words(cfg: CodecConfig) -> int:
    """W32: the 32-bit words of one (block, channel) payload at the
    family's capacity (host arithmetic, no constants)."""
    if cfg.use_block_switch:
        cap = (bsw.capacity_bits_bs_vbr(cfg) if cfg.use_huffman
               else bsw.capacity_bits_bs(cfg))
    else:
        cap = codec.payload_capacity_bits(cfg)
    return -(-cap // 32)


def _decode_blocks(data: bytes, off: int, hdr: bs.PacHeader, cfg: CodecConfig,
                   fa: int, fb: int, t: int, device):
    """Frames [fa, fb) of a stream → [C, t] audio: t ≤ (fb-fa-1)·H samples
    from fa·H on, each covered by two adjacent frames of the range."""
    f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
    c = cfg.n_channels
    offs, lens = bs.split_blocks(data, off, f * c)
    w32 = payload_words(cfg)
    rows = stream_to_rows(data, offs[fa * c:fb * c], lens[fa * c:fb * c], w32)
    words = np.ascontiguousarray(rows.reshape(fb - fa, c, w32).swapaxes(0, 1))
    decoder, make = codec.frame_decoder(cfg)
    consts = make(cfg, resolve_device(device))
    return codec.output_signal(decoder(words.view(np.int32), cfg, consts),
                               cfg, t)


def decode_array(data: bytes, precision: str = "parity", device=None
                 ) -> tuple[np.ndarray, int]:
    """PAC-T bytes → (float32[T, C], sample_rate)."""
    hdr, off = bs.read_header(data)
    cfg = header_config(hdr, precision)
    f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
    x = _decode_blocks(data, off, hdr, cfg, 0, f, hdr.num_samples, device)
    return x.cpu().numpy().T.astype(np.float32), hdr.sample_rate


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
    return out.cpu().numpy().T.astype(np.float32), hdr.sample_rate
