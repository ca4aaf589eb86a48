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
from tac_torch.config import CodecConfig
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
    h = cfg.n_mdct_lines
    if cfg.use_block_switch:
        enc = (bsw.encode_clip_bs_vbr_packed if cfg.use_huffman
               else bsw.encode_clip_bs_packed)
    else:
        enc = (codec.encode_clip_vbr_packed if cfg.use_huffman
               else codec.encode_clip_packed)
    words, nbits = enc(x.T, cfg, device)
    # stream order is block-major, channel-minor: [F, C]
    w = words.cpu().numpy().view(np.uint32).swapaxes(0, 1)
    payload = rows_to_stream(w, nbits.cpu().numpy().swapaxes(0, 1))
    hdr = bs.PacHeader(
        sample_rate=cfg.sample_rate, n_channels=c, num_samples=t,
        bitrate_bps=cfg.bitrate_bps, n_mdct_lines=h,
        n_mdct_lines_short=cfg.n_mdct_lines_short if cfg.use_block_switch else 0,
        n_scale_bits=cfg.n_scale_bits, n_mant_size_bits=cfg.n_mant_size_bits,
        n_lines_long=bands.lines_per_band(cfg.sample_rate, h),
        n_lines_short=(bands.lines_per_band(cfg.sample_rate,
                                            cfg.n_mdct_lines_short)
                       if cfg.use_block_switch else None),
        huffman=cfg.use_huffman, blockswitch=cfg.use_block_switch,
        ms=cfg.stereo_mode == "ms")
    return bs.write_header(hdr) + payload


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


def decode_array(data: bytes, precision: str = "parity", device=None
                 ) -> tuple[np.ndarray, int]:
    """PAC-T bytes → (float32[T, C], sample_rate)."""
    hdr, off = bs.read_header(data)
    cfg = header_config(hdr, precision)
    f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
    c = cfg.n_channels
    offs, lens = bs.split_blocks(data, off, f * c)
    if hdr.blockswitch:
        cap = (bsw.capacity_bits_bs_vbr(cfg) if hdr.huffman
               else bsw.capacity_bits_bs(cfg))
        dec = (bsw.decode_clip_bs_vbr_packed if hdr.huffman
               else bsw.decode_clip_bs_packed)
    else:
        cap = codec.payload_capacity_bits(cfg)
        dec = (codec.decode_clip_vbr_packed if hdr.huffman
               else codec.decode_clip_packed)
    w32 = -(-cap // 32)
    rows = stream_to_rows(data, offs, lens, w32)           # [F*C, W32]
    words = np.ascontiguousarray(rows.reshape(f, c, w32).swapaxes(0, 1))
    x = dec(words.view(np.int32), cfg, hdr.num_samples, device)
    return x.cpu().numpy().T.astype(np.float32), hdr.sample_rate
