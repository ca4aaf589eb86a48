"""Batched corpus encode and decode on one device (counterpart of the
single-device half of tac/parallel.py).

Every packed encoder and decoder of the port takes leading axes ([..., C,
T] and [..., C, F, W32]): the fixed-rate and block-switch families flatten
them into one frame-row axis, the VBR families into reservoir lanes (each
channel, or each mid/side pair, of each clip its own chain from fill 0),
so a batch [B, C, T] gives every clip the words of a solo encode.
"""

from __future__ import annotations

import torch

from tac_torch import blockswitch as bsw
from tac_torch import codec
from tac_torch.codec import FrameCode
from tac_torch.config import CodecConfig


def encode_batch(x, cfg: CodecConfig, device=None) -> FrameCode:
    """x: float [B, C, T] → FrameCode [B, C, F, ...] (tac's encode_batch)."""
    return codec.encode_clip(x, cfg, device)


def packed_encoder(cfg: CodecConfig):
    """The packed-encode entry of cfg's stream family."""
    if cfg.use_block_switch:
        return (bsw.encode_clip_bs_vbr_packed if cfg.use_huffman
                else bsw.encode_clip_bs_packed)
    return (codec.encode_clip_vbr_packed if cfg.use_huffman
            else codec.encode_clip_packed)


def _packed_decoder(cfg: CodecConfig):
    """The packed-decode entry of cfg's stream family."""
    if cfg.use_block_switch:
        return (bsw.decode_clip_bs_vbr_packed if cfg.use_huffman
                else bsw.decode_clip_bs_packed)
    return (codec.decode_clip_vbr_packed if cfg.use_huffman
            else codec.decode_clip_packed)


def encode_batch_packed(x, cfg: CodecConfig, device=None):
    """Batched packed encode on `device` (CUDA unless named). x: float
    [B, C, T] → (words int32 [B, C, F, W32] holding 32-bit patterns, nbits
    int64 [B, C, F])."""
    return packed_encoder(cfg)(x, cfg, device)


def to_pcm16(y: torch.Tensor) -> torch.Tensor:
    """16-bit PCM on y's device with write_wav's rounding (half to even,
    clipped): the pull to the host is a quarter of f64's, half of f32's."""
    return torch.clamp(torch.round(y * 32768.0), -32768, 32767).to(torch.int16)


def decode_batch_packed(words, cfg: CodecConfig, t: int,
                        pcm16: bool = False, device=None):
    """Batched packed decode, the mirror of ``encode_batch_packed``: payload
    rows int32 [B, C, F, W32] → [B, C, T] on `device` (CUDA unless named).
    The family comes from cfg. pcm16=True quantizes to int16 on the device
    (``to_pcm16``)."""
    y = _packed_decoder(cfg)(words, cfg, t, device)
    return to_pcm16(y) if pcm16 else y
