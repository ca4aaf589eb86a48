"""The stream family: the one place the port chooses code by
(``use_block_switch``, ``use_huffman``).

A PAC-T stream is of one of four families: fixed rate, Huffman VBR, block
switching, or block switching × VBR; mid/side is handled inside each.
``of(cfg)`` is the family's record, whose fields point at the inner
functions of ``codec`` and ``blockswitch``. On it rest one clip encoder,
one clip decoder and one streaming core of each direction for all four.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tac_torch import blockswitch as bsw
from tac_torch import codec, tracing
from tac_torch.config import CodecConfig, resolve_device
from tac_torch.dsp import mdct as fb


class Family(NamedTuple):
    """One family's code. Where a family has no window states and flags
    (no block switching) or no fills (fixed rate), None stands in."""
    make_consts: Callable    # (cfg, device) → its constants, cached
    frame: Callable          # (x [..., C, T], cfg, c, device) → (frames
    #                          f[..., C, F, N], states int32 [..., C, F])
    frame_halves: Callable   # (halves seq, t_hist bool [L, 2], cfg, c) →
    #                          (frames f[C, m, N], states, t bool [L, m+3])
    encode_frames: Callable  # (frames, states, res0 int32 [L], cfg, c) →
    #                          (words int32 [..., C, F, W32], nbits, res)
    decode_frames: Callable  # (words int32 [..., W32], cfg, c) → f[..., N]
    capacity_bits: Callable  # cfg → payload bits per (block, channel)
    switching: bool          # carries transient flags from push to push
    reservoir: bool          # carries each lane's fill from call to call


def _flat_frames(x, cfg: CodecConfig, c, dev):
    """The offline framing without block switching: no window states."""
    return fb.frame_signal(codec.input_signal(x, cfg, c.dtype, dev),
                           cfg.n_mdct_lines), None


def _flat_halves(seq, t_hist, cfg: CodecConfig, c):
    """The streaming framing without block switching: no states, no flags."""
    return codec.frames_from_halves(seq, cfg, c), None, None


_FAMILIES = {   # (use_block_switch, use_huffman) → the family
    (False, False): Family(
        codec.make_consts, _flat_frames, _flat_halves,
        lambda f, s, r, cfg, c: (*codec.encode_frames_packed(f, cfg, c), None),
        codec.decode_frames_packed, codec.payload_capacity_bits, False, False),
    (False, True): Family(
        codec.make_consts, _flat_frames, _flat_halves,
        lambda f, s, r, cfg, c: codec.encode_frames_vbr_packed(f, r, cfg, c),
        codec.decode_frames_vbr, codec.payload_capacity_bits, False, True),
    (True, False): Family(
        bsw.make_bs_consts, bsw._frames_and_states, bsw.ms_stream_prep,
        lambda f, s, r, cfg, c: (*bsw.encode_frames_bs(f, s, cfg, c), None),
        bsw.decode_frames_bs, bsw.capacity_bits_bs, True, False),
    (True, True): Family(
        bsw.make_bs_consts, bsw._frames_and_states, bsw.ms_stream_prep,
        bsw.encode_frames_bs_vbr, bsw.decode_frames_bs_vbr,
        bsw.capacity_bits_bs_vbr, True, True),
}


def of(cfg: CodecConfig) -> Family:
    """The family of cfg's streams."""
    return _FAMILIES[cfg.use_block_switch, cfg.use_huffman]


def payload_words(cfg: CodecConfig) -> int:
    """W32: the 32-bit words of one (block, channel) payload at the
    family's capacity (host arithmetic, no constants)."""
    return -(-of(cfg).capacity_bits(cfg) // 32)


def encode_clip_packed(x, cfg: CodecConfig, device=None):
    """x: float [..., C, T] (array or tensor) → (words int32 [..., C, F,
    W32] holding 32-bit patterns, nbits int64 [..., C, F]) on `device`
    (CUDA unless named). Under VBR every channel, or M/S pair, of every
    clip is its own reservoir lane from fill 0, so a batch gives each clip
    the bytes of a solo encode."""
    fam, dev = of(cfg), resolve_device(device)
    c = fam.make_consts(cfg, dev)
    with tracing.span("tac.codec.analysis"):
        frames, states = fam.frame(x, cfg, c, dev)
    res0 = (torch.zeros(codec.n_lanes(frames.shape[:-2], cfg),
                        dtype=torch.int32, device=dev)
            if fam.reservoir else None)
    return fam.encode_frames(frames, states, res0, cfg, c)[:2]


def decode_clip_packed(words, cfg: CodecConfig, t: int, device=None):
    """words: int32 [..., C, F, W32] payload rows (32-bit patterns) →
    [..., C, T] audio, on `device` (CUDA unless named)."""
    fam = of(cfg)
    c = fam.make_consts(cfg, resolve_device(device))
    return codec.output_signal(fam.decode_frames(words, cfg, c), cfg, t)


def encode_stream(cfg: CodecConfig, c, seq, *carry):
    """The streaming encoder core (tac's ``_encode_frames_*`` cores and
    their M/S forms): one frame per new half. seq [C, m+1, H] holds the
    prior half and m new halves (L/R, in the codec's float type), and under
    block switching the lookahead before the new ones ([C, m+2, H]; see
    ``blockswitch.ms_stream_prep``); carry is what the family carries, on
    the host or on c's device: t_hist bool [L, 2] under block switching,
    then res0 int32 [L] under VBR, for L lanes (channels, or M/S pairs).
    → (words int32 [C, m, W32], nbits int64 [C, m], then t bool [L, m+3]
    under block switching and res int32 [L, m] under VBR). Tensors in and
    out, so that a push graph can hold it."""
    fam = of(cfg)
    t_hist = carry[0] if fam.switching else None
    res0 = carry[-1] if fam.reservoir else None
    with tracing.span("tac.codec.analysis"):
        frames, states, t = fam.frame_halves(seq, t_hist, cfg, c)
    words, nbits, res = fam.encode_frames(frames, states, res0, cfg, c)
    return tuple(v for v in (words, nbits, t, res) if v is not None)


def decode_stream(cfg: CodecConfig, c, words, tail):
    """The streaming decoder core (tac/codec.py:_decode_frames_stream):
    words int32 [C, m, W32] of m ≥ 1 frames and the carried second half of
    the frame before them, tail f[C, H] (mid/side under M/S) → (out
    [C, m, H], the finished samples of each frame's first half, L/R; the
    new tail [C, H])."""
    h = cfg.n_mdct_lines
    y = of(cfg).decode_frames(words, cfg, c)       # [C, m, 2H]
    firsts, seconds = y[..., :h], y[..., h:]
    # the operand order of fb.overlap_add: first half + previous second
    out = firsts + torch.cat([tail.to(y)[:, None], seconds[:, :-1]], dim=1)
    if cfg.stereo_mode == "ms":                    # per sample: commutes
        out = codec.ms_inverse(out.reshape(out.shape[0], -1)).reshape(
            out.shape)
    return out, seconds[:, -1]
