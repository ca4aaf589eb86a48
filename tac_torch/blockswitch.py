"""Long/short block switching, fixed-rate and Huffman VBR, L/R or mid/side
(counterpart of those parts of tac/blockswitch.py, SPEC.md §9, §11).

A frame's window state (LONG, START, SHORT, STOP) follows from per-half-
block transient flags by vectorised neighbour logic. Every frame row is
analysed both ways — one long transform under its state's window, and K
grouped short transforms that share one overall scale, allocation and set
of scale factors — and the state picks which encoding is serialised. Both
encodings have the same shapes ([B] bands, [H] mantissas); only the
line→band map differs, so every layer below works on rectangular rows.

Only the state-selected encoding reaches the stream, so the allocation
runs once per row on the selected SMRs with per-row band widths: kernel K1
with n_lines [R, B] (fixed rate), kernel K3 with n_lines [F, L, B] (VBR).
tac water-fills both encodings of every row and drops one; the bytes are
the same. Packing is kernel K2, the Huffman walk of the decoder kernel K4
behind the state-selected per-line widths.

Mid/side: the transient flags of a pair's two M/S channels are OR-ed, so
the pair shares one window state per frame, and the pair's rows allocate
jointly over their 2B state-selected bands (K1 with per-row widths [R/2,
2B]; K3 with per-frame widths [F, P, 2B], one lane per pair).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from tac_torch import bands, codec, consts
from tac_torch import bitstream as bs
from tac_torch import bitalloc as ba
from tac_torch import psy as psy_mod
from tac_torch import tracing
from tac_torch.codec import FrameCode
from tac_torch.config import CodecConfig, resolve_device
from tac_torch.consts import CodecConsts, PsyConsts
from tac_torch.dsp import mdct as fb
from tac_torch.dsp.window import sine_window, transition_windows, window_fn
from tac_torch.ops import row_gemm as k6
from tac_torch.ops.bitpack import pack_rows
from tac_torch.ops.huffdec import huffman_decode_sets

LONG, START, SHORT, STOP = 0, 1, 2, 3
EPS = 1e-12

# Float array leaves of BsConsts, named as in tac's BsConsts.
BS_LEAVES = ("state_windows", "state_gain", "short_window", "fwd_long",
             "inv_long", "fwd_short", "inv_short")


class BsConsts(NamedTuple):
    """Constants of the block-switching pipeline on one device
    (tac/blockswitch.py:BsConsts)."""
    state_windows: torch.Tensor  # [4, N] long / start / (unused) / stop
    state_gain: torch.Tensor     # [4] psy MDCT gain 8/mean(w^2) per state
    short_window: torch.Tensor   # [2*Hs]
    fwd_long: torch.Tensor       # [N, H] unwindowed cosine basis
    inv_long: torch.Tensor       # [H, N]
    fwd_short: torch.Tensor      # [2*Hs, Hs] short basis, window fused
    inv_short: torch.Tensor      # [Hs, 2*Hs]
    sub_idx: torch.Tensor        # [K, 2*Hs] int64 frame-local sub-block gather
    cl: CodecConsts              # long-side consts (the shared budget inside)
    cg: CodecConsts              # grouped-short consts: band map tiled K times
    psy_short: Optional[PsyConsts]
    h3: int                      # (H - Hs) / 2: where the first sub-block starts
    k: int                       # sub-blocks per frame


class BsFrameCode(NamedTuple):
    """Both encodings of frames; `state` picks at serialisation time."""
    state: torch.Tensor          # [...] int32 window state
    long: FrameCode
    short: FrameCode             # grouped: mant = flattened [K*Hs] = [H]


def _short_cfg(cfg: CodecConfig) -> CodecConfig:
    return cfg.replace(n_mdct_lines=cfg.n_mdct_lines_short)


def bs_host_arrays(cfg: CodecConfig) -> dict:
    """The config's block-switching constants in NumPy
    (tac/blockswitch.py:make_bs_consts): BS_LEAVES and "sub_idx" at the top
    level, the long config's arrays (``consts.host_arrays``) under "cl",
    the grouped band map under "cg_band_of_line" / "cg_n_lines", and the
    short transform's psy arrays under "psy_short"."""
    h, hs = cfg.n_mdct_lines, cfg.n_mdct_lines_short
    n, k, h3 = 2 * h, h // hs, (h - hs) // 2
    dt = np.float64 if cfg.precision == "parity" else np.float32
    wl = window_fn(cfg.window, n, cfg.kbd_alpha)
    wstart, wstop = transition_windows(n, 2 * hs, cfg.window, cfg.kbd_alpha)
    ws = sine_window(2 * hs)
    state_w = np.stack([wl, wstart, wl, wstop])      # SHORT slot unused
    scfg = _short_cfg(cfg)
    return {
        "state_windows": state_w.astype(dt),
        "state_gain": (8.0 / np.mean(state_w ** 2, axis=1)).astype(dt),
        "short_window": ws.astype(dt),
        "fwd_long": fb.mdct_basis(h, None, np.float64).astype(dt),
        "inv_long": fb.imdct_basis(h, None, np.float64).astype(dt),
        "fwd_short": fb.mdct_basis(hs, ws, np.float64).astype(dt),
        "inv_short": fb.imdct_basis(hs, ws, np.float64).astype(dt),
        "sub_idx": (h3 + np.arange(k)[:, None] * hs
                    + np.arange(2 * hs)[None, :]).astype(np.int32),
        "cl": consts.host_arrays(cfg),
        "cg_band_of_line": np.tile(bands.band_of_line(cfg.sample_rate, hs), k),
        "cg_n_lines": k * bands.lines_per_band(cfg.sample_rate, hs),
        "psy_short": consts.psy_host_arrays(scfg) if cfg.use_psy else None,
    }


def bs_consts_from_numpy(cfg: CodecConfig, arrays: dict, device) -> BsConsts:
    """Upload a set of block-switching constant arrays (see
    ``bs_host_arrays``; the port's own or the JAX package's, leaf for leaf)
    to `device`."""
    dev = torch.device(device)
    h, hs = cfg.n_mdct_lines, cfg.n_mdct_lines_short
    cl = consts.consts_from_numpy(cfg, arrays["cl"], dev)
    ranges_s = bands.band_line_ranges(cfg.sample_rate, hs)
    cg = cl._replace(
        band_of_line=torch.tensor(np.asarray(arrays["cg_band_of_line"]),
                                  dtype=torch.int64, device=dev),
        n_lines=torch.tensor(np.asarray(arrays["cg_n_lines"]),
                             dtype=torch.int32, device=dev),
        band_ranges=ranges_s,
        band_edges=torch.tensor(ranges_s, dtype=torch.int64, device=dev).T
        .contiguous(),
        band_tile=h // hs,
        window=torch.tensor(np.asarray(arrays["short_window"]), dtype=cl.dtype,
                            device=dev))
    psy_short = None
    if arrays.get("psy_short") is not None:
        psy_short = consts.psy_from_numpy(_short_cfg(cfg), arrays["psy_short"],
                                          dev)
    leaves = {name: torch.tensor(np.asarray(arrays[name]), dtype=cl.dtype,
                                 device=dev) for name in BS_LEAVES}
    return BsConsts(
        sub_idx=torch.tensor(np.asarray(arrays["sub_idx"]), dtype=torch.int64,
                             device=dev),
        cl=cl, cg=cg, psy_short=psy_short, h3=(h - hs) // 2, k=h // hs,
        **leaves)


@functools.lru_cache(maxsize=8)
def make_bs_consts(cfg: CodecConfig, device: torch.device) -> BsConsts:
    """The config's block-switching constants on `device`, cached per
    (config, device) like ``codec.make_consts``; never written."""
    return bs_consts_from_numpy(cfg, bs_host_arrays(cfg), device)


# -------------------------------------------------------------- detection ---

def transient_flags(x: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """x [..., T] → bool [..., Kb] per unpadded half-block (SPEC.md §9): the
    first-difference energy in eight segments of the half-block, flagged
    when a segment carries transient_ratio times its predecessor's energy
    and more than transient_energy_min."""
    h = cfg.n_mdct_lines
    t = x.shape[-1]
    kb = -(-t // h)
    blocks = torch.nn.functional.pad(x, (0, kb * h - t)).reshape(
        *x.shape[:-1], kb, h)
    d2 = torch.square(torch.diff(blocks, dim=-1))        # [..., Kb, H-1]
    # the prefix sums at the nine segment edges (through K7 in fast
    # precision), left to right as one cumsum would add them
    edges = np.round(np.arange(9) * (h - 1) / 8).astype(int)
    cum = psy_mod.band_slice_sum(d2, tuple((0, int(e)) for e in edges))
    e = cum[..., 1:] - cum[..., :-1]                     # [..., Kb, 8]
    ratio = e[..., 1:] / torch.clamp(e[..., :-1], min=EPS)
    return ((ratio.amax(-1) > cfg.transient_ratio)
            & (e[..., 1:].amax(-1) > cfg.transient_energy_min))


def window_states(t_flags: torch.Tensor, f: int) -> torch.Tensor:
    """t_flags bool [..., Kb] → int32 [..., F] window states by neighbour
    logic (SPEC.md §9): a frame wants SHORT when either of its half-blocks
    is flagged; a frame between two such frames goes SHORT too; START
    precedes and STOP follows a SHORT run."""
    kb = t_flags.shape[-1]
    pad = torch.nn.functional.pad
    tp = pad(t_flags, (1, max(f - kb, 1)))               # t[-1], t[>=Kb] = 0
    want = tp[..., :f] | tp[..., 1:f + 1]                # want[i] = t[i-1]|t[i]
    wprev = pad(want, (1, 0))[..., :f]
    wnext = pad(want, (0, 1))[..., 1:]
    return _states(want, wprev, wnext)


def _states(want, want_prev, want_next) -> torch.Tensor:
    """Each frame's state from its own SHORT want and its neighbours'."""
    short = want | (want_prev & want_next)
    start = ~short & want_next
    stop = ~short & ~start & want_prev
    out = torch.full(short.shape, LONG, dtype=torch.int32, device=short.device)
    out = torch.where(stop, STOP, out)
    out = torch.where(start, START, out)
    return torch.where(short, SHORT, out)


def stream_states(t: torch.Tensor, m: int) -> torch.Tensor:
    """Window states int32 [..., m] of m streaming frames from the carried
    and new transient flags t = (t_{e-2}, ..., t_{e+m}) bool [..., m+3], e
    the first frame's index (tac/blockswitch.py:_stream_states): the
    neighbour logic of ``window_states``, read out of the history."""
    tm2, tm1 = t[..., 0:m], t[..., 1:m + 1]
    t0, tp1 = t[..., 2:m + 2], t[..., 3:m + 3]
    return _states(tm1 | t0, tm2 | tm1, t0 | tp1)


# ----------------------------------------------------------------- encode ---

def analyze_frame_bs(frames: torch.Tensor, state: torch.Tensor,
                     cfg: CodecConfig, c: BsConsts):
    """frames [R, N] (unwindowed), state int [R] → the budget-independent
    analysis: (long lines [R, H], long smr [R, B], grouped-short lines
    [R, K*Hs], short smr [R, B])."""
    r = frames.shape[0]
    st = state.long()
    with tracing.span("tac.codec.analysis"):
        xw = frames * c.state_windows[st]
        if cfg.precision == "parity":
            lines_l = fb.mdct_fft(xw, cfg.n_mdct_lines)
        else:
            lines_l = k6.row_matmul(xw, c.fwd_long)
        sub = frames[:, c.sub_idx]                       # [R, K, 2Hs]
        if cfg.precision == "parity":
            lines_s = fb.mdct_fft(sub * c.short_window,
                                  cfg.n_mdct_lines_short)
        else:
            lines_s = k6.row_matmul(sub, c.fwd_short)
    with tracing.span("tac.codec.psy"):
        if cfg.use_psy:
            smr_l = psy_mod.calc_smrs(frames, lines_l, c.cl.psy,
                                      mdct_gain=c.state_gain[st])
            # the group shares one allocation: each band's worst sub-block
            smr_s = psy_mod.calc_smrs(sub, lines_s, c.psy_short).amax(-2)
        else:
            smr_l = torch.zeros((r, bands.N_BANDS), dtype=c.cl.dtype,
                                device=frames.device)
            smr_s = torch.zeros_like(smr_l)
    return lines_l, smr_l, lines_s.reshape(r, -1), smr_s


def select_by_state(state: torch.Tensor, long: torch.Tensor,
                    short: torch.Tensor) -> torch.Tensor:
    """The grouped-short value on SHORT rows, the long one elsewhere; state
    [...] broadcasts over the trailing axes of long / short."""
    is_short = (state == SHORT).reshape(state.shape
                                        + (1,) * (long.dim() - state.dim()))
    return torch.where(is_short, short, long)


def state_n_lines(state: torch.Tensor, c: BsConsts) -> torch.Tensor:
    """Per-row band widths int32 [..., B]: grouped-short on SHORT rows."""
    return torch.where((state == SHORT)[..., None], c.cg.n_lines,
                       c.cl.n_lines).contiguous()


def quantize_both(lines_l, lines_s, alloc, state, cfg: CodecConfig,
                  c: BsConsts) -> BsFrameCode:
    """Quantize both encodings at one allocation [R, B] (the state-selected
    encoding's; the other is never serialised)."""
    with tracing.span("tac.codec.quant"):
        return BsFrameCode(
            state=state.to(torch.int32),
            long=codec.quantize_given_alloc(lines_l, alloc, cfg, c.cl),
            short=codec.quantize_given_alloc(lines_s, alloc, cfg, c.cg))


def encode_frame_bs(frames: torch.Tensor, state: torch.Tensor,
                    cfg: CodecConfig, c: BsConsts) -> BsFrameCode:
    """frames [R, N] (unwindowed), state int [R] → both encodings, at the
    fixed per-frame budget: one allocation per row on the state-selected
    SMRs and band widths (K1 with per-row n_lines in fast precision, the
    plain f64 loop in parity; jointly per M/S pair of rows)."""
    lines_l, smr_l, lines_s, smr_s = analyze_frame_bs(frames, state, cfg, c)
    alloc = codec.allocate_rows(select_by_state(state, smr_l, smr_s), cfg,
                                c.cl, state_n_lines(state, c))
    return quantize_both(lines_l, lines_s, alloc, state, cfg, c)


def decode_frame_bs(bc: BsFrameCode, cfg: CodecConfig, c: BsConsts):
    """BsFrameCode [R, ...] → [R, N] windowed output (pre-overlap-add)."""
    h, hs = cfg.n_mdct_lines, cfg.n_mdct_lines_short
    lines_l = codec.dequantize_lines(bc.long, cfg, c.cl)
    w = c.state_windows[bc.state.long()]
    if cfg.precision == "parity":
        y_long = fb.imdct_fft(lines_l, h) * w
    else:
        y_long = (lines_l @ c.inv_long) * w
    lines_s = codec.dequantize_lines(bc.short, cfg, c.cg).reshape(-1, c.k, hs)
    if cfg.precision == "parity":
        y_sub = fb.imdct_fft(lines_s, hs) * c.short_window
    else:
        y_sub = lines_s @ c.inv_short                    # [R, K, 2Hs]
    # 50 %-hop sub-blocks: shifted half sums, then h3 zeros on either side
    # (every sample gets at most two contributions)
    first, second = y_sub[..., :hs], y_sub[..., hs:]
    zero = torch.zeros_like(first[..., :1, :])
    acc = (torch.cat([first, zero], dim=-2)
           + torch.cat([zero, second], dim=-2))          # [R, K+1, Hs]
    y_short = torch.nn.functional.pad(acc.reshape(acc.shape[0], -1),
                                      (c.h3, c.h3))
    return select_by_state(bc.state, y_long, y_short)


# ---------------------------------------------------------- serialisation ---

def state_m_line(state, alloc_code, c: BsConsts) -> torch.Tensor:
    """Per-line mantissa widths int32 [..., H] of allocation codes
    [..., B] under each row's state-selected line→band map."""
    alloc = ba.code_to_alloc(alloc_code)
    return select_by_state(
        state, torch.index_select(alloc, -1, c.cl.band_of_line),
        torch.index_select(alloc, -1, c.cg.band_of_line)).contiguous()


def select_code_bs(bc: BsFrameCode, c: BsConsts):
    """The state-picked encoding: (FrameCode, m_line int32 [..., H])."""
    code = FrameCode(*(select_by_state(bc.state, l_, s_)
                       for l_, s_ in zip(bc.long, bc.short)))
    return code, state_m_line(bc.state, code.alloc_code, c)


def _with_state(state, vals, wids):
    st = state.to(torch.int32)[..., None]
    return (torch.cat([st, vals], dim=-1),
            torch.cat([torch.full_like(st, 2), wids], dim=-1))


def payload_fields_bs(bc: BsFrameCode, cfg: CodecConfig, c: BsConsts):
    """(vals, wids) per SPEC.md §9: 2-bit state, then the §7 raw fields of
    the state-selected encoding. Leaves [..., NF], NF = 2+2B+H."""
    code, m_line = select_code_bs(bc, c)
    return _with_state(bc.state,
                       *codec.payload_fields(code, cfg, c.cl, m_line))


def payload_fields_bs_vbr(bc: BsFrameCode, tid, cfg: CodecConfig, c: BsConsts):
    """(vals, wids) of the Huffman combo, SPEC.md §7 order: 2-bit state |
    ovs | 2-bit tableId | alloc codes | scale factors | Huffman-or-raw
    mantissa pairs, of the state-selected encoding. NF = 3+2B+2H."""
    code, m_line = select_code_bs(bc, c)
    return _with_state(bc.state,
                       *codec.payload_fields_vbr(code, tid, cfg, c.cl, m_line))


def _head_bits(cfg: CodecConfig) -> int:
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    return 2 + s + bands.N_BANDS * (a + s)


def _row_budget(cfg: CodecConfig) -> int:
    """The most mantissa bits one row may take at a fixed budget: the
    channel's budget, or its pair's under joint M/S allocation."""
    return consts.frame_budget(cfg) * (2 if cfg.stereo_mode == "ms" else 1)


def capacity_bits_bs(cfg: CodecConfig) -> int:
    """Payload capacity per (block, channel) of a block-switch stream, in
    bits. Host arithmetic only: decode staging needs no constants."""
    return _head_bits(cfg) + _row_budget(cfg) + 32


def capacity_bits_bs_vbr(cfg: CodecConfig) -> int:
    """Capacity of a combo row: the head with its tableId, the budget with a
    full reservoir on top, a word of slack."""
    return (_head_bits(cfg) + 2
            + _row_budget(cfg) * (1 + cfg.reservoir_factor) + 32)


# ---------------------------------------------------- framing, fixed rate ---

def _frames_and_states(x, cfg: CodecConfig, c: BsConsts, dev):
    """x [..., C, T] → (frames f[..., C, F, N], states int32 [..., C, F]).
    Under M/S the frames are of the butterflied signal, and each channel
    takes its pair's state: the window states of the OR of the pair's
    transient flags."""
    xt = codec.input_signal(x, cfg, c.cl.dtype, dev)
    frames = fb.frame_signal(xt, cfg.n_mdct_lines)
    flags = transient_flags(xt, cfg)                     # [..., C, Kb]
    if cfg.stereo_mode != "ms":
        return frames, window_states(flags, frames.shape[-2])
    fp = flags.reshape(*flags.shape[:-2], -1, 2, flags.shape[-1])
    states = window_states(fp[..., 0, :] | fp[..., 1, :], frames.shape[-2])
    return frames, states.repeat_interleave(2, dim=-2)


def ms_stream_prep(seq, t_hist, cfg: CodecConfig, c: BsConsts):
    """The streaming framing of the block-switch families, the front half
    of their streaming core (tac/blockswitch.py:_ms_stream_prep, and its L/R
    form).

    With e the next frame to emit and h_j the half-block of samples
    [jH, (j+1)H): seq [C, m+2, H] = (h_{e-1}, h_e, h_{e+1..e+m}), the prior
    half, the lookahead and m new halves (L/R, in the codec's float type),
    and t_hist bool [L, 2] = (t_{e-2}, t_{e-1}) per channel, or per pair
    under M/S, each on the host or on c's device → (frames f[C, m, N] of
    frame j = [h_{j-1} | h_j], butterflied under M/S; states int32 [C, m],
    a pair's two channels sharing the state of their OR-ed flags; t bool
    [L, m+3] = (t_{e-2}, ..., t_{e+m}), whose columns m and m+1 are the
    next t_hist)."""
    dev = c.cl.window.device
    seq = tracing.upload(seq, dev)
    ch, m = seq.shape[0], seq.shape[1] - 2
    ms = cfg.stereo_mode == "ms"
    if ms:
        seq = codec.ms_forward(seq.reshape(ch, -1)).reshape(seq.shape)
    frames = torch.cat([seq[:, :m], seq[:, 1:m + 1]], dim=-1)
    flags = transient_flags(seq[:, 1:].reshape(ch, -1), cfg)   # t_{e..e+m}
    if ms:
        flags = flags[0::2] | flags[1::2]
    t = torch.cat([tracing.upload(t_hist, dev), flags], dim=1)
    states = stream_states(t, m)
    return frames, (states.repeat_interleave(2, dim=0) if ms else states), t


def lane_states(states: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """Per-channel states int32 [..., C, F] → [L, F], one per reservoir lane
    of ``codec.to_lanes`` (an M/S pair's two rows share their state)."""
    return codec.to_lanes(states[..., None], cfg)[:, :, 0, 0]


def encode_frames_bs(frames, states, cfg: CodecConfig, c: BsConsts):
    """frames f[..., C, F, N] (of the butterflied signal under M/S), states
    int32 [..., C, F] → (words int32 [..., C, F, W32] holding 32-bit
    patterns, nbits int64 [..., C, F]). All leading axes flatten into one
    row axis, coded in chunks of codec.ENC_CHUNK rows; mid/side orders the
    rows frame-major so that each pair's rows are adjacent (an even
    chunk)."""
    ms = cfg.stereo_mode == "ms"
    if ms:
        frames, states = frames.transpose(-3, -2), states.transpose(-2, -1)
    lead = frames.shape[:-1]
    cap = capacity_bits_bs(cfg)
    chunk = codec.even_chunk(cfg)
    words, nbits = [], []
    for fr, st in zip(frames.reshape(-1, frames.shape[-1]).split(chunk),
                      states.reshape(-1).split(chunk)):
        bc = encode_frame_bs(fr, st, cfg, c)
        with tracing.span("tac.codec.pack"):
            w, n = pack_rows(*payload_fields_bs(bc, cfg, c), cap)
        words.append(w)
        nbits.append(n)
    words = torch.cat(words).reshape(*lead, -1)
    nbits = torch.cat(nbits).reshape(lead)
    if ms:
        return (words.transpose(-3, -2).contiguous(),
                nbits.transpose(-2, -1).contiguous())
    return words, nbits


def _bs_code(state, ovs, alloc_code, sf, mant) -> BsFrameCode:
    fc = FrameCode(ovs=ovs, alloc_code=alloc_code, scale=sf, mant=mant)
    return BsFrameCode(state=state, long=fc, short=fc)


def _unpack_bs_fields(wf: torch.Tensor, cfg: CodecConfig,
                      c: BsConsts) -> BsFrameCode:
    """int32 [K, W32] block-switch payload rows → BsFrameCode [K, ...]
    (SPEC.md §9 layout); the decoded window state selects each row's
    line→band map."""
    pre, alloc_code, sf, mant_start = codec.read_head(wf, cfg,
                                                      (2, cfg.n_scale_bits))
    state = pre[:, 0]
    m_line = state_m_line(state, alloc_code, c)
    return _bs_code(state, pre[:, 1], alloc_code, sf,
                    codec.read_raw_mantissas(wf, mant_start, m_line))


def decode_frames_bs(words, cfg: CodecConfig, c: BsConsts):
    """words: int32 [..., W32] block-switch payload rows → [..., N]
    windowed frame audio, before the overlap-add."""
    return _decode_frames(words, cfg, c, _unpack_bs_fields)


def _decode_frames(words, cfg: CodecConfig, c: BsConsts, unpack):
    w = tracing.upload(words, c.cl.window.device)
    bc = unpack(w.reshape(-1, w.shape[-1]).contiguous(), cfg, c)
    return decode_frame_bs(bc, cfg, c).reshape(*w.shape[:-1], -1)


def encode_clip_bs(x, cfg: CodecConfig, device=None) -> BsFrameCode:
    """x: float [..., C, T] → BsFrameCode with [..., C, F, ...] leaves on
    `device` (CUDA unless named): tac/blockswitch.py:encode_clip_bs, L/R.
    Each encoding gets its own allocation on its own SMRs and band widths,
    as tac's; the state-selected one is what a stream carries (the stream
    path allocates only that one, ``encode_frame_bs``)."""
    dev = resolve_device(device)
    c = make_bs_consts(cfg, dev)
    xt = tracing.upload(x, dev).to(c.cl.dtype)
    frames = fb.frame_signal(xt, cfg.n_mdct_lines)
    states = window_states(transient_flags(xt, cfg), frames.shape[-2])

    def both(fr, st):
        lines_l, smr_l, lines_s, smr_s = analyze_frame_bs(fr, st, cfg, c)
        long_, short = (codec.quantize_given_alloc(
            lines, codec.allocate_rows(smr, cfg, cc), cfg, cc)
            for lines, smr, cc in ((lines_l, smr_l, c.cl),
                                   (lines_s, smr_s, c.cg)))
        return BsFrameCode(st.to(torch.int32), long_, short)

    parts = [both(fr, st) for fr, st in zip(
        frames.reshape(-1, frames.shape[-1]).split(codec.ENC_CHUNK),
        states.reshape(-1).split(codec.ENC_CHUNK))]
    return codec._leaves(parts, frames.shape[:-1])


def decode_clip_bs(bc: BsFrameCode, cfg: CodecConfig, t: int, device=None):
    """BsFrameCode [..., C, F, ...] → [..., C, T] audio on `device` (CUDA
    unless named): tac/blockswitch.py:decode_clip_bs."""
    c = make_bs_consts(cfg, resolve_device(device))
    dev = c.cl.window.device
    up = [torch.as_tensor(v).to(dev) for v in (bc.state, *bc.long, *bc.short)]
    bc = BsFrameCode(up[0], FrameCode(*up[1:5]), FrameCode(*up[5:]))
    lead = bc.state.shape
    flat = BsFrameCode(bc.state.reshape(-1), *(
        FrameCode(*(v.reshape(-1, *v.shape[len(lead):]) for v in fc))
        for fc in (bc.long, bc.short)))
    y = decode_frame_bs(flat, cfg, c).reshape(*lead, -1)
    return fb.overlap_add(y, cfg.n_mdct_lines, t)


def payload_to_frames_bs(data: bytes, offset: int, n_blocks: int,
                         cfg: CodecConfig, device=None) -> BsFrameCode:
    """Host deserializer of the block-switch layout (SPEC.md §9;
    tac/blockswitch.py:payload_to_frames_bs): the fields are the raw
    layout's behind a 2-bit state, which picks each row's line→band map.
    A BsFrameCode with int32 [C, F, ...] leaves on `device` (CUDA unless
    named), the parsed encoding as both long and short."""
    dev = resolve_device(device)
    h, hs = cfg.n_mdct_lines, cfg.n_mdct_lines_short
    ch = cfg.n_channels
    bits, pre, alloc_code, alloc, sf, start = bs.parse_head(
        data, offset, n_blocks * ch, cfg, (2, cfg.n_scale_bits))
    state = pre[:, 0]
    bol = np.where((state == SHORT)[:, None],
                   np.tile(bands.band_of_line(cfg.sample_rate, hs), h // hs),
                   bands.band_of_line(cfg.sample_rate, h))
    m_line = np.take_along_axis(alloc, bol, axis=1).astype(np.int64)
    mant = bs.read_raw_lines(bits, start, m_line)
    st, ovs, ac, sfs, mt = (bs.from_rows(v, n_blocks, ch, dev) for v in
                            (state, pre[:, 1], alloc_code, sf, mant))
    fc = FrameCode(ovs=ovs, alloc_code=ac, scale=sfs, mant=mt)
    return BsFrameCode(state=st, long=fc, short=fc)


# ------------------------------------------------ Huffman × block switching ---

def _bs_vbr_phase1(frames, states, cfg: CodecConfig, c: BsConsts):
    """Phase 1 of the combo encode over all lanes, in row chunks: both
    analyses, the Huffman band costs under both band maps, and the state
    select. frames f[L, F, K, N] (``codec.to_lanes``), states int32 [L, F]
    (one per lane and frame, shared by its K rows) → (long lines
    [L·F·K, H], short lines [L·F·K, H], smr f[F, L, K·B], bits_huf int32
    [F, L, K·B, 7·S]); the last two ``codec.frame_major``."""
    lanes, f, k = frames.shape[:3]
    rows = frames.reshape(-1, frames.shape[-1])
    parts = []
    for fr, st in zip(rows.split(codec.ENC_CHUNK),
                      states.repeat_interleave(k).split(codec.ENC_CHUNK)):
        ll, sl, ls, ss = analyze_frame_bs(fr, st, cfg, c)
        bh = select_by_state(st, codec._vbr_band_costs(ll, cfg, c.cl),
                             codec._vbr_band_costs(ls, cfg, c.cg))
        parts.append((ll, ls, select_by_state(st, sl, ss), bh))
    ll, ls, smr, bh = (torch.cat(p) for p in zip(*parts))
    return (ll, ls, codec.frame_major(smr, lanes, f),
            codec.frame_major(bh, lanes, f))


def _encode_bs_vbr_lanes_to_words(frames, states, res0, cfg: CodecConfig,
                                  c: BsConsts):
    """Combo encode over independent lanes. frames f[L, F, K, N], states
    int32 [L, F], res0 int32 [L] → (words int32 [L, F, K, W32], nbits int64
    [L, F, K], res int32 [L, F]: the fill after every frame). Phase 2 is
    the reservoir chain (K3) on the state-selected SMRs and costs with
    per-frame band widths [F, L, K·B] and base K·budget (an M/S pair's
    joint chain at K = 2); phase 3 (quantize at the chain's allocations,
    fields, pack) runs per row chunk."""
    lanes, f, k = frames.shape[:3]
    cap = capacity_bits_bs_vbr(cfg)
    ll, ls, smr, bh = _bs_vbr_phase1(frames, states, cfg, c)
    allocs, tids, _, ress = codec._reservoir_chain(
        smr, bh, state_n_lines(states.transpose(0, 1), c).repeat(1, 1, k),
        res0, k * c.cl.budget, cfg.reservoir_factor * k * c.cl.budget, cfg)
    del smr, bh
    rows = (ll, ls, *codec.rows_of_chain(allocs, tids, k),
            states.repeat_interleave(k))
    words, nbits = [], []
    for l1, l2, al, td, st in zip(*(r.split(codec.ENC_CHUNK) for r in rows)):
        bc = quantize_both(l1, l2, al, st, cfg, c)
        with tracing.span("tac.codec.pack"):
            w, n = pack_rows(*payload_fields_bs_vbr(bc, td, cfg, c), cap)
        words.append(w)
        nbits.append(n)
    return (torch.cat(words).reshape(lanes, f, k, -1),
            torch.cat(nbits).reshape(lanes, f, k), ress.transpose(0, 1))


def encode_frames_bs_vbr(frames, states, res0, cfg: CodecConfig,
                         c: BsConsts):
    """frames f[..., C, F, N] (butterflied under M/S), states int32
    [..., C, F], res0 int32 [L] → (words int32 [..., C, F, W32], nbits
    int64 [..., C, F], res int32 [L, F]): every channel (or M/S pair) its
    own reservoir lane, resumed from its fill."""
    words, nbits, ress = _encode_bs_vbr_lanes_to_words(
        codec.to_lanes(frames, cfg), lane_states(states, cfg), res0, cfg, c)
    lead = frames.shape[:-2]                             # [..., C]
    return codec.from_lanes(words, lead), codec.from_lanes(nbits, lead), ress


def _bs_vbr_head(wf: torch.Tensor, cfg: CodecConfig, c: BsConsts):
    """The head of int32 [K, W32] combo rows → (state, ovs, tid [K],
    alloc_code, scale [K, B], m_line int32 [K, H] under the row's state,
    mant_start int32 [K])."""
    pre, alloc_code, sf, mant_start = codec.read_head(
        wf, cfg, (2, cfg.n_scale_bits, 2))
    state = pre[:, 0]
    return (state, pre[:, 1], pre[:, 2].contiguous(), alloc_code, sf,
            state_m_line(state, alloc_code, c),
            mant_start[:, 0].to(torch.int32))


def _unpack_bs_vbr_fields(wf: torch.Tensor, cfg: CodecConfig,
                          c: BsConsts) -> BsFrameCode:
    """int32 [K, W32] combo payload rows → BsFrameCode [K, ...]: raw rows by
    cumsum-offset gathers, Huffman rows by the decode walk (K4), the band
    map per row by state."""
    state, ovs, tid, alloc_code, sf, m_line, mant_start = _bs_vbr_head(wf, cfg, c)
    mant_raw = codec.read_raw_mantissas(wf, mant_start[:, None], m_line)
    mant = huffman_decode_sets(wf, mant_start, m_line, tid, mant_raw,
                               c.cl.huff)
    return _bs_code(state, ovs, alloc_code, sf, mant)


def decode_frames_bs_vbr(words, cfg: CodecConfig, c: BsConsts):
    """words: int32 [..., W32] combo payload rows → [..., N] windowed frame
    audio, before the overlap-add."""
    return _decode_frames(words, cfg, c, _unpack_bs_vbr_fields)
