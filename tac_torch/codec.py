"""Codec core: encode to payload words and decode back, fixed-rate and
Huffman VBR, L/R or mid/side (counterpart of those parts of tac/codec.py,
SPEC.md §4–§8, §11).

Fixed-rate encode: frame → window-fused MDCT (matmul; FFT in parity) → psy
SMRs → bit allocation → quantize → payload fields → bit pack, in row chunks
of ENC_CHUNK frames. Decode: read fields → dequantize → IMDCT → overlap-add.
Every frame row is independent, so all leading axes (clips, channels,
frames) flatten into one row axis.

VBR encode (SPEC.md §8) has three phases. Phase 1, in row chunks: analysis
plus, per band, the Huffman-coded cost at every codable allocation 2..8
under each trained table set — all budget-free. Phase 2: the bit-reservoir
chain, the one serial axis, every channel a lane and all frames in one
call. Phase 3, in row chunks: quantize at the chain's allocations, build
the Huffman-or-raw fields, pack. VBR decode reads the head fields, then
the mantissas raw by cumsum offsets or by the serial Huffman walk per set.

Mid/side (SPEC.md §11) butterflies each adjacent channel pair before
framing and undoes it after overlap-add. The pair's two rows (mid, side)
of a frame are coded jointly: one water-fill over their concatenated 2B
bands with 2·budget (fixed rate), one reservoir lane per pair over 2B
bands with base 2·budget and one tableId for both rows (VBR). The
per-channel payload layout is unchanged.

On a CUDA device, fast precision allocates with kernel K1 (fixed-rate) or
runs the reservoir chain as kernel K3 (VBR), packs with kernel K2 and walks
Huffman rows with kernel K4. Parity precision allocates with the plain f64
loops (as tac gates its kernels at codec.py:235-248); its packing and
Huffman walk go through K2 and K4, which are integer-exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tac_torch import bands, quant
from tac_torch import bitalloc as ba
from tac_torch import consts
from tac_torch import huffman as hf
from tac_torch import psy as psy_mod
from tac_torch.config import CodecConfig, resolve_device
from tac_torch.consts import CodecConsts, frame_budget  # noqa: F401
from tac_torch.dsp import mdct as fb
from tac_torch.ops.alloc import water_fill_rows
from tac_torch.ops.bitpack import pack_rows
from tac_torch.ops.bitunpack import read_fields
from tac_torch.ops.huffdec import huffman_decode_sets
from tac_torch.ops.vbr_scan import (vbr_reservoir_scan,
                                    vbr_reservoir_scan_plain)

# Frame rows per encode chunk: bounds the psy and packer temporaries
# (the [rows, NF] field matrices) independently of the batch size.
ENC_CHUNK = 2048


@functools.lru_cache(maxsize=16)
def make_consts(cfg: CodecConfig, device: torch.device) -> CodecConsts:
    """The config's codec constants on `device` (tac/codec.py:make_consts).
    Cached per (config, device): building the bases on the host and
    uploading them would otherwise cost more than a batch's encode. The
    tensors are shared between callers and are never written."""
    return consts.consts_from_numpy(cfg, consts.host_arrays(cfg), device)


def ms_forward(x: torch.Tensor) -> torch.Tensor:
    """[..., C, T] (C even) L/R → M/S per adjacent channel pair
    (tac/codec.py:ms_forward): M = (L+R)/2, S = (L−R)/2."""
    ev, od = x[..., 0::2, :], x[..., 1::2, :]
    m = 0.5 * (ev + od)
    s = 0.5 * (ev - od)
    return torch.stack([m, s], dim=-2).reshape(x.shape)


def ms_inverse(x: torch.Tensor) -> torch.Tensor:
    """[..., C, T] (C even) M/S → L/R per pair: L = M + S, R = M − S."""
    m, s = x[..., 0::2, :], x[..., 1::2, :]
    return torch.stack([m + s, m - s], dim=-2).reshape(x.shape)


def output_signal(y: torch.Tensor, cfg: CodecConfig, t: int):
    """Decoded frames [..., C, F, N] → [..., C, T] audio: overlap-add, then
    the inverse butterfly of a mid/side stream."""
    out = fb.overlap_add(y, cfg.n_mdct_lines, t)
    return ms_inverse(out) if cfg.stereo_mode == "ms" else out


class FrameCode(NamedTuple):
    """Quantized representation of frames — the parity surface (SPEC §10)."""
    ovs: torch.Tensor         # [...] int32 overall scale factor
    alloc_code: torch.Tensor  # [..., N_BANDS] int32 (0 ⇔ no bits, else alloc-1)
    scale: torch.Tensor       # [..., N_BANDS] int32 (0 where alloc_code == 0)
    mant: torch.Tensor        # [..., H] int32 line mantissas (0 where no bits)


def _band_max(x: torch.Tensor, c: CodecConsts, fill) -> torch.Tensor:
    """Per-band max of x[..., H] → [..., N_BANDS]. Grouped-short consts
    (band_tile = K sub-blocks, the short band map tiled K times) reduce
    each sub-block's bands, then over the K sub-blocks."""
    if c.band_tile == 1:
        return psy_mod.band_slice_max(x, c.band_ranges, fill)
    xs = x.reshape(*x.shape[:-1], c.band_tile, -1)
    return psy_mod.band_slice_max(xs, c.band_ranges, fill).amax(-2)


def _smr_input(frames, lines, cfg: CodecConfig, c: CodecConsts):
    """What drives bit allocation (SPEC §5/§6; the four BitAlloc modes)."""
    if cfg.use_psy and cfg.alloc_mode in ("greedy", "const_mnr"):
        return psy_mod.calc_smrs(frames, lines, c.psy)
    if cfg.alloc_mode == "const_snr":
        spl = psy_mod.spl_from_intensity(c.mdct_gain * lines * lines)
        return _band_max(spl, c, float("-inf"))
    return torch.zeros(*lines.shape[:-1], bands.N_BANDS, dtype=c.dtype,
                       device=lines.device)       # uniform


def analyze_frame(frames: torch.Tensor, cfg: CodecConfig, c: CodecConsts):
    """frames [..., N] (unwindowed) → (mdct lines [..., H], smr [..., B])."""
    if cfg.precision == "parity":
        lines = fb.mdct_fft(frames * c.window, c.window.shape[0] // 2)
    else:
        lines = frames @ c.fwd_basis
    return lines, _smr_input(frames, lines, cfg, c)


def water_fill_alloc(smr: torch.Tensor, n_lines: torch.Tensor, budget: int,
                     cfg: CodecConfig) -> torch.Tensor:
    """smr [R, B], band widths int32 [B] (shared) or [R, B] (per row) and
    one budget for every row → alloc int32 [R, B]. Fast precision runs K1
    (its plain version for CPU tensors); parity keeps the plain f64 loop."""
    if cfg.precision == "parity":
        return ba.allocate(smr, n_lines, budget, cfg.alloc_mode,
                           cfg.max_mant_bits)
    smr_eff = torch.zeros_like(smr) if cfg.alloc_mode == "uniform" else smr
    smr_q = ba.snap_smr(smr_eff).to(torch.float32).contiguous()
    budgets = torch.full(smr_q.shape[:1], budget, dtype=torch.int32,
                         device=smr_q.device)
    return water_fill_rows(smr_q, n_lines.contiguous(), budgets,
                           max_mant=cfg.max_mant_bits)


def joint_alloc_pair_rows(smr: torch.Tensor, n_lines: torch.Tensor,
                          budget: int, cfg: CodecConfig) -> torch.Tensor:
    """Joint M/S allocation over pair-adjacent rows (SPEC.md §11;
    tac/codec.py:_joint_alloc_pair_rows).

    smr [M, B] with row 2i the mid and 2i+1 the side of one frame; n_lines
    int32 [B] shared or [M, B] per row (a pair's two rows carry the same
    map) → alloc int32 [M, B]: one water-fill per pair over the
    concatenated 2B bands, mid's first (the tie order), sharing 2·budget."""
    m, nb = smr.shape
    nl2 = (n_lines.reshape(m // 2, 2 * nb) if n_lines.dim() == 2
           else torch.cat([n_lines, n_lines]))
    return water_fill_alloc(smr.reshape(m // 2, 2 * nb), nl2, 2 * budget,
                            cfg).reshape(m, nb)


def allocate_rows(smr: torch.Tensor, cfg: CodecConfig, c: CodecConsts,
                  n_lines: torch.Tensor | None = None) -> torch.Tensor:
    """smr [R, B] → alloc int32 [R, B] at c's budget and band widths
    (n_lines int32 [R, B] overrides them: the block-switch state-selected
    maps): per row, or under M/S jointly per pair of adjacent rows (mid,
    side) at 2·budget."""
    nl = c.n_lines if n_lines is None else n_lines
    if cfg.stereo_mode == "ms":
        return joint_alloc_pair_rows(smr, nl, c.budget, cfg)
    return water_fill_alloc(smr, nl, c.budget, cfg)


def quantize_given_alloc(lines: torch.Tensor, alloc: torch.Tensor,
                         cfg: CodecConfig, c: CodecConsts) -> FrameCode:
    """lines [..., H] + final per-band allocation [..., B] → FrameCode."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    ovs = quant.scale_factor(lines.abs().amax(-1), s, a)
    # 2^ovs is a power-of-two scale: exact in every float format (SPEC §10)
    scaled = lines * torch.exp2(ovs.to(lines.dtype))[..., None]
    band_max = _band_max(scaled.abs(), c, 0.0)
    band_max = torch.where(c.n_lines > 0, band_max, 0.0)
    sf = quant.scale_factor(band_max, s, alloc)
    sf = torch.where(alloc > 0, sf, 0)
    m_line = torch.index_select(alloc, -1, c.band_of_line)
    sf_line = torch.index_select(sf, -1, c.band_of_line)
    mant = quant.mantissa(scaled, sf_line, s, m_line)
    return FrameCode(ovs=ovs, alloc_code=ba.alloc_to_code(alloc),
                     scale=sf.to(torch.int32), mant=mant)


def dequantize_lines(code: FrameCode, cfg: CodecConfig, c: CodecConsts):
    """FrameCode [...] → MDCT lines [..., H] under c's line→band map."""
    alloc = ba.code_to_alloc(code.alloc_code)
    m_line = torch.index_select(alloc, -1, c.band_of_line)
    sf_line = torch.index_select(code.scale, -1, c.band_of_line)
    scaled = quant.dequantize_mantissa(code.mant, sf_line, cfg.n_scale_bits,
                                       m_line, c.dtype)
    return scaled * torch.exp2(-code.ovs.to(c.dtype))[..., None]


def decode_frame(code: FrameCode, cfg: CodecConfig, c: CodecConsts):
    """FrameCode [...] → [..., N] windowed time-domain output (pre-OLA)."""
    lines = dequantize_lines(code, cfg, c)
    if cfg.precision == "parity":
        return fb.imdct_fft(lines, lines.shape[-1]) * c.window
    return lines @ c.inv_basis


def payload_fields(code: FrameCode, cfg: CodecConfig, c: CodecConsts,
                   m_line=None):
    """(vals, wids) field matrices per SPEC.md §7 raw layout:
    ovs | B alloc codes | B scale factors (0-width where alloc=0) |
    H mantissas (width = band alloc). Leaves [..., NF], NF = 1+2B+H.
    m_line int32[..., H] overrides the per-line widths of c's band map (the
    block-switch state-selected map)."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    alloc = ba.code_to_alloc(code.alloc_code)
    if m_line is None:
        m_line = torch.index_select(alloc, -1, c.band_of_line)
    vals = torch.cat([code.ovs[..., None], code.alloc_code, code.scale,
                      code.mant], dim=-1)
    wids = torch.cat([torch.full_like(code.ovs[..., None], s),
                      torch.full_like(code.alloc_code, a),
                      torch.where(alloc > 0, s, 0).to(torch.int32), m_line],
                     dim=-1)
    return vals, wids


def payload_capacity_bits(cfg: CodecConfig, c: CodecConsts | None = None) -> int:
    """Payload capacity per (block, channel), in bits: the head, the
    mantissa budget (the pair's under M/S; with a full reservoir on top for
    VBR) and a word of slack."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    head = s + bands.N_BANDS * (a + s) + (2 if cfg.use_huffman else 0)
    budget = c.budget if c is not None else frame_budget(cfg)
    if cfg.stereo_mode == "ms":        # a joint pair may give one row all
        budget *= 2
    if cfg.use_huffman:
        budget *= 1 + cfg.reservoir_factor
    return head + budget + 32


def even_chunk(cfg: CodecConfig) -> int:
    """The encode's row chunk: ENC_CHUNK, rounded up to an even size under
    M/S, whose rows hold pairs adjacently, so that no pair splits."""
    return ENC_CHUNK + (ENC_CHUNK % 2 if cfg.stereo_mode == "ms" else 0)


def _encode_rows_to_words(frames: torch.Tensor, cfg: CodecConfig,
                          c: CodecConsts):
    """frames [R, N] → (words int32 [R, W32], nbits int64 [R]), each chunk
    of rows packed before the next is analyzed, so the FrameCode and field
    matrices never exist at full batch size."""
    cap = payload_capacity_bits(cfg, c)
    words, nbits = [], []
    for fc in frames.split(even_chunk(cfg)):
        lines, smr = analyze_frame(fc, cfg, c)
        code = quantize_given_alloc(lines, allocate_rows(smr, cfg, c), cfg, c)
        w, n = pack_rows(*payload_fields(code, cfg, c), cap)
        words.append(w)
        nbits.append(n)
    return torch.cat(words), torch.cat(nbits)


def input_signal(x, cfg: CodecConfig, dtype, dev) -> torch.Tensor:
    """x [..., C, T] on `dev` in the codec's float type, butterflied to
    M/S per channel pair when the stream is mid/side."""
    xt = torch.as_tensor(x).to(dev).to(dtype)
    return ms_forward(xt) if cfg.stereo_mode == "ms" else xt


def encode_frames_packed(frames, cfg: CodecConfig, c: CodecConsts):
    """frames f[..., C, F, N] (of the butterflied signal under M/S) →
    (words int32 [..., C, F, W32] holding 32-bit patterns, nbits int64
    [..., C, F]). Mid/side orders the rows frame-major ([..., F, C]) so
    that each pair's rows are adjacent, and swaps the words back."""
    ms = cfg.stereo_mode == "ms"
    if ms:
        frames = frames.transpose(-3, -2)          # [..., F, C, N]
    lead = frames.shape[:-1]
    words, nbits = _encode_rows_to_words(frames.reshape(-1, frames.shape[-1]),
                                         cfg, c)
    words, nbits = words.reshape(*lead, words.shape[-1]), nbits.reshape(lead)
    if ms:
        return (words.transpose(-3, -2).contiguous(),
                nbits.transpose(-2, -1).contiguous())
    return words, nbits


def encode_clip_packed(x, cfg: CodecConfig, device=None):
    """x: float [..., C, T] (array or tensor) → (words int32 [..., C, F, W32]
    holding 32-bit patterns, nbits int64 [..., C, F]), on `device` (CUDA
    unless named)."""
    dev = resolve_device(device)
    c = make_consts(cfg, dev)
    frames = fb.frame_signal(input_signal(x, cfg, c.dtype, dev),
                             cfg.n_mdct_lines)
    return encode_frames_packed(frames, cfg, c)


def _leaves(parts: list, lead: tuple):
    """Per-chunk NamedTuples of [R_i, ...] leaves → one of [*lead, ...]."""
    return type(parts[0])(*(
        torch.cat(ls).reshape(*lead, *ls[0].shape[1:])
        if isinstance(ls[0], torch.Tensor) else _leaves(list(ls), lead)
        for ls in zip(*parts)))


def encode_clip(x, cfg: CodecConfig, device=None) -> FrameCode:
    """x: float [..., C, T] → FrameCode with [..., C, F, ...] leaves on
    `device` (CUDA unless named): tac/codec.py:encode_clip, the quantized
    frames before any bit packing, each row allocated alone at c's budget
    (as tac's, this surface has no mid/side pairing). Rows are coded in
    chunks of ENC_CHUNK."""
    dev = resolve_device(device)
    c = make_consts(cfg, dev)
    frames = fb.frame_signal(torch.as_tensor(x).to(dev).to(c.dtype),
                             cfg.n_mdct_lines)
    parts = []
    for fc in frames.reshape(-1, frames.shape[-1]).split(ENC_CHUNK):
        lines, smr = analyze_frame(fc, cfg, c)
        alloc = water_fill_alloc(smr, c.n_lines, c.budget, cfg)
        parts.append(quantize_given_alloc(lines, alloc, cfg, c))
    return _leaves(parts, frames.shape[:-1])


def decode_clip(code: FrameCode, cfg: CodecConfig, t: int, device=None):
    """FrameCode [..., C, F, ...] (tensors or arrays) → [..., C, T] audio on
    `device` (CUDA unless named): tac/codec.py:decode_clip."""
    c = make_consts(cfg, resolve_device(device))
    code = FrameCode(*(torch.as_tensor(v).to(c.window.device) for v in code))
    y = decode_frame(code, cfg, c)
    return fb.overlap_add(y, cfg.n_mdct_lines, t)


# ------------------------------------------- frame-level streaming cores ---

def frames_from_halves(prior, halves, cfg: CodecConfig, c: CodecConsts):
    """prior [C, H] + halves [C, m, H] (L/R, arrays or tensors) → frames
    f[C, m, N] on c's device in the codec's float type, frame j =
    [h_{j-1} | h_j], butterflied per channel pair under M/S (per sample,
    so it commutes with framing: the offline frames of the same samples)."""
    dev = c.window.device
    seq = torch.cat([torch.as_tensor(prior)[:, None], torch.as_tensor(halves)],
                    dim=1).to(c.dtype).to(dev)     # [C, m+1, H]
    if cfg.stereo_mode == "ms":
        seq = ms_forward(seq.reshape(seq.shape[0], -1)).reshape(seq.shape)
    return torch.cat([seq[:, :-1], seq[:, 1:]], dim=-1)


def encode_frames_packed_halves(prior, halves, cfg: CodecConfig,
                                c: CodecConsts):
    """Streaming fixed-rate core (tac/codec.py:_encode_frames_packed_halves
    and its M/S form): (prior [C, H], halves [C, m, H]) → (words int32
    [C, m, W32], nbits int64 [C, m]), through the offline row path."""
    return encode_frames_packed(frames_from_halves(prior, halves, cfg, c),
                                cfg, c)


def read_head(wf: torch.Tensor, cfg: CodecConfig, pre: tuple):
    """The head of int32 [K, W32] payload rows, common to every layout
    (SPEC.md §7, §9): fixed-width fields of widths `pre` (overall scale;
    tableId and window state where the layout has them), the B allocation
    codes, then the scale factors at cumsum offsets. Returns (pre fields
    int32 [K, len(pre)], alloc_code [K, B], scale [K, B], mant_start int64
    [K, 1] — the bit offset of the first mantissa)."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    nb = bands.N_BANDS
    k = wf.shape[0]
    wid = torch.tensor([*pre] + [a] * nb, dtype=torch.int64, device=wf.device)
    off = torch.cumsum(wid, 0) - wid
    head = read_fields(wf, off.expand(k, -1), wid.expand(k, -1))
    alloc_code = head[:, len(pre):]
    sf_w = torch.where(alloc_code > 0, s, 0).to(torch.int64)
    sf_end = torch.cumsum(sf_w, dim=1)
    first = sum(pre) + a * nb
    sf = read_fields(wf, first + (sf_end - sf_w), sf_w)
    return head[:, :len(pre)], alloc_code, sf, first + sf_end[:, -1:]


def read_raw_mantissas(wf, mant_start, m_line):
    """Raw mantissas of widths m_line [K, H] from bit mant_start [K, 1] on,
    by cumsum offsets."""
    m = m_line.to(torch.int64)
    return read_fields(wf, mant_start + (torch.cumsum(m, dim=1) - m), m)


def _unpack_raw_fields(wf: torch.Tensor, cfg: CodecConfig,
                       c: CodecConsts) -> FrameCode:
    """int32 [K, W32] payload rows → FrameCode [K, ...] (SPEC.md §7 raw
    layout)."""
    pre, alloc_code, sf, mant_start = read_head(wf, cfg, (cfg.n_scale_bits,))
    m_line = torch.index_select(ba.code_to_alloc(alloc_code), 1, c.band_of_line)
    return FrameCode(ovs=pre[:, 0], alloc_code=alloc_code, scale=sf,
                     mant=read_raw_mantissas(wf, mant_start, m_line))


def decode_frames_packed(words, cfg: CodecConfig, c: CodecConsts):
    """words: int32 [..., W32] payload rows (32-bit patterns) → [..., N]
    windowed frame audio, before the overlap-add."""
    w = torch.as_tensor(words).to(c.window.device)
    code = _unpack_raw_fields(w.reshape(-1, w.shape[-1]), cfg, c)
    return decode_frame(code, cfg, c).reshape(*w.shape[:-1], -1)


def decode_clip_packed(words, cfg: CodecConfig, t: int, device=None):
    """words: int32 [..., C, F, W32] payload rows (32-bit patterns) →
    [..., C, T] audio, on `device` (CUDA unless named)."""
    c = make_consts(cfg, resolve_device(device))
    return output_signal(decode_frames_packed(words, cfg, c), cfg, t)


def frame_decoder(cfg: CodecConfig):
    """The family's frame decoder (words [..., W32], cfg, consts) →
    [..., N], and the constants it takes on a device: (decoder,
    make_consts)."""
    if cfg.use_block_switch:
        from tac_torch import blockswitch as bsw

        return ((bsw.decode_frames_bs_vbr if cfg.use_huffman
                 else bsw.decode_frames_bs), bsw.make_bs_consts)
    return ((decode_frames_vbr if cfg.use_huffman else decode_frames_packed),
            make_consts)


def decode_frames_stream(words, tail, cfg: CodecConfig, c):
    """Streaming decode core (tac/codec.py:_decode_frames_stream): words
    int32 [C, m, W32] of m ≥ 1 frames and the carried second half of the
    frame before them, tail f[C, H] (mid/side under M/S) → (out [C, m, H],
    the finished samples of each frame's first half, L/R; the new tail
    [C, H]). c is the family's constants (``frame_decoder``)."""
    h = cfg.n_mdct_lines
    y = frame_decoder(cfg)[0](words, cfg, c)       # [C, m, 2H]
    firsts, seconds = y[..., :h], y[..., h:]
    # the operand order of fb.overlap_add: first half + previous second
    out = firsts + torch.cat([tail.to(y)[:, None], seconds[:, :-1]], dim=1)
    if cfg.stereo_mode == "ms":                    # per sample: commutes
        out = ms_inverse(out.reshape(out.shape[0], -1)).reshape(out.shape)
    return out, seconds[:, -1]


# ----------------------------------------------------------- VBR (huffman) --

def cost_tables(cfg: CodecConfig, c: CodecConsts) -> tuple:
    """Per-set device cost tables the encoder prices with (SPEC.md §8):
    [7, 256] int32 each, one per trained set in cfg.huffman_sets."""
    return tuple(h.cost for h in c.huff[:cfg.huffman_sets])


def vbr_mantissa_pairs(mant, m_line, tid, huff: tuple, n_sets: int = 2):
    """Huffman-or-raw mantissa field pairs (SPEC.md §8).

    mant, m_line: int32[..., H]; tid: int32[...] (0 = raw, 1..3 = trained
    sets); huff: the sets' tables. Returns (vals, wids) int32[..., 2H]: the
    chosen set's codeword + escape-raw pairs where tid >= 1, a raw
    m_line-bit field (second field width 0) where tid == 0. n_sets bounds
    which sets the encoder may have picked."""
    hv, hw = hf.encode_fields_device(mant, m_line, huff[0])
    for sid in range(2, n_sets + 1):
        hv_s, hw_s = hf.encode_fields_device(mant, m_line, huff[sid - 1])
        here = (tid == sid)[..., None, None]
        hv = torch.where(here, hv_s, hv)
        hw = torch.where(here, hw_s, hw)
    raw = (tid == 0)[..., None]
    v0 = torch.where(raw, mant, hv[..., 0])
    w0 = torch.where(raw, m_line, hw[..., 0])
    v1 = torch.where(raw, 0, hv[..., 1])
    w1 = torch.where(raw, 0, hw[..., 1])
    shp = (*mant.shape[:-1], 2 * mant.shape[-1])
    return (torch.stack([v0, v1], dim=-1).reshape(shp),
            torch.stack([w0, w1], dim=-1).reshape(shp))


def payload_fields_vbr(code: FrameCode, tid, cfg: CodecConfig, c: CodecConsts,
                       m_line=None):
    """(vals, wids) field matrices per SPEC.md §7 huffman layout:
    ovs | 2-bit tableId | B alloc codes | B scale factors | huffman-or-raw
    mantissa pairs. Leaves [..., NF], NF = 2+2B+2H. m_line as in
    ``payload_fields``."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    alloc = ba.code_to_alloc(code.alloc_code)
    if m_line is None:
        m_line = torch.index_select(alloc, -1, c.band_of_line)
    tid = tid.to(torch.int32)
    hv, hw = vbr_mantissa_pairs(code.mant, m_line, tid, c.huff,
                                cfg.huffman_sets)
    vals = torch.cat([code.ovs[..., None], tid[..., None], code.alloc_code,
                      code.scale, hv], dim=-1)
    wids = torch.cat([torch.full_like(code.ovs[..., None], s),
                      torch.full_like(tid[..., None], 2),
                      torch.full_like(code.alloc_code, a),
                      torch.where(alloc > 0, s, 0).to(torch.int32), hw], dim=-1)
    return vals, wids


def _band_sum_int(x: torch.Tensor, c: CodecConsts) -> torch.Tensor:
    """Per-band sum of integer x[..., H] → int64 [..., N_BANDS]: one cumsum,
    then differences at the band edges (exact for integers). Grouped-short
    consts sum each sub-block's bands, then over the K sub-blocks."""
    if c.band_tile > 1:
        x = x.reshape(*x.shape[:-1], c.band_tile, -1)
    cs = torch.nn.functional.pad(x.cumsum(-1), (1, 0))
    out = (torch.index_select(cs, -1, c.band_edges[1])
           - torch.index_select(cs, -1, c.band_edges[0]))
    return out.sum(-2) if c.band_tile > 1 else out


def _vbr_band_costs(lines: torch.Tensor, cfg: CodecConfig, c: CodecConsts):
    """Budget-independent half of VBR pricing, batched over frame rows.

    The mantissa a line would get at band allocation m depends only on
    (lines, m), so the Huffman cost of each band at every codable m ∈ [2, 8]
    is computed here, in parallel, outside the serial reservoir chain.
    lines f[R, H] → bits_huf int32[R, B, 7·S]: set s (of the S =
    cfg.huffman_sets trained sets) occupies columns [7(s-1), 7s). The
    candidate mantissas are shared across sets; only the cost rows differ."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    ovs = quant.scale_factor(lines.abs().amax(-1), s, a)
    scaled = lines * torch.exp2(ovs.to(lines.dtype))[..., None]
    band_max = _band_max(scaled.abs(), c, 0.0)
    band_max = torch.where(c.n_lines > 0, band_max, 0.0)
    cost_tabs = cost_tables(cfg, c)
    outs = [[] for _ in cost_tabs]
    for m in range(hf.MIN_M, hf.MAX_M + 1):
        sf_m = quant.scale_factor(band_max, s, m)
        mant_m = quant.mantissa(
            scaled, torch.index_select(sf_m, -1, c.band_of_line), s, m).long()
        for out, tab in zip(outs, cost_tabs):
            out.append(_band_sum_int(tab[m - hf.MIN_M][mant_m], c))
    return torch.cat([torch.stack(o, dim=-1) for o in outs],
                     dim=-1).to(torch.int32)


def _vbr_phase1(frame_rows, cfg: CodecConfig, c: CodecConsts):
    """[M, N] frame rows → (lines [M, H], smr [M, B], bits_huf [M, B, 7·S])."""
    lines, smr = analyze_frame(frame_rows, cfg, c)
    return lines, smr, _vbr_band_costs(lines, cfg, c)


def _reservoir_chain(smr, bits_huf, n_lines, res0, base: int, cap: int,
                     cfg: CodecConfig):
    """The serial bit-reservoir chain (SPEC.md §8), frame-major.

    smr f[F, L, B], bits_huf int32[F, L, B, 7·S], n_lines int32[B] or
    [F, L, B], res0 int32[L] → (alloc int32[F, L, B], tid/used/res
    int32[F, L]). Fast precision runs K3 (its plain version for CPU
    tensors); parity keeps the plain f64 loop."""
    smr_eff = torch.zeros_like(smr) if cfg.alloc_mode == "uniform" else smr
    smr_q = ba.snap_smr(smr_eff)
    max_mant = min(cfg.max_mant_bits, ba.MANT_MAX)
    if cfg.precision == "parity":
        return vbr_reservoir_scan_plain(smr_q, bits_huf, n_lines, res0,
                                        base=base, cap=cap, max_mant=max_mant)
    return vbr_reservoir_scan(smr_q.to(torch.float32).contiguous(),
                              bits_huf.contiguous(), n_lines, res0,
                              base=base, cap=cap, max_mant=max_mant)


def to_lanes(frames: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """frames f[..., C, F, N] → [L, F, K, N] reservoir lanes: each channel
    its own lane (K = 1) or, under M/S, each channel pair one lane whose
    frames hold the pair's K = 2 rows, mid then side."""
    f, n = frames.shape[-2:]
    if cfg.stereo_mode == "ms":
        return frames.reshape(-1, 2, f, n).transpose(1, 2)
    return frames.reshape(-1, f, 1, n)


def n_lanes(lead: tuple, cfg: CodecConfig) -> int:
    """How many reservoir lanes ``to_lanes`` makes of channels [..., C]: one
    a channel, or one a pair under M/S."""
    n = 1
    for d in lead:
        n *= d
    return n // 2 if cfg.stereo_mode == "ms" else n


def from_lanes(x: torch.Tensor, lead: tuple) -> torch.Tensor:
    """Per-row x [L, F, K, ...] → [*lead, F, ...], lead = [..., C]: the
    inverse of ``to_lanes``'s row order."""
    f = x.shape[1]
    return x.transpose(1, 2).reshape(*lead, f, *x.shape[3:])


def frame_major(x: torch.Tensor, lanes: int, f: int) -> torch.Tensor:
    """Per-row x [L·F·K, B, ...] in (lane, frame, row) order → [F, L, K·B,
    ...]: frame-major, as the chain reads it, with a frame's K rows side by
    side on the band axis (mid's bands before side's)."""
    return x.reshape(lanes, f, -1, *x.shape[2:]).transpose(0, 1).contiguous()


def rows_of_chain(allocs: torch.Tensor, tids: torch.Tensor, k: int):
    """The chain's allocs int32 [F, L, K·B] and tids [F, L] → per-row allocs
    [L·F·K, B] and tids [L·F·K] in (lane, frame, row) order: a frame's
    tableId goes to each of its K rows."""
    kb = allocs.shape[-1]
    return (allocs.transpose(0, 1).reshape(-1, kb // k),
            tids.transpose(0, 1).reshape(-1).repeat_interleave(k))


def _vbr_phase1_lanes(frames, cfg: CodecConfig, c: CodecConsts):
    """Phase 1 of the VBR encode over all lanes, in row chunks. frames
    f[L, F, K, N] → (lines f[L·F·K, H] in row order, smr f[F, L, K·B],
    bits_huf int32[F, L, K·B, 7·S]); the last two ``frame_major``."""
    lanes, f = frames.shape[:2]
    parts = [_vbr_phase1(fc, cfg, c)
             for fc in frames.reshape(-1, frames.shape[-1]).split(ENC_CHUNK)]
    lines, smr, bits_huf = (torch.cat(p) for p in zip(*parts))
    return lines, frame_major(smr, lanes, f), frame_major(bits_huf, lanes, f)


def _vbr_pack_rows(lines, alloc_rows, tid_rows, cfg: CodecConfig,
                   c: CodecConsts):
    """Phase 3 of the VBR encode, per row chunk: quantize at the chain's
    allocations, build the VBR fields, pack. lines f[R, H], alloc_rows
    int32 [R, B], tid_rows [R] → (words int32 [R, W32], nbits int64 [R]);
    the FrameCode and the [R, 2+2B+2H] field matrices stay chunk-sized."""
    cap = payload_capacity_bits(cfg, c)
    words, nbits = [], []
    for ln, al, td in zip(lines.split(ENC_CHUNK), alloc_rows.split(ENC_CHUNK),
                          tid_rows.split(ENC_CHUNK)):
        code = quantize_given_alloc(ln, al, cfg, c)
        w, n = pack_rows(*payload_fields_vbr(code, td, cfg, c), cap)
        words.append(w)
        nbits.append(n)
    return torch.cat(words), torch.cat(nbits)


def _encode_vbr_lanes_to_words(frames, res0, cfg: CodecConfig, c: CodecConsts):
    """VBR encode over independent reservoir lanes, each chain resumed from
    its fill.

    frames f[L, F, K, N], res0 int32[L] → (words int32[L, F, K, W32], nbits
    int64[L, F, K], res int32[L, F]: the fill after every frame). A lane of
    M/S pairs (K = 2) allocates over its frame's K·B bands with base
    K·budget and cap reservoir_factor·K·budget, and prices both rows under
    one tableId (tac/codec.py:_encode_vbr_ms_to_words)."""
    lanes, f, k = frames.shape[:3]
    lines, smr, bits_huf = _vbr_phase1_lanes(frames, cfg, c)
    allocs, tids, _, ress = _reservoir_chain(
        smr, bits_huf, c.n_lines.repeat(k), res0, k * c.budget,
        cfg.reservoir_factor * k * c.budget, cfg)
    del smr, bits_huf
    words, nbits = _vbr_pack_rows(lines, *rows_of_chain(allocs, tids, k),
                                  cfg, c)
    return (words.reshape(lanes, f, k, -1), nbits.reshape(lanes, f, k),
            ress.transpose(0, 1))


def encode_frames_vbr_packed(frames, res0, cfg: CodecConfig, c: CodecConsts):
    """frames f[..., C, F, N] (of the butterflied signal under M/S), res0
    int32 [L] → (words int32 [..., C, F, W32], nbits int64 [..., C, F], res
    int32 [L, F]). The leading axes flatten into reservoir lanes: each
    channel, or each M/S pair, its own chain (``to_lanes``)."""
    lanes = to_lanes(frames, cfg)
    words, nbits, ress = _encode_vbr_lanes_to_words(lanes, res0, cfg, c)
    lead = frames.shape[:-2]                       # [..., C]
    return from_lanes(words, lead), from_lanes(nbits, lead), ress


def encode_clip_vbr_packed(x, cfg: CodecConfig, device=None):
    """VBR encode + Huffman field pack on the device. x: float [..., C, T]
    → (words int32 [..., C, F, W32], nbits int64 [..., C, F]). All leading
    axes flatten into reservoir lanes (each channel, or each M/S pair, its
    own chain from fill 0), so a batch gives each clip the bytes of a solo
    encode."""
    dev = resolve_device(device)
    c = make_consts(cfg, dev)
    frames = fb.frame_signal(input_signal(x, cfg, c.dtype, dev),
                             cfg.n_mdct_lines)
    res0 = torch.zeros(n_lanes(frames.shape[:-2], cfg), dtype=torch.int32,
                       device=dev)
    return encode_frames_vbr_packed(frames, res0, cfg, c)[:2]


def encode_frames_vbr_packed_halves(prior, halves, res0, cfg: CodecConfig,
                                    c: CodecConsts):
    """Streaming VBR core (tac/codec.py:_encode_frames_vbr_packed and its
    M/S form): (prior [C, H], halves [C, m, H], the carried fills res0
    int32 [L] of the C channels' or C/2 pairs' lanes) → (words int32
    [C, m, W32], nbits int64 [C, m], res int32 [L, m])."""
    return encode_frames_vbr_packed(frames_from_halves(prior, halves, cfg, c),
                                    res0, cfg, c)


def _vbr_head(wf: torch.Tensor, cfg: CodecConfig, c: CodecConsts):
    """The head of int32 [K, W32] VBR payload rows (SPEC.md §7 huffman
    layout) → (ovs [K], tid [K], alloc_code [K, B], scale [K, B], m_line
    int32 [K, H], mant_start int32 [K]): everything the mantissa read
    needs, and nothing of the mantissas."""
    pre, alloc_code, sf, mant_start = read_head(wf, cfg, (cfg.n_scale_bits, 2))
    m_line = torch.index_select(ba.code_to_alloc(alloc_code), 1,
                                c.band_of_line).contiguous()
    return (pre[:, 0], pre[:, 1].contiguous(), alloc_code, sf, m_line,
            mant_start[:, 0].to(torch.int32))


def _unpack_vbr_fields(wf: torch.Tensor, cfg: CodecConfig,
                       c: CodecConsts) -> FrameCode:
    """int32 [K, W32] VBR payload rows → FrameCode [K, ...]: the head, then
    raw rows' mantissas via cumsum-offset gathers and Huffman rows' via the
    serial decode walk."""
    ovs, tid, alloc_code, sf, m_line, mant_start = _vbr_head(wf, cfg, c)
    mant_raw = read_raw_mantissas(wf, mant_start[:, None], m_line)
    mant = huffman_decode_sets(wf, mant_start, m_line, tid, mant_raw, c.huff)
    return FrameCode(ovs=ovs, alloc_code=alloc_code, scale=sf, mant=mant)


def decode_frames_vbr(words, cfg: CodecConfig, c: CodecConsts):
    """words: int32 [..., W32] VBR payload rows → [..., N] windowed frame
    audio, before the overlap-add."""
    w = torch.as_tensor(words).to(c.window.device)
    code = _unpack_vbr_fields(w.reshape(-1, w.shape[-1]).contiguous(), cfg, c)
    return decode_frame(code, cfg, c).reshape(*w.shape[:-1], -1)


def decode_clip_vbr_packed(words, cfg: CodecConfig, t: int, device=None):
    """words: int32 [..., C, F, W32] VBR payload rows (32-bit patterns) →
    [..., C, T] audio, on `device` (CUDA unless named)."""
    c = make_consts(cfg, resolve_device(device))
    return output_signal(decode_frames_vbr(words, cfg, c), cfg, t)
