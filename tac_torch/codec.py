"""Codec core: fixed-rate L/R encode to payload words and decode back
(counterpart of the fixed-rate subset of tac/codec.py, SPEC.md §4–§7).

Encode: frame → window-fused MDCT (matmul; FFT in parity) → psy SMRs →
bit allocation → quantize → payload fields → bit pack, in row chunks of
ENC_CHUNK frames. Decode: read fields → dequantize → IMDCT → overlap-add.
Every frame row is independent, so all leading axes (clips, channels,
frames) flatten into one row axis.

On a CUDA device, fast precision allocates with kernel K1 and packs with
kernel K2. Parity precision allocates with the plain f64 loop (as tac
gates its kernel at codec.py:235-248); its packing goes through K2, which
is integer-exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tac_torch import bands, quant
from tac_torch import bitalloc as ba
from tac_torch import consts
from tac_torch import psy as psy_mod
from tac_torch.config import CodecConfig, check_supported, resolve_device
from tac_torch.consts import CodecConsts, frame_budget  # noqa: F401
from tac_torch.dsp import mdct as fb
from tac_torch.ops.alloc import water_fill_rows
from tac_torch.ops.bitpack import pack_rows
from tac_torch.ops.bitunpack import read_fields

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


class FrameCode(NamedTuple):
    """Quantized representation of frames — the parity surface (SPEC §10)."""
    ovs: torch.Tensor         # [...] int32 overall scale factor
    alloc_code: torch.Tensor  # [..., N_BANDS] int32 (0 ⇔ no bits, else alloc-1)
    scale: torch.Tensor       # [..., N_BANDS] int32 (0 where alloc_code == 0)
    mant: torch.Tensor        # [..., H] int32 line mantissas (0 where no bits)


def _smr_input(frames, lines, cfg: CodecConfig, c: CodecConsts):
    """What drives bit allocation (SPEC §5/§6; the four BitAlloc modes)."""
    if cfg.use_psy and cfg.alloc_mode in ("greedy", "const_mnr"):
        return psy_mod.calc_smrs(frames, lines, c.psy)
    if cfg.alloc_mode == "const_snr":
        spl = psy_mod.spl_from_intensity(c.mdct_gain * lines * lines)
        return psy_mod.band_slice_max(spl, c.band_ranges, float("-inf"))
    return torch.zeros(*lines.shape[:-1], bands.N_BANDS, dtype=c.dtype,
                       device=lines.device)       # uniform


def analyze_frame(frames: torch.Tensor, cfg: CodecConfig, c: CodecConsts):
    """frames [..., N] (unwindowed) → (mdct lines [..., H], smr [..., B])."""
    if cfg.precision == "parity":
        lines = fb.mdct_fft(frames * c.window, c.window.shape[0] // 2)
    else:
        lines = frames @ c.fwd_basis
    return lines, _smr_input(frames, lines, cfg, c)


def allocate_rows(smr: torch.Tensor, cfg: CodecConfig,
                  c: CodecConsts) -> torch.Tensor:
    """smr [R, B] → alloc int32 [R, B]. Fast precision runs K1 (its plain
    version for CPU tensors); parity keeps the plain f64 loop."""
    if cfg.precision == "parity":
        return ba.allocate(smr, c.n_lines, c.budget, cfg.alloc_mode,
                           cfg.max_mant_bits)
    smr_eff = torch.zeros_like(smr) if cfg.alloc_mode == "uniform" else smr
    smr_q = ba.snap_smr(smr_eff).to(torch.float32).contiguous()
    budgets = torch.full(smr_q.shape[:1], c.budget, dtype=torch.int32,
                         device=smr_q.device)
    return water_fill_rows(smr_q, c.n_lines, budgets,
                           max_mant=cfg.max_mant_bits)


def quantize_given_alloc(lines: torch.Tensor, alloc: torch.Tensor,
                         cfg: CodecConfig, c: CodecConsts) -> FrameCode:
    """lines [..., H] + final per-band allocation [..., B] → FrameCode."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    ovs = quant.scale_factor(lines.abs().amax(-1), s, a)
    # 2^ovs is a power-of-two scale: exact in every float format (SPEC §10)
    scaled = lines * torch.exp2(ovs.to(lines.dtype))[..., None]
    band_max = psy_mod.band_slice_max(scaled.abs(), c.band_ranges, 0.0)
    band_max = torch.where(c.n_lines > 0, band_max, 0.0)
    sf = quant.scale_factor(band_max, s, alloc)
    sf = torch.where(alloc > 0, sf, 0)
    m_line = torch.index_select(alloc, -1, c.band_of_line)
    sf_line = torch.index_select(sf, -1, c.band_of_line)
    mant = quant.mantissa(scaled, sf_line, s, m_line)
    return FrameCode(ovs=ovs, alloc_code=ba.alloc_to_code(alloc),
                     scale=sf.to(torch.int32), mant=mant)


def decode_frame(code: FrameCode, cfg: CodecConfig, c: CodecConsts):
    """FrameCode [...] → [..., N] windowed time-domain output (pre-OLA)."""
    alloc = ba.code_to_alloc(code.alloc_code)
    m_line = torch.index_select(alloc, -1, c.band_of_line)
    sf_line = torch.index_select(code.scale, -1, c.band_of_line)
    scaled = quant.dequantize_mantissa(code.mant, sf_line, cfg.n_scale_bits,
                                       m_line, c.dtype)
    lines = scaled * torch.exp2(-code.ovs.to(c.dtype))[..., None]
    if cfg.precision == "parity":
        return fb.imdct_fft(lines, lines.shape[-1]) * c.window
    return lines @ c.inv_basis


def payload_fields(code: FrameCode, cfg: CodecConfig, c: CodecConsts):
    """(vals, wids) field matrices per SPEC.md §7 raw layout:
    ovs | B alloc codes | B scale factors (0-width where alloc=0) |
    H mantissas (width = band alloc). Leaves [..., NF], NF = 1+2B+H."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    alloc = ba.code_to_alloc(code.alloc_code)
    m_line = torch.index_select(alloc, -1, c.band_of_line)
    vals = torch.cat([code.ovs[..., None], code.alloc_code, code.scale,
                      code.mant], dim=-1)
    wids = torch.cat([torch.full_like(code.ovs[..., None], s),
                      torch.full_like(code.alloc_code, a),
                      torch.where(alloc > 0, s, 0).to(torch.int32), m_line],
                     dim=-1)
    return vals, wids


def payload_capacity_bits(cfg: CodecConfig, c: CodecConsts | None = None) -> int:
    """Raw fixed-rate payload capacity per (block, channel), in bits."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    head = s + bands.N_BANDS * (a + s)
    budget = c.budget if c is not None else frame_budget(cfg)
    return head + budget + 32


def _encode_rows_to_words(frames: torch.Tensor, cfg: CodecConfig,
                          c: CodecConsts):
    """frames [R, N] → (words int32 [R, W32], nbits int64 [R]), each chunk
    of ENC_CHUNK rows packed before the next is analyzed, so the FrameCode
    and field matrices never exist at full batch size."""
    cap = payload_capacity_bits(cfg, c)
    words, nbits = [], []
    for fc in frames.split(ENC_CHUNK):
        lines, smr = analyze_frame(fc, cfg, c)
        code = quantize_given_alloc(lines, allocate_rows(smr, cfg, c), cfg, c)
        w, n = pack_rows(*payload_fields(code, cfg, c), cap)
        words.append(w)
        nbits.append(n)
    return torch.cat(words), torch.cat(nbits)


def encode_clip_packed(x, cfg: CodecConfig, device=None):
    """x: float [..., C, T] (array or tensor) → (words int32 [..., C, F, W32]
    holding 32-bit patterns, nbits int64 [..., C, F]), on `device` (CUDA
    unless named)."""
    check_supported(cfg)
    dev = resolve_device(device)
    c = make_consts(cfg, dev)
    xt = torch.as_tensor(x).to(dev).to(c.dtype)
    frames = fb.frame_signal(xt, cfg.n_mdct_lines)
    lead = frames.shape[:-1]                       # [..., C, F]
    words, nbits = _encode_rows_to_words(frames.reshape(-1, frames.shape[-1]),
                                         cfg, c)
    return words.reshape(*lead, words.shape[-1]), nbits.reshape(lead)


def _unpack_raw_fields(wf: torch.Tensor, cfg: CodecConfig,
                       c: CodecConsts) -> FrameCode:
    """int32 [K, W32] payload rows → FrameCode [K, ...] (SPEC.md §7 raw
    layout): fixed-offset head, then cumsum offsets for the scale factors
    and mantissas."""
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    nb = bands.N_BANDS
    k = wf.shape[0]
    dev = wf.device
    head_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          s + a * torch.arange(nb, device=dev)])
    head_wid = torch.cat([torch.full((1,), s, device=dev),
                          torch.full((nb,), a, device=dev)])
    head = read_fields(wf, head_off.expand(k, nb + 1), head_wid.expand(k, nb + 1))
    ovs, alloc_code = head[:, 0], head[:, 1:]
    alloc = ba.code_to_alloc(alloc_code)

    sf_w = torch.where(alloc > 0, s, 0).to(torch.int64)
    sf_end = torch.cumsum(sf_w, dim=1)
    sf = read_fields(wf, (s + a * nb) + (sf_end - sf_w), sf_w)

    m_line = torch.index_select(alloc, 1, c.band_of_line).to(torch.int64)
    m_end = torch.cumsum(m_line, dim=1)
    mant = read_fields(wf, (s + a * nb) + sf_end[:, -1:] + (m_end - m_line),
                       m_line)
    return FrameCode(ovs=ovs, alloc_code=alloc_code, scale=sf, mant=mant)


def decode_clip_packed(words, cfg: CodecConfig, t: int, device=None):
    """words: int32 [..., C, F, W32] payload rows (32-bit patterns) →
    [..., C, T] audio, on `device` (CUDA unless named)."""
    check_supported(cfg)
    dev = resolve_device(device)
    c = make_consts(cfg, dev)
    w = torch.as_tensor(words).to(dev)
    lead = w.shape[:-1]                            # [..., C, F]
    code = _unpack_raw_fields(w.reshape(-1, w.shape[-1]), cfg, c)
    y = decode_frame(code, cfg, c)                 # [K, N]
    return fb.overlap_add(y.reshape(*lead, 2 * cfg.n_mdct_lines),
                          cfg.n_mdct_lines, t)
