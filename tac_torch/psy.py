"""Psychoacoustic model: masked thresholds and SMRs (counterpart of tac/psy.py).

Every function takes a batch of frames along the leading axes (tac vmaps a
per-frame function; here the batch axis is written out). Formulas are
frozen in SPEC.md §5:

  * the fast-mode spectrum is a hann-fused DFT by two matmuls; parity keeps
    the f64 FFT;
  * tonal maskers are strict local maxima, pair-compacted and ordered by a
    stable sort (the lowest index wins a tie, as tac's two-key sort does);
  * per-band float sums are deterministic: each band's lines are added
    left to right (a per-band cumsum), never through atomics.
"""

from __future__ import annotations

import torch

from tac_torch import consts
from tac_torch.config import CodecConfig
from tac_torch.consts import PsyConsts

_NEG = -1e30  # "minus infinity" that stays finite in f32


def make_consts(cfg: CodecConfig, device) -> PsyConsts:
    """The config's psy constants on `device` (tac/psy.py:make_consts)."""
    return consts.psy_from_numpy(cfg, consts.psy_host_arrays(cfg), device)


# ------------------------------------------------------- scalar formulas ----

def spl_from_intensity(i: torch.Tensor) -> torch.Tensor:
    """SPL(I) = max(96 + 10 log10 I, -30) dB."""
    return torch.clamp(96.0 + 10.0 * torch.log10(torch.clamp(i, min=1e-40)),
                       min=-30.0)


def intensity_from_spl(spl: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, (spl - 96.0) / 10.0)


def bark(f: torch.Tensor) -> torch.Tensor:
    """Bark(f) = 13 atan(0.76 f/1k) + 3.5 atan((f/7.5k)^2)."""
    g = f / 7500.0
    return 13.0 * torch.atan(0.76 * f / 1000.0) + 3.5 * torch.atan(g * g)


# ------------------------------------------------------- band reductions ----

def band_slice_max(x: torch.Tensor, ranges: tuple, fill) -> torch.Tensor:
    """Per-band max of x[..., H] over the static line runs → [..., N_BANDS].
    Empty bands yield `fill`."""
    cols = [x[..., s:e].amax(-1) if e > s
            else torch.full(x.shape[:-1], fill, dtype=x.dtype, device=x.device)
            for s, e in ranges]
    return torch.stack(cols, dim=-1)


def band_slice_sum(x: torch.Tensor, ranges: tuple) -> torch.Tensor:
    """Per-band sum of x[..., H] → [..., N_BANDS]; empty bands yield 0.

    Float sums accumulate each band's lines left to right (the last entry
    of a per-band cumsum): the order tac's serial segment_sum uses, and one
    that does not change from run to run on the card."""
    cols = [x[..., s:e].cumsum(-1)[..., -1] if e > s
            else torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
            for s, e in ranges]
    return torch.stack(cols, dim=-1)


# --------------------------------------------------------------- model ------

def _spread_spl(lm, zm, delta, zline):
    """Two-slope Schroeder spreading (SPEC.md §5): maskers [..., K] → points
    [P]. Returns the spread masking SPL [..., K, P]."""
    dz = zline - zm[..., None]                                # [..., K, P]
    up_slope = torch.clamp(27.0 - 0.367 * torch.clamp(lm - 40.0, min=0.0),
                           min=0.0)
    drop = torch.where(dz < 0, 27.0 * (-dz), up_slope[..., None] * dz)
    return (lm - delta)[..., None] - drop


def _spectrum_intensity(time_frame: torch.Tensor, c: PsyConsts) -> torch.Tensor:
    """[..., N] time frames → [..., H] psy spectrum intensity."""
    h = c.freqs.shape[0]
    x = time_frame.to(c.hann.dtype)
    if c.fft_cos is None:            # parity: f64 FFT
        a = torch.fft.fft(x * c.hann, dim=-1)[..., :h].abs()
        return c.fft_gain * (a * a)
    re = x @ c.fft_cos               # fast: the DFT as two matmuls
    im = x @ c.fft_sin
    return c.fft_gain * (re * re + im * im)


def _tonal_maskers(ii: torch.Tensor, c: PsyConsts):
    """[..., H] intensities → (peak_i[..., H], top_i, top_idx, lm, zm,
    valid [..., K], k)."""
    h = c.freqs.shape[0]
    edge = ii[..., :1]
    inf = torch.full_like(edge, float("inf"))
    zero = torch.zeros_like(edge)
    # tonal maskers: interior local maxima, ±1-bin aggregation
    left = torch.cat([inf, ii[..., :-1]], dim=-1)
    right = torch.cat([ii[..., 1:], inf], dim=-1)
    is_peak = (ii > left) & (ii >= right)
    agg = ii + torch.cat([zero, ii[..., :-1]], dim=-1) \
        + torch.cat([ii[..., 1:], zero], dim=-1)
    peak_i = torch.where(is_peak, agg, 0.0)
    k = min(c.max_maskers, h)

    # Σ ii·f over the three aggregated bins (edge-replicated), carried
    # through the sort as a payload: the masker's weighted center frequency
    prod = ii * c.freqs
    num_line = (torch.cat([prod[..., :1], prod[..., :-1]], dim=-1) + prod
                + torch.cat([prod[..., 1:], prod[..., -1:]], dim=-1))
    # strict peaks are never adjacent, so each line pair holds at most one
    # candidate: compact [H] -> [H/2] before the sort (order preserved)
    if k <= h // 2:
        pa, pb = peak_i[..., 0::2], peak_i[..., 1::2]
        sel_b = pb > pa
        cand_i = torch.where(sel_b, pb, pa)
        cand_idx = (torch.arange(h // 2, device=ii.device) * 2
                    + sel_b.to(torch.int64))
        cand_num = torch.where(sel_b, num_line[..., 1::2], num_line[..., 0::2])
    else:                                    # tiny frames: sort everything
        cand_i = peak_i
        cand_idx = torch.arange(h, device=ii.device).expand(ii.shape)
        cand_num = num_line
    # a stable sort of -value keeps equal values in index order: the order
    # of tac's two-key (-value, index) sort, so the kept set is the same
    neg_key, order = torch.sort(-cand_i, dim=-1, stable=True)
    order = order[..., :k]
    top_i = -neg_key[..., :k]
    top_idx = torch.gather(cand_idx.expand(cand_i.shape), -1, order)
    fm_num = torch.gather(cand_num, -1, order)
    valid = top_i > 0.0
    fm = fm_num / torch.clamp(top_i, min=1e-40)
    lm = spl_from_intensity(top_i)
    zm = bark(fm)
    return peak_i, top_i, top_idx, lm, zm, valid, k


def _noise_band_maskers(ii, peak_i, top_i, top_idx, valid, k, c: PsyConsts):
    """Per-band noise maskers → (ln[..., B] SPL, nvalid[..., B]).

    Bins within ±1 of a kept tonal masker are excluded from noise. A line is
    kept iff its aggregated peak strictly beats the kth sorted value, or
    ties it at an index no larger than the largest kept tie index."""
    h = c.freqs.shape[0]
    thr_k = top_i[..., k - 1:k]
    tie_hi = torch.where((top_i == thr_k) & valid, top_idx,
                         -1).amax(-1, keepdim=True)
    line_idx = torch.arange(h, device=ii.device)
    kept = (peak_i > 0.0) & ((peak_i > thr_k)
                             | ((peak_i == thr_k) & (line_idx <= tie_hi)))
    no = torch.zeros_like(kept[..., :1])
    near_peak = (kept | torch.cat([kept[..., 1:], no], dim=-1)
                 | torch.cat([no, kept[..., :-1]], dim=-1))
    noise_line_i = torch.where(near_peak, 0.0, ii)
    noise_i = band_slice_sum(noise_line_i, c.band_ranges)
    return spl_from_intensity(noise_i), noise_i > 0.0


def masked_threshold(time_frame: torch.Tensor, c: PsyConsts) -> torch.Tensor:
    """Masked-threshold intensity at each line: [..., N] → [..., H]."""
    ii = _spectrum_intensity(time_frame, c)
    peak_i, top_i, top_idx, lm, zm, valid, k = _tonal_maskers(ii, c)
    vk = valid[..., None]
    spread = torch.where(vk, _spread_spl(lm, zm, c.delta_tonal, c.zline), _NEG)
    thr_i = (intensity_from_spl(spread) * vk).sum(-2)
    if c.noise_maskers:
        ln, nvalid = _noise_band_maskers(ii, peak_i, top_i, top_idx,
                                         valid, k, c)
        nspread = _spread_spl(ln, c.noise_z, c.delta_noise, c.zline)
        thr_i = thr_i + (intensity_from_spl(nspread) * nvalid[..., None]).sum(-2)
    return thr_i + c.quiet_i


def masked_threshold_bands(time_frame: torch.Tensor, c: PsyConsts) -> torch.Tensor:
    """Band-granular masked threshold (SPEC §5): [..., N] → [..., B].

    Each masker's spread is unimodal in Bark and each band owns a
    contiguous z-increasing line run, so its minimum over a band sits at
    one of the band's two extreme lines: evaluating at the 2B edge Barks
    and taking the per-masker edge minimum gives a threshold that never
    masks more than the line model."""
    ii = _spectrum_intensity(time_frame, c)
    peak_i, top_i, top_idx, lm, zm, valid, k = _tonal_maskers(ii, c)
    zedges = torch.cat([c.zedge_lo, c.zedge_hi])               # [2B]
    nb = c.zedge_lo.shape[0]
    vk = valid[..., None]
    sp_t = torch.where(vk, _spread_spl(lm, zm, c.delta_tonal, zedges), _NEG)
    it = intensity_from_spl(sp_t) * vk
    thr_b = torch.minimum(it[..., :nb], it[..., nb:]).sum(-2)
    if c.noise_maskers:
        ln, nvalid = _noise_band_maskers(ii, peak_i, top_i, top_idx,
                                         valid, k, c)
        sp_n = _spread_spl(ln, c.noise_z, c.delta_noise, zedges)
        inn = intensity_from_spl(sp_n) * nvalid[..., None]
        thr_b = thr_b + torch.minimum(inn[..., :nb], inn[..., nb:]).sum(-2)
    return thr_b + c.quiet_band_i


def calc_smrs(time_frame: torch.Tensor, mdct_lines: torch.Tensor,
              c: PsyConsts, mdct_gain=None) -> torch.Tensor:
    """SMR per scale-factor band. time_frame [..., N], mdct_lines [..., H]
    → [..., N_BANDS]; empty bands get a large negative.

    mdct_gain [...] overrides the window-power gain 8/mean(w^2) per frame:
    the block-switch START / STOP windows carry other power than the long
    window (SPEC.md §9)."""
    gain = c.mdct_gain if mdct_gain is None else mdct_gain[..., None]
    if c.band_thresh:
        thr_spl = spl_from_intensity(masked_threshold_bands(time_frame, c))
        lines = mdct_lines.to(thr_spl.dtype)
        line_spl = spl_from_intensity(gain * (lines * lines))
        smr = band_slice_max(line_spl, c.band_ranges, _NEG) - thr_spl
    else:
        thr_spl = spl_from_intensity(masked_threshold(time_frame, c))
        lines = mdct_lines.to(thr_spl.dtype)
        line_spl = spl_from_intensity(gain * (lines * lines))
        smr = band_slice_max(line_spl - thr_spl, c.band_ranges, _NEG)
    return torch.where(c.n_lines > 0, smr, _NEG)
