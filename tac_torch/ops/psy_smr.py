"""Kernel K8: the fast psychoacoustic model after its DFT, one launch a call.

A kernel of the port with no TPU counterpart: tac leaves its psy model to
XLA (tac/psy.py), which fuses it; run eagerly, the model after the DFT was
~160 small launches a call (``psy.smrs_from_intensity``). ``psy_smr_rows``
takes the hann-fused DFT's real and imaginary rows (K6's two products), the
MDCT lines and the MDCT gain, and returns the SMR per scale-factor band:
the intensity, the tonal maskers (peaks, pair compaction, the stable top-k
by (-value, index)), the noise maskers with their kept / tie rule, the
spread of both, the threshold in quiet and the band maxima, in either
threshold form (``PsyConsts.band_thresh``: the line model, or the band
model's 2B edge Barks). The CUDA source is tac_torch/csrc/psy_smr.cu.
The wrapper launches or raises; ``psy.calc_smrs`` owns the choice of route
and runs the plain model (``psy.smrs_from_intensity``) on the CPU and in
parity. K8 keeps the plain model's maskers and, its spread sums taken in
another order, gives SMRs within a few f32 ulps of the plain threshold.
"""

from __future__ import annotations

import ctypes

import torch

from tac_torch import _build
from tac_torch.consts import PsyConsts
from tac_torch.ops import segment_sum as k7


def _lib():
    return _build.entry(
        "psy_smr", "tac_psy_smr",
        [ctypes.c_void_p] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 5
        + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def psy_smr_rows(re: torch.Tensor, im: torch.Tensor, lines: torch.Tensor,
                 c: PsyConsts, gain=None, maskers: bool = False):
    """K8: re, im, lines f32 [..., H] (the psy DFT's real and imaginary
    parts and the MDCT lines of the same frames), gain None (the config's
    window gain ``c.mdct_gain``) or f32 [...] per row → smr f32 [..., B],
    ``_NEG`` on empty bands; with ``maskers`` also the kept tonal maskers'
    line indices int32 [..., k] in rank order, -1 past the valid ones, for
    verification (the codec never asks for them). The leading axes are
    rows.

    CUDA tensors launch the kernel (and count the launch in
    ``psy_smr_rows.launches``); any other device raises."""
    if re.device.type != "cuda":
        raise ValueError(f"psy_smr_rows: unsupported device {re.device}")
    h = c.freqs.shape[0]
    shape = re.shape
    for name, t in (("re", re), ("im", im), ("lines", lines)):
        if (t.device != re.device or t.dtype != torch.float32
                or t.shape != shape or t.dim() < 1 or shape[-1] != h):
            raise ValueError(f"psy_smr_rows: {name} must be a float32 "
                             f"[..., {h}] tensor on {re.device} shaped as re, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if gain is not None and (gain.device != re.device
                             or gain.dtype != torch.float32
                             or gain.shape != shape[:-1]):
        raise ValueError(f"psy_smr_rows: gain must be a float32 "
                         f"{tuple(shape[:-1])} tensor on {re.device}, got "
                         f"{gain.dtype} {tuple(gain.shape)} on {gain.device}")
    if c.freqs.device != re.device or c.freqs.dtype != torch.float32:
        raise ValueError("psy_smr_rows: the psy constants must be float32 on "
                         f"{re.device}")
    if h < 2 or h & (h - 1):
        raise ValueError(f"psy_smr_rows: H must be a power of two >= 2, "
                         f"got {h}")
    bounds = k7._bounds(tuple(c.band_ranges), h)     # K7's band table
    nb = len(c.band_ranges)
    k = min(c.max_maskers, h)
    if k < 1:
        raise ValueError(f"psy_smr_rows: max_maskers must be >= 1, got "
                         f"{c.max_maskers}")
    band = bool(c.band_thresh)
    zlo, zhi, quiet = ((c.zedge_lo, c.zedge_hi, c.quiet_band_i) if band
                       else (c.zline, c.zline, c.quiet_i))
    consts = [t.contiguous() for t in (c.freqs, zlo, zhi, quiet, c.noise_z)]
    launch = _lib()
    re2, im2, lines2 = (t.reshape(-1, h).contiguous() for t in (re, im, lines))
    rows = re2.shape[0]
    g = None if gain is None else gain.reshape(-1).contiguous()
    out = torch.empty((rows, nb), dtype=torch.float32, device=re.device)
    idx = (torch.empty((rows, k), dtype=torch.int32, device=re.device)
           if maskers else None)
    if rows:
        err = launch(re2.data_ptr(), im2.data_ptr(), lines2.data_ptr(),
                     None if g is None else g.data_ptr(), float(c.mdct_gain),
                     float(c.fft_gain), *(t.data_ptr() for t in consts),
                     float(c.delta_tonal), float(c.delta_noise),
                     out.data_ptr(), None if idx is None else idx.data_ptr(),
                     rows, h, k, nb, int(band), int(bool(c.noise_maskers)),
                     ctypes.cast(bounds, ctypes.c_void_p), re.device.index or 0,
                     torch.cuda.current_stream(re.device).cuda_stream)
        if err:
            raise RuntimeError(f"psy_smr kernel launch failed: CUDA error "
                               f"{err}")
        psy_smr_rows.launches += 1
    smr = out.reshape(*shape[:-1], nb)
    return smr if idx is None else (smr, idx.reshape(*shape[:-1], k))


psy_smr_rows.launches = 0
