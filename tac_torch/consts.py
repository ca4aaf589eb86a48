"""Per-config constants of the codec and the psychoacoustic model.

The codec has no learned weights; what both packages must share to
compute the same thing are these host-built tables (windows, bases, band
maps, Bark grids, threshold in quiet). ``host_arrays`` builds them in NumPy
exactly as tac/codec.py:make_consts and tac/psy.py:make_consts do, and
``consts_from_numpy`` uploads any such set of arrays — the port's own or
the JAX package's, leaf for leaf — to a device. Huffman configs also carry
every trained table set (tac_torch/huffman.py:HUFF_LEAVES per set).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from tac_torch import bands
from tac_torch import huffman as hf
from tac_torch.config import CodecConfig
from tac_torch.dsp import mdct as fb
from tac_torch.dsp.window import hann_window, window_fn

# Array leaves, named as in tac's CodecConsts / PsyConsts.
CODEC_LEAVES = ("window", "fwd_basis", "inv_basis", "band_of_line", "n_lines")
PSY_LEAVES = ("hann", "freqs", "zline", "quiet_i", "band_of_line", "n_lines",
              "noise_z", "fft_cos", "fft_sin", "zedge_lo", "zedge_hi",
              "quiet_band_i")


class PsyConsts(NamedTuple):
    """Psychoacoustic-model constants on one device (tac/psy.py:PsyConsts)."""
    hann: torch.Tensor           # [N] psy analysis window
    fft_gain: float              # 4 / (N^2 * mean(hann^2))
    mdct_gain: float             # 8 / mean(codec_window^2)
    freqs: torch.Tensor          # [H] line center freqs
    zline: torch.Tensor          # [H] Bark of each line
    quiet_i: torch.Tensor        # [H] threshold-in-quiet intensity at lines
    band_of_line: torch.Tensor   # [H] int64
    n_lines: torch.Tensor        # [N_BANDS] int32
    noise_z: torch.Tensor        # [N_BANDS] Bark of band centers
    band_ranges: tuple           # ((start, end), ...) static line runs
    fft_cos: Optional[torch.Tensor]  # [N, H] hann-fused DFT cos basis (fast)
    fft_sin: Optional[torch.Tensor]  # [N, H] hann-fused DFT sin basis (fast)
    max_maskers: int
    delta_tonal: float
    delta_noise: float
    noise_maskers: bool
    band_thresh: bool            # band-granular threshold (SPEC §5)
    zedge_lo: torch.Tensor       # [N_BANDS] Bark of each band's first line
    zedge_hi: torch.Tensor       # [N_BANDS] Bark of each band's last line
    quiet_band_i: torch.Tensor   # [N_BANDS] min quiet intensity over band


class CodecConsts(NamedTuple):
    """Codec constants on one device (tac/codec.py:CodecConsts)."""
    window: torch.Tensor         # [N] codec window
    fwd_basis: torch.Tensor      # [N, H] window-fused MDCT basis (fast path)
    inv_basis: torch.Tensor      # [H, N] window-fused IMDCT basis
    band_of_line: torch.Tensor   # [H] int64
    n_lines: torch.Tensor        # [N_BANDS] int32
    band_ranges: tuple           # ((start, end), ...) static line runs
    band_edges: torch.Tensor     # [2, N_BANDS] int64 line-run starts / ends
    psy: Optional[PsyConsts]
    huff: Optional[tuple]        # HuffConsts per trained set (index = tableId-1)
    budget: int                  # mantissa bits per block/channel
    mdct_gain: float             # 8 / mean(window^2)
    dtype: torch.dtype
    band_tile: int = 1           # K > 1: grouped shorts, band map tiled K times


def _bark_np(f):
    return 13.0 * np.arctan(0.76 * f / 1000.0) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _thresh_quiet_db_np(f):
    fk = np.maximum(f, 20.0) / 1000.0
    return (3.64 * fk ** -0.8 - 6.5 * np.exp(-0.6 * (fk - 3.3) ** 2)
            + 1e-3 * fk ** 4)


def frame_budget(cfg: CodecConfig, h: Optional[int] = None) -> int:
    """SPEC.md §6 per-(frame, channel) mantissa bit budget."""
    h = cfg.n_mdct_lines if h is None else h
    s, a = cfg.n_scale_bits, cfg.n_mant_size_bits
    b = (cfg.bitrate_bps * h) // (cfg.sample_rate * cfg.n_channels) \
        - s - bands.N_BANDS * (s + a) - (2 if cfg.use_block_switch else 0) \
        - (2 if cfg.use_huffman else 0)
    return max(int(b), 0)


def band_thresh(cfg: CodecConfig) -> bool:
    """Whether the psy model runs band-granular (tac/psy.py:171-178): parity
    always uses the line model; "band" engages only on fast fixed-rate L/R
    coding without block switching; "band_all" forces it."""
    return (cfg.precision == "fast"
            and (cfg.psy_granularity == "band_all"
                 or (cfg.psy_granularity == "band"
                     and not cfg.use_block_switch
                     and not cfg.use_huffman
                     and cfg.stereo_mode == "lr")))


def _dtype(cfg: CodecConfig):
    return np.float64 if cfg.precision == "parity" else np.float32


@functools.lru_cache(maxsize=4)
def _dft_cos_sin(h: int) -> tuple:
    """cos and sin of 2π·n·k/N, n < N = 2h, k < h: f64 [N, H], read-only
    and shared between the configs of one transform size."""
    n = 2 * h
    nk = np.arange(n)[:, None] * (np.arange(h)[None, :] * (2 * np.pi / n))
    out = np.cos(nk), np.sin(nk)
    for a in out:
        a.flags.writeable = False
    return out


def psy_host_arrays(cfg: CodecConfig) -> dict:
    """The psy model's constant arrays (PSY_LEAVES) for cfg's transform
    size, in NumPy (tac/psy.py:make_consts)."""
    h = cfg.n_mdct_lines
    n = 2 * h
    dt = _dtype(cfg)
    hw = hann_window(n)
    f = bands.line_freqs(cfg.sample_rate, h)
    quiet = 10.0 ** ((_thresh_quiet_db_np(f) - 96.0) / 10.0)
    if cfg.precision == "parity":
        fft_cos = fft_sin = None     # parity keeps the f64 FFT
    else:
        # hann-fused DFT-by-matmul bases; |X|^2 needs bins 0..H-1 only
        cos_nk, sin_nk = _dft_cos_sin(h)
        fft_cos = (hw[:, None] * cos_nk).astype(dt)
        fft_sin = (hw[:, None] * sin_nk).astype(dt)
    # each band's line run is contiguous and z increases with the line, so
    # a band's extreme-line Barks bound any unimodal spread over the band;
    # quiet is not unimodal, so its band minimum is taken exactly
    zl = _bark_np(f)
    zlo = np.zeros(bands.N_BANDS)
    zhi = np.zeros(bands.N_BANDS)
    qb = np.ones(bands.N_BANDS)
    for b, (s, e) in enumerate(bands.band_line_ranges(cfg.sample_rate, h)):
        if e > s:
            zlo[b], zhi[b] = zl[s], zl[e - 1]
            qb[b] = quiet[s:e].min()
    return {
        "hann": hw.astype(dt), "freqs": f.astype(dt), "zline": zl.astype(dt),
        "quiet_i": quiet.astype(dt),
        "band_of_line": bands.band_of_line(cfg.sample_rate, h),
        "n_lines": bands.lines_per_band(cfg.sample_rate, h),
        "noise_z": _bark_np(bands.band_center_freqs(cfg.sample_rate)).astype(dt),
        "fft_cos": fft_cos, "fft_sin": fft_sin,
        "zedge_lo": zlo.astype(dt), "zedge_hi": zhi.astype(dt),
        "quiet_band_i": qb.astype(dt),
    }


def host_arrays(cfg: CodecConfig) -> dict:
    """The config's constant arrays in NumPy: CODEC_LEAVES at the top level,
    PSY_LEAVES under "psy" (None without the psy model), and under "huffman"
    one dict of HUFF_LEAVES per trained table set on disk (None for
    fixed-rate configs; a decoder needs every set, whatever the encoder
    was allowed to pick)."""
    h = cfg.n_mdct_lines
    dt = _dtype(cfg)
    w = window_fn(cfg.window, 2 * h, cfg.kbd_alpha)
    return {
        "window": w.astype(dt),
        "fwd_basis": fb.mdct_basis(h, w, np.float64).astype(dt),
        "inv_basis": fb.imdct_basis(h, w, np.float64).astype(dt),
        "band_of_line": bands.band_of_line(cfg.sample_rate, h),
        "n_lines": bands.lines_per_band(cfg.sample_rate, h),
        "psy": psy_host_arrays(cfg) if cfg.use_psy else None,
        "huffman": ([hf.host_tables(sid) for sid in range(1, hf.n_sets() + 1)]
                    if cfg.use_huffman else None),
    }


def _up(a, device, dtype) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def psy_from_numpy(cfg: CodecConfig, p: dict, device) -> PsyConsts:
    """Upload a set of psy constant arrays (PSY_LEAVES) for cfg's transform
    size to `device`."""
    dev = torch.device(device)
    ft = torch.float64 if cfg.precision == "parity" else torch.float32
    h = cfg.n_mdct_lines
    n = 2 * h
    w = window_fn(cfg.window, n, cfg.kbd_alpha)
    hw = hann_window(n)
    fl = {k: _up(p[k], dev, ft) for k in PSY_LEAVES
          if k not in ("band_of_line", "n_lines")}
    return PsyConsts(
        fft_gain=float(4.0 / (n * n * np.mean(hw ** 2))),
        mdct_gain=float(8.0 / np.mean(w ** 2)),
        band_of_line=_up(p["band_of_line"], dev, torch.int64),
        n_lines=_up(p["n_lines"], dev, torch.int32),
        band_ranges=bands.band_line_ranges(cfg.sample_rate, h),
        max_maskers=cfg.max_maskers,
        delta_tonal=cfg.delta_tonal_db,
        delta_noise=cfg.delta_noise_db,
        noise_maskers=cfg.psy_noise_maskers,
        band_thresh=band_thresh(cfg),
        **fl)


def consts_from_numpy(cfg: CodecConfig, arrays: dict, device) -> CodecConsts:
    """Upload a set of constant arrays (see ``host_arrays``) to `device`.
    Float leaves take the config's precision; scalar and static fields are
    derived from the config."""
    dev = torch.device(device)
    ft = torch.float64 if cfg.precision == "parity" else torch.float32
    h = cfg.n_mdct_lines
    w = window_fn(cfg.window, 2 * h, cfg.kbd_alpha)
    ranges = bands.band_line_ranges(cfg.sample_rate, h)
    p = arrays.get("psy")
    return CodecConsts(
        window=_up(arrays["window"], dev, ft),
        fwd_basis=_up(arrays["fwd_basis"], dev, ft),
        inv_basis=_up(arrays["inv_basis"], dev, ft),
        band_of_line=_up(arrays["band_of_line"], dev, torch.int64),
        n_lines=_up(arrays["n_lines"], dev, torch.int32),
        band_ranges=ranges,
        band_edges=torch.tensor(ranges, dtype=torch.int64, device=dev).T
        .contiguous(),
        psy=psy_from_numpy(cfg, p, dev) if p is not None else None,
        huff=(tuple(hf.device_tables(t, dev) for t in arrays["huffman"])
              if arrays.get("huffman") else None),
        budget=frame_budget(cfg, h),
        mdct_gain=float(8.0 / np.mean(w ** 2)),
        dtype=ft,
    )
