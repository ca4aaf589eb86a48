"""Critical-band / scale-factor-band tables (counterpart of tac/bands.py).

Static host-side NumPy tables (SPEC.md §5): every band owns a contiguous
run of lines, so per-band reductions are static slices.
"""

from __future__ import annotations

import numpy as np

# 25 critical-band upper edges (Hz), SPEC.md §5.
CB_FREQ_LIMITS = np.array([
    100, 200, 300, 400, 510, 630, 770, 920, 1080, 1270, 1480, 1720,
    2000, 2320, 2700, 3150, 3700, 4400, 5300, 6400, 7700, 9500,
    12000, 15500, 24000,
], dtype=np.float64)

N_BANDS = len(CB_FREQ_LIMITS)


def line_freqs(fs: int, h: int) -> np.ndarray:
    """Center frequency of spectral line k: (k + 0.5) * fs / (2h)."""
    return (np.arange(h) + 0.5) * fs / (2.0 * h)


def band_of_line(fs: int, h: int) -> np.ndarray:
    """int32[h]: index of the band owning each line (last band absorbs any
    remainder above the final limit)."""
    f = line_freqs(fs, h)
    b = np.searchsorted(CB_FREQ_LIMITS, f, side="left")
    return np.minimum(b, N_BANDS - 1).astype(np.int32)


def lines_per_band(fs: int, h: int) -> np.ndarray:
    """int32[N_BANDS]: number of lines per band (0 for bands above fs/2)."""
    return np.bincount(band_of_line(fs, h), minlength=N_BANDS).astype(np.int32)


def band_line_ranges(fs: int, h: int) -> tuple:
    """Static ((start, end), ...) line range per band."""
    nl = lines_per_band(fs, h)
    ends = np.cumsum(nl)
    starts = ends - nl
    return tuple((int(s), int(e)) for s, e in zip(starts, ends))


def band_edges_hz(fs: int) -> np.ndarray:
    """[N_BANDS, 2] lower/upper edge of each band, clipped to [0, fs/2]."""
    lo = np.concatenate([[0.0], CB_FREQ_LIMITS[:-1]])
    hi = np.minimum(CB_FREQ_LIMITS, fs / 2.0)
    return np.stack([np.minimum(lo, fs / 2.0), hi], axis=1)


def band_center_freqs(fs: int) -> np.ndarray:
    """Geometric-mean center of each band (noise-masker placement)."""
    e = band_edges_hz(fs)
    lo = np.maximum(e[:, 0], 10.0)
    return np.sqrt(lo * np.maximum(e[:, 1], lo))
