"""Analysis/synthesis windows (counterpart of tac/dsp/window.py, SPEC.md §2).

Windows are static constants of a config: built on the host in NumPy f64
and uploaded once with the other constants (tac_torch/consts.py).
"""

from __future__ import annotations

import numpy as np


def sine_window(n: int) -> np.ndarray:
    """w[i] = sin(pi*(i+0.5)/n). Satisfies Princen–Bradley TDAC."""
    i = np.arange(n, dtype=np.float64)
    return np.sin(np.pi * (i + 0.5) / n)


def hann_window(n: int) -> np.ndarray:
    """w[i] = 0.5*(1-cos(2*pi*(i+0.5)/n)) — the psychoacoustic FFT window."""
    i = np.arange(n, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * (i + 0.5) / n))


def kbd_window(n: int, alpha: float = 4.0) -> np.ndarray:
    """Kaiser–Bessel-derived window; satisfies TDAC for 50% overlap."""
    h = n // 2
    j = np.arange(h + 1, dtype=np.float64)
    kb = np.i0(np.pi * alpha * np.sqrt(np.clip(1.0 - (2.0 * j / h - 1.0) ** 2, 0.0, 1.0)))
    csum = np.cumsum(kb)
    total = csum[-1]
    left = np.sqrt(csum[:h] / total)
    return np.concatenate([left, left[::-1]])


def window_fn(name: str, n: int, kbd_alpha: float = 4.0) -> np.ndarray:
    if name == "sine":
        return sine_window(n)
    if name == "hann":
        return hann_window(n)
    if name == "kbd":
        return kbd_window(n, kbd_alpha)
    raise ValueError(f"unknown window {name!r}")


def transition_windows(n_long: int, n_short: int, name: str = "sine",
                       kbd_alpha: float = 4.0):
    """START / STOP hybrid windows for block switching (SPEC.md §9).

    START rises like the long window over [0, H_long), stays flat for
    (H_long - H_short) / 2 samples, falls with the short window's second
    half so that it TDAC-overlaps the first short block, then is zero; STOP
    is its time reverse. Returns (start, stop), each of length n_long."""
    h_long, h_short = n_long // 2, n_short // 2
    wl = window_fn(name, n_long, kbd_alpha)
    ws = window_fn(name, n_short, kbd_alpha)
    flat = (h_long - h_short) // 2
    start = np.ones(n_long, dtype=np.float64)
    start[:h_long] = wl[:h_long]
    start[h_long + flat:h_long + flat + h_short] = ws[h_short:]
    start[h_long + flat + h_short:] = 0.0
    return start, start[::-1].copy()
