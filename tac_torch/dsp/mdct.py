"""MDCT / IMDCT filterbank + framing (counterpart of tac/dsp/mdct.py).

Conventions (SPEC.md §3): N = 2H, n0 = (H+1)/2, forward scale 2/N,
inverse scale 2.

  * ``mdct_direct``/``imdct_direct`` — O(N^2) definitional forms (tests);
  * ``mdct_fft``/``imdct_fft`` — pre/post-twiddle FFT forms, the parity
    path (f64);
  * ``mdct_basis``/``imdct_basis`` — host-built window-fused bases: the
    fast path's MDCT is one ``[F, N] @ [N, H]`` matmul (cuBLAS on the card);
  * ``frame_signal``/``overlap_add`` — 50%-hop framing and its adjoint.
"""

from __future__ import annotations

import numpy as np
import torch


def _cos_table(h: int, inverse: bool, dtype, device) -> torch.Tensor:
    n = 2 * h
    n0 = (h + 1) / 2.0
    nn = np.arange(n, dtype=np.float64)
    kk = np.arange(h, dtype=np.float64)
    arg = np.outer(kk + 0.5, nn + n0) if inverse else np.outer(nn + n0, kk + 0.5)
    return torch.as_tensor(np.cos(2.0 * np.pi / n * arg), dtype=dtype,
                           device=device)


def mdct_direct(x: torch.Tensor, h: int) -> torch.Tensor:
    """X[k] = (2/N) sum_n x[n] cos(2π/N (n+n0)(k+1/2)). x: [..., 2h] → [..., h]."""
    return (2.0 / (2 * h)) * (x @ _cos_table(h, False, x.dtype, x.device))


def imdct_direct(X: torch.Tensor, h: int) -> torch.Tensor:
    """y[n] = 2 sum_k X[k] cos(2π/N (n+n0)(k+1/2)). X: [..., h] → [..., 2h]."""
    return 2.0 * (X @ _cos_table(h, True, X.dtype, X.device))


def _twiddles(h: int, dtype, device):
    """Twiddle constants for the FFT forms, in the complex type of dtype."""
    n = 2 * h
    n0 = (h + 1) / 2.0
    nn = np.arange(n, dtype=np.float64)
    kk = np.arange(h, dtype=np.float64)
    c = torch.complex64 if dtype == torch.float32 else torch.complex128
    tw = (np.exp(-1j * np.pi * nn / n),                       # fwd pre
          np.exp(-2j * np.pi * n0 * (kk + 0.5) / n),           # fwd post
          np.exp(2j * np.pi * n0 * kk / n),                    # inv pre
          np.exp(1j * np.pi * (nn + n0) / n))                  # inv post
    return tuple(torch.as_tensor(t, dtype=c, device=device) for t in tw)


def mdct_fft(x: torch.Tensor, h: int) -> torch.Tensor:
    """FFT-form MDCT. x: [..., 2h] (windowed) → [..., h]."""
    n = 2 * h
    pre_f, post_f, _, _ = _twiddles(h, x.dtype, x.device)
    X = torch.fft.fft(x.to(pre_f.dtype) * pre_f, dim=-1)[..., :h]
    return (2.0 / n) * (post_f * X).real.to(x.dtype)


def imdct_fft(X: torch.Tensor, h: int) -> torch.Tensor:
    """FFT-form IMDCT. X: [..., h] → [..., 2h]."""
    n = 2 * h
    _, _, pre_i, post_i = _twiddles(h, X.dtype, X.device)
    Xp = torch.nn.functional.pad(X.to(pre_i.dtype) * pre_i, (0, n - h))
    y = torch.fft.ifft(Xp, dim=-1) * n
    return 2.0 * (post_i * y).real.to(X.dtype)


def mdct_basis(h: int, window: np.ndarray | None = None,
               dtype=np.float32) -> np.ndarray:
    """Forward basis A[n, k] with the analysis window fused in: X = x @ A."""
    n = 2 * h
    n0 = (h + 1) / 2.0
    nn = np.arange(n, dtype=np.float64)
    kk = np.arange(h, dtype=np.float64)
    a = (2.0 / n) * np.cos(2.0 * np.pi / n * np.outer(nn + n0, kk + 0.5))
    if window is not None:
        a = window[:, None] * a
    return a.astype(dtype)


def imdct_basis(h: int, window: np.ndarray | None = None,
                dtype=np.float32) -> np.ndarray:
    """Inverse basis S[k, n] with the synthesis window fused in: y = X @ S."""
    n = 2 * h
    n0 = (h + 1) / 2.0
    nn = np.arange(n, dtype=np.float64)
    kk = np.arange(h, dtype=np.float64)
    s = 2.0 * np.cos(2.0 * np.pi / n * np.outer(kk + 0.5, nn + n0))
    if window is not None:
        s = s * window[None, :]
    return s.astype(dtype)


def num_frames(t: int, h: int) -> int:
    """F = ceil(T/H) + 1 (one priming block + one flush block). SPEC.md §1."""
    return -(-t // h) + 1


def frame_signal(x: torch.Tensor, h: int) -> torch.Tensor:
    """[..., T] → [..., F, 2H] frames at hop H with H leading zeros:
    frame i covers padded samples [i*H, i*H + 2H)."""
    t = x.shape[-1]
    f = num_frames(t, h)
    xp = torch.nn.functional.pad(x, (h, (f + 1) * h - t - h))
    halves = xp.reshape(*xp.shape[:-1], f + 1, h)
    return torch.cat([halves[..., :-1, :], halves[..., 1:, :]], dim=-1)


def overlap_add(y: torch.Tensor, h: int, t: int) -> torch.Tensor:
    """[..., F, 2H] → [..., T]: shifted half-frame sum, drop the priming half."""
    first, second = y[..., :h], y[..., h:]
    zero = torch.zeros_like(first[..., :1, :])
    acc = (torch.cat([first, zero], dim=-2)
           + torch.cat([zero, second], dim=-2))            # [..., F+1, H]
    out = acc.reshape(*acc.shape[:-2], -1)
    return out[..., h:h + t]
