"""Kernel K2: the sorted segment-OR that places packed fields into words.

Replaces tac/ops/pallas_pack.py:scatter_words_rows (_kernel_win). Each
field f of a row contributes c0[f] to word word0[f] and its spill c1[f] to
word word0[f]+1; contributions beyond the row's W32 words drop. Fields
never share bits, so OR and integer addition agree. The CUDA source is
tac_torch/csrc/scatter_words.cu; ``scatter_words_rows_plain`` computes
the sums of tac/ops/bitpack.py:82-87's compare-reduce by two scatter-adds
in plain PyTorch.

Words are 32-bit patterns held in int32 storage (PyTorch has no usable
uint32 arithmetic on the CPU): the plain version widens to int64, masks
to 32 bits and narrows back; the host views the result as numpy uint32.
"""

from __future__ import annotations

import ctypes

import torch

from tac_torch import _build

MAX_WORDS = 3072       # the kernel's shared word buffer: 48 KB for 4 rows
_MASK32 = 0xFFFFFFFF


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 tensor with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def scatter_words_rows_plain(c0: torch.Tensor, c1: torch.Tensor,
                             word0: torch.Tensor, *, w32: int) -> torch.Tensor:
    """Plain PyTorch K2: words[r, w] = Σ{c0 : word0 == w} + Σ{c1 : word0 == w-1}
    over w in [0, W32): each contribution added into its word, those that
    fall outside the row's words into a column that is then dropped."""
    w0 = word0.to(torch.int64)
    acc = torch.zeros((c0.shape[0], w32 + 1), dtype=torch.int64,
                      device=c0.device)
    for c, w in ((c0, w0), (c1, w0 + 1)):
        acc.scatter_add_(1, torch.where((w >= 0) & (w < w32), w, w32),
                         c.to(torch.int64) & _MASK32)
    return as_int32_bits(acc[:, :w32] & _MASK32)


def _lib():
    return _build.entry("scatter_words", "tac_scatter_words_rows",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])


def scatter_words_rows(c0: torch.Tensor, c1: torch.Tensor,
                       word0: torch.Tensor, *, w32: int) -> torch.Tensor:
    """K2: sorted segment-OR of per-field word contributions.

    c0, c1: int32 [R, NF] (32-bit patterns); word0: int32 [R, NF], the
    first word each field touches (non-decreasing along a row). Returns
    int32 [R, w32].

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count the launch in ``scatter_words_rows.launches``) or raise."""
    if c0.device.type == "cpu":
        return scatter_words_rows_plain(c0, c1, word0, w32=w32)
    if c0.device.type != "cuda":
        raise ValueError(f"scatter_words_rows: unsupported device {c0.device}")
    for name, t in (("c0", c0), ("c1", c1), ("word0", word0)):
        if (t.device != c0.device or t.dtype != torch.int32
                or not t.is_contiguous() or t.shape != c0.shape or t.dim() != 2):
            raise ValueError(f"scatter_words_rows: {name} must be a contiguous "
                             f"int32 [R, NF] tensor on {c0.device}")
    if not 0 < w32 <= MAX_WORDS:
        raise ValueError(f"scatter_words_rows takes 1..{MAX_WORDS} words, "
                         f"got {w32}")
    r, nf = c0.shape
    out = torch.empty((r, w32), dtype=torch.int32, device=c0.device)
    if r == 0:
        return out
    err = _lib()(c0.data_ptr(), c1.data_ptr(), word0.data_ptr(),
                 out.data_ptr(), r, nf, w32, c0.device.index or 0,
                 torch.cuda.current_stream(c0.device).cuda_stream)
    if err:
        raise RuntimeError(f"scatter_words kernel launch failed: CUDA error {err}")
    scatter_words_rows.launches += 1
    return out


scatter_words_rows.launches = 0
