"""Kernel K7: row-invariant f32 segment sums of the fast encoders.

A kernel of the port with no TPU counterpart. The fast psy model's noise
maskers sum each band's lines (``psy.band_slice_sum``), and block
switching's transient detector reads a prefix sum of first-difference
energies at eight segment edges (``blockswitch.transient_flags``). Both
were library cumsums, whose order on the card changes with the number of
rows (a one- or two-row stream push is summed otherwise than a batch).
``segment_sums`` adds each segment's entries in index order in double and
rounds once. The CUDA source is tac_torch/csrc/segment_sum.cu.
``segment_sums_plain``, what the wrapper runs for tensors on the CPU, is
the last entry of a per-segment cumsum, which the CPU keeps in double in
the same order: the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tac_torch import _build

MAX_SEGMENTS = 64             # the kernel's by-value segment table


def segment_sums_plain(x: torch.Tensor, ranges) -> torch.Tensor:
    """Plain K7: x [..., L], ranges ((start, end), ...) → [..., S], each
    segment's entries added left to right (the last entry of its cumsum);
    an empty segment sums to 0."""
    cols = [x[..., s:e].cumsum(-1)[..., -1] if e > s
            else torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
            for s, e in ranges]
    return torch.stack(cols, dim=-1)


@functools.lru_cache(maxsize=64)
def _bounds(ranges: tuple, length: int):
    """The kernel's host bound table for segments of rows of `length`: the
    starts, then the ends; raises on a table the kernel does not take."""
    if not 0 < len(ranges) <= MAX_SEGMENTS or any(
            not 0 <= s <= e <= length for s, e in ranges):
        raise ValueError(f"segment_sums takes 1..{MAX_SEGMENTS} segments "
                         f"within [0, {length}], got {ranges}")
    flat = [int(s) for s, _ in ranges] + [int(e) for _, e in ranges]
    return (ctypes.c_int * len(flat))(*flat)


def _lib():
    return _build.entry("segment_sum", "tac_segment_sum",
                        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def segment_sums(x: torch.Tensor, ranges) -> torch.Tensor:
    """K7: x f32 [..., L], ranges ((start, end), ...) with 0 <= start <= end
    <= L → f32 [..., S], each segment added in index order in double and
    rounded once (the leading axes of x are rows).

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count the launch in ``segment_sums.launches``) or raise."""
    if x.device.type == "cpu":
        return segment_sums_plain(x, ranges)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sums: unsupported device {x.device}")
    launch = _lib()
    if x.dtype != torch.float32 or x.dim() < 1:
        raise ValueError(f"segment_sums: x must be a float32 [..., L] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    ranges = tuple((int(s), int(e)) for s, e in ranges)
    length = x.shape[-1]
    bounds = _bounds(ranges, length)
    x2 = x.reshape(-1, length).contiguous()
    rows = x2.shape[0]
    out = torch.empty((rows, len(ranges)), dtype=torch.float32, device=x.device)
    if rows:
        err = launch(x2.data_ptr(), out.data_ptr(), rows, length, len(ranges),
                     ctypes.cast(bounds, ctypes.c_void_p),
                     x.device.index or 0,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                               f"{err}")
        segment_sums.launches += 1
    return out.reshape(*x.shape[:-1], len(ranges))


segment_sums.launches = 0
