"""Kernel K5: fused 50 %-overlap framing + window-fused MDCT product.

Replaces tac/ops/pallas_mdct.py:mdct_frames_pallas (_mdct_kernel):

    out[..., f, :] = xp[..., f*h : f*h + 2h] @ basis

with xp the signal padded as ``frame_signal`` pads it (h zeros in front, to
(F+1)·h samples). The frame matrix, in which every sample appears twice, is
never built: the kernel reads its left operand straight from the padded
signal, as a matrix whose rows start h apart. The CUDA source is
tac_torch/csrc/mdct_fused.cu: the product runs on the tensor cores
(``wgmma``, fed by TMA) in full f32 accuracy by the 3×TF32 split — each
operand is its TF32 part plus the exact f32 remainder (``split_tf32``), and
three TF32 products, smallest first, share one f32 accumulator.
``mdct_frames_plain`` is the same function in plain PyTorch — an unfolded
view of the padded signal times the basis — and is what the wrapper runs
for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from tac_torch import _build
from tac_torch.dsp.mdct import num_frames


def pad_signal(x: torch.Tensor, h: int) -> torch.Tensor:
    """[..., T] → [..., (F+1)·h]: h leading zeros and the tail zero-filled,
    so that frame f is samples [f·h, f·h + 2h)."""
    t = x.shape[-1]
    return torch.nn.functional.pad(x, (h, num_frames(t, h) * h - t))


def mdct_frames_plain(x: torch.Tensor, h: int,
                      basis: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5: x [..., T], basis [2h, h] → [..., F, h], equal to
    ``frame_signal(x, h) @ basis``."""
    return pad_signal(x, h).unfold(-1, 2 * h, h) @ basis


def split_tf32(v: torch.Tensor):
    """f32 v → (big, small) with big = v rounded to TF32 (10 mantissa bits,
    to nearest, ties away from zero: PTX ``cvt.rna.tf32.f32``, what the
    kernel's pre-pass does to the signal) and small = v − big, exact in f32.
    The kernel takes the basis split here, once per call."""
    v = v.contiguous()
    big = ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return big, v - big


def _lib():
    return _build.entry("mdct_fused", "tac_mdct_frames_fused",
                        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong]
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def mdct_frames_fused(x: torch.Tensor, h: int,
                      basis: torch.Tensor) -> torch.Tensor:
    """K5: framing + MDCT in one kernel (tac mdct_frames_pallas).

    x f32 [..., T] signal; basis f32 [2h, h] window-fused MDCT basis, h a
    multiple of 4. Returns f32 [..., F, h], F = ceil(T / h) + 1, equal to
    ``frame_signal(x, h) @ basis`` up to f32 summation order.

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count the launch in ``mdct_frames_fused.launches``) or raise."""
    if x.device.type == "cpu":
        return mdct_frames_plain(x, h, basis)
    if x.device.type != "cuda":
        raise ValueError(f"mdct_frames_fused: unsupported device {x.device}")
    for name, t in (("x", x), ("basis", basis)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"mdct_frames_fused: {name} must be a float32 "
                             f"tensor on {x.device}")
    if h < 4 or h % 4 or basis.shape != (2 * h, h) or not basis.is_contiguous():
        raise ValueError("mdct_frames_fused: basis must be a contiguous "
                         "[2h, h] tensor with h a multiple of 4, got "
                         f"{tuple(basis.shape)} for h = {h}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError("mdct_frames_fused: x must be [..., T] with T >= 1")
    t = x.shape[-1]
    f = num_frames(t, h)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, t).contiguous()
    c = x2.shape[0]
    out = torch.empty((c, f, h), dtype=torch.float32, device=x.device)
    if c == 0:
        return out.reshape(*lead, f, h)
    # the padded, split signal (the kernel's pre-pass writes it: the copy
    # pad_signal makes on the CPU path) and the split basis, K-major:
    # bt[half, n, k] = basis[half·h + k, n]
    xh = torch.empty((2, c * (f + 1) * h), dtype=torch.float32, device=x.device)
    bt_big, bt_small = split_tf32(basis.reshape(2, h, h).transpose(1, 2))
    err = _lib()(x2.data_ptr(), xh[0].data_ptr(), xh[1].data_ptr(),
                 bt_big.data_ptr(), bt_small.data_ptr(), out.data_ptr(), c, t,
                 f, h, x.device.index or 0,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mdct_fused kernel launch failed: CUDA error {err}")
    mdct_frames_fused.launches += 1
    return out.reshape(*lead, f, h)


mdct_frames_fused.launches = 0
