"""Kernel K6: the row-invariant f32 product of the fast encoders.

A kernel of the port with no TPU counterpart: tac leaves these products to
XLA as plain ``jnp.dot`` (tac/codec.py:153, the window-fused MDCT;
tac/psy.py:293, the hann-fused DFT; tac/blockswitch.py:165 / :177, the
long and short MDCTs). A library sgemm picks its tiling, and with it the
order of each k-sum, by the shape of the whole batch, so a row's lines
depended on the rows beside it, and at a 1/16-dB grid tie a clip's bytes
on its batch, its stream push size or its rank. ``row_matmul`` computes
``a @ b`` so that each output row is a function of its own row of ``a``
and of ``b`` alone. The CUDA source is tac_torch/csrc/row_gemm.cu: each
output one chain of fused multiply-adds in k order, f32 on the CUDA cores,
in a tile chosen by N alone (``tile``). The tensor cores are left out: a
split-TF32 ``wgmma`` route was row-invariant on the card but moved the fast
encodes of pure tones by more than the 0.1 dB that chip_smoke.py allows
against parity (the source's header says more). ``row_matmul_plain`` is
the plain version, what the wrapper runs for tensors on the CPU: one
identical library call per row.
"""

from __future__ import annotations

import ctypes

import torch

from tac_torch import _build

MAX_ROWS = 2 ** 31 - 1 - 128  # the kernel's int row index


def row_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain K6: a [..., K] @ b [K, N] → [..., N], every row of a through one
    identical library call ([1, K] @ [K, N] from one buffer, on one
    thread), so that no row's sums depend on the number of rows, on the
    row's place or on the caller's thread count (a batched library product
    takes other orders for other row counts, on the CPU too)."""
    k, n = b.shape
    a2 = a.reshape(-1, k)
    out = torch.empty((a2.shape[0], n), dtype=a.dtype, device=a.device)
    buf = torch.empty((1, k), dtype=a.dtype, device=a.device)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # one row is too little work to split
    try:
        for i in range(a2.shape[0]):
            buf.copy_(a2[i:i + 1])
            torch.mm(buf, b, out=out[i:i + 1])
    finally:
        torch.set_num_threads(threads)
    return out.reshape(*a.shape[:-1], n)


def _lib():
    return _build.entry("row_gemm", "tac_row_gemm",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])


def tile(k: int, n: int) -> tuple:
    """(BM, BN), the kernel's output tile for a [K, N] product
    (csrc/row_gemm.cu): a function of the basis' shape alone, never of the
    number of rows, so that a 2 048-row launch has 128 blocks at every
    product shape of the presets."""
    code = _build.entry("row_gemm", "tac_row_gemm_tile",
                        [ctypes.c_int] * 2)(k, n)
    return divmod(code, 1000)


def row_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K6: a f32 [..., K] @ b f32 [K, N] → f32 [..., N], each output row a
    function of its own row of a and of b alone (the leading axes of a are
    rows). K and N must be multiples of 4 on the card.

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count the launch in ``row_matmul.launches``) or raise."""
    if a.device.type == "cpu":
        return row_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"row_matmul: unsupported device {a.device}")
    launch = _lib()
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device or t.dtype != torch.float32:
            raise ValueError(f"row_matmul: {name} must be a float32 tensor "
                             f"on {a.device}")
    if (b.dim() != 2 or not b.is_contiguous() or b.data_ptr() % 16
            or a.dim() < 1 or a.shape[-1] != b.shape[0]):
        raise ValueError("row_matmul: b must be a contiguous, 16-byte aligned "
                         f"[K, N] tensor with K = a.shape[-1], got a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}")
    k, n = b.shape
    if k % 4 or n % 4:
        raise ValueError(f"row_matmul: K and N must be multiples of 4, got "
                         f"K = {k}, N = {n}")
    a2 = a.reshape(-1, k).contiguous()
    if a2.data_ptr() % 16:
        a2 = a2.clone()
    m = a2.shape[0]
    if m > MAX_ROWS:
        raise ValueError(f"row_matmul takes at most {MAX_ROWS} rows, got {m}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m:
        err = launch(a2.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                     a.device.index or 0,
                     torch.cuda.current_stream(a.device).cuda_stream)
        if err:
            raise RuntimeError(f"row_gemm kernel launch failed: CUDA error {err}")
        row_matmul.launches += 1
    return out.reshape(*a.shape[:-1], n)


row_matmul.launches = 0
