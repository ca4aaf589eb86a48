"""Kernel K3: the whole VBR bit-reservoir chain over frames, per lane.

Replaces tac/ops/pallas_vbr_scan.py:vbr_reservoir_scan (_scan_kernel). The
reservoir makes a lane's frames sequentially dependent (SPEC.md §8): frame
f allocates under budget = base + res, prices its mantissas raw against
each trained table set, banks what it saved, and hands the fill on:

    alloc = water-fill(smr_q[f], base + res)          (kernel K1's chain)
    raw   = Σ_b alloc_b · n_lines_b
    huf_s = Σ_b (alloc_b ∈ [2, 8] ? bits_huf[f, ·, b, 7s + alloc_b − 2]
                                  : alloc_b · n_lines_b)
    best  = min_s huf_s, the first minimum (ties: raw ≤ set 1 ≤ 2 ≤ 3)
    tid   = best < raw ? argfirstmin + 1 : 0;  used = min(raw, best)
    res   = clamp(res + base − used, 0, cap)

The CUDA source is tac_torch/csrc/vbr_scan.cu (one warp per lane, the
frame loop inside the kernel, each frame's rows copied into shared memory
frames ahead of the chain, sharing water_fill.cuh with K1);
``vbr_reservoir_scan_plain`` is the same chain in plain PyTorch, a Python
loop over frames, and is what the wrapper runs for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from tac_torch import _build
from tac_torch.huffman import MAX_M, MIN_M, N_TAB
from tac_torch.ops.alloc import (MANT_MAX, MAX_BANDS, fill_dec_table,
                                 water_fill_rows_plain)

MAX_SETS = 3           # tableId is two bits: raw + three trained sets
# K3's warm start, as tac's K3 runs it (tac/ops/pallas_vbr_scan.py): one
# round of 12 bisection steps; the chain's integers are the same at any
# setting, and the kernel (built with _build.WARM_START) and its plain
# version take the same steps
WARM_ROUNDS, WARM_BISECT = _build.WARM_START["vbr_scan"]


def vbr_price(alloc: torch.Tensor, bits_huf: torch.Tensor,
              n_lines: torch.Tensor):
    """Coded mantissa bits of an allocation (tac/codec.py:_vbr_price).

    alloc int [L, B]; bits_huf int [L, B, 7·S]; n_lines int [B] or [L, B] →
    (raw int64 [L], hufs int64 [L, S]): raw = Σ_b alloc·n_lines, and each
    set swaps in its coded band cost where the allocation is codable."""
    alloc = alloc.to(torch.int64)
    raw_b = alloc * n_lines
    codable = (alloc >= MIN_M) & (alloc <= MAX_M)
    col = torch.clamp(alloc - MIN_M, 0, N_TAB - 1)[..., None]
    hufs = []
    for si in range(bits_huf.shape[-1] // N_TAB):
        cell = bits_huf[..., si * N_TAB:(si + 1) * N_TAB].to(torch.int64)
        hufs.append(torch.where(codable, torch.gather(cell, -1, col)[..., 0],
                                raw_b).sum(-1))
    return raw_b.sum(-1), torch.stack(hufs, dim=-1)


def vbr_reservoir_scan_plain(smr_q: torch.Tensor, bits_huf: torch.Tensor,
                             n_lines: torch.Tensor, res0: torch.Tensor, *,
                             base: int, cap: int, max_mant: int = MANT_MAX):
    """Plain PyTorch K3, in smr_q's float type (f32 fast, f64 parity).

    smr_q [F, L, B] grid-snapped SMRs, frame-major; bits_huf int
    [F, L, B, 7·S]; n_lines int [B] or [F, L, B]; res0 int [L]. Returns
    (alloc int32 [F, L, B], tid, used, res int32 [F, L]). The water-fill
    runs with K3's warm start, and its loop trips add to
    ``water_fill_rows_plain.trips``."""
    f, lanes, nb = smr_q.shape
    dev = smr_q.device
    res = res0.to(torch.int64)
    allocs = torch.empty((f, lanes, nb), dtype=torch.int32, device=dev)
    tids, useds, ress = (torch.empty((f, lanes), dtype=torch.int32, device=dev)
                         for _ in range(3))
    for i in range(f):
        nl = n_lines if n_lines.dim() == 1 else n_lines[i]
        alloc = water_fill_rows_plain(smr_q[i], nl, base + res,
                                      max_mant=max_mant, rounds=WARM_ROUNDS,
                                      n_bisect=WARM_BISECT)
        raw, hufs = vbr_price(alloc, bits_huf[i], nl)
        best, tid_h = hufs[:, 0], torch.ones_like(raw)
        for si in range(1, hufs.shape[1]):
            beat = hufs[:, si] < best                # strict: first minimum
            tid_h = torch.where(beat, si + 1, tid_h)
            best = torch.minimum(best, hufs[:, si])
        used = torch.minimum(raw, best)
        res = torch.clamp(res + base - used, 0, cap)
        allocs[i] = alloc
        tids[i] = torch.where(best < raw, tid_h, 0)
        useds[i] = used
        ress[i] = res
    return allocs, tids, useds, ress


def _lib(device: int):
    """The kernel's C entry; fills the DEC table on `device` at first use."""
    fill_dec_table("vbr_scan", "tac_vbr_scan_set_dec", device)
    return _build.entry("vbr_scan", "tac_vbr_reservoir_scan",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p])


def vbr_reservoir_scan(smr_q: torch.Tensor, bits_huf: torch.Tensor,
                       n_lines: torch.Tensor, res0: torch.Tensor, *,
                       base: int, cap: int, max_mant: int = MANT_MAX):
    """K3: the bit-reservoir chain of every lane (tac vbr_reservoir_scan).

    smr_q f32 [F, L, B≤128] grid-snapped SMRs, frame-major; bits_huf int32
    [F, L, B, 7·S] (S = 1..3); n_lines int32 [B] (shared) or [F, L, B]
    (per frame); res0 int32 [L]; base, cap: per-frame budget and reservoir
    cap. Returns (alloc int32 [F, L, B], tid, used, res int32 [F, L]).

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count the launch in ``vbr_reservoir_scan.launches``) or raise."""
    if smr_q.device.type == "cpu":
        return vbr_reservoir_scan_plain(smr_q, bits_huf, n_lines, res0,
                                        base=base, cap=cap, max_mant=max_mant)
    if smr_q.device.type != "cuda":
        raise ValueError(f"vbr_reservoir_scan: unsupported device {smr_q.device}")
    if smr_q.dim() != 3 or bits_huf.dim() != 4:
        raise ValueError("vbr_reservoir_scan: smr_q must be [F, L, B] and "
                         "bits_huf [F, L, B, 7*S]")
    f, lanes, nb = smr_q.shape
    for name, t, dt in (("smr_q", smr_q, torch.float32),
                        ("bits_huf", bits_huf, torch.int32),
                        ("n_lines", n_lines, torch.int32),
                        ("res0", res0, torch.int32)):
        if t.device != smr_q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"vbr_reservoir_scan: {name} must be a contiguous "
                             f"{dt} tensor on {smr_q.device}")
    if not 0 < nb <= MAX_BANDS:
        raise ValueError(f"vbr_reservoir_scan takes 1..{MAX_BANDS} bands, "
                         f"got {nb}")
    n_sets, rest = divmod(bits_huf.shape[-1], N_TAB)
    if (bits_huf.shape[:3] != smr_q.shape or rest
            or not 1 <= n_sets <= MAX_SETS):
        raise ValueError(f"vbr_reservoir_scan: bits_huf must be [F, L, B, 7*S] "
                         f"with S in 1..{MAX_SETS}, got {tuple(bits_huf.shape)}")
    if n_lines.shape not in ((nb,), (f, lanes, nb)) or res0.shape != (lanes,):
        raise ValueError("vbr_reservoir_scan: n_lines must be [B] or "
                         "[F, L, B] and res0 [L]")
    dev = smr_q.device
    alloc = torch.empty((f, lanes, nb), dtype=torch.int32, device=dev)
    tid, used, res = (torch.empty((f, lanes), dtype=torch.int32, device=dev)
                      for _ in range(3))
    if f == 0 or lanes == 0:
        return alloc, tid, used, res
    device = dev.index or 0
    err = _lib(device)(smr_q.data_ptr(), bits_huf.data_ptr(), n_lines.data_ptr(),
                       res0.data_ptr(), alloc.data_ptr(), tid.data_ptr(),
                       used.data_ptr(), res.data_ptr(), f, lanes, nb, n_sets,
                       int(n_lines.dim() == 3), int(base), int(cap),
                       min(max_mant, MANT_MAX), device,
                       torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"vbr_scan kernel launch failed: CUDA error {err}")
    vbr_reservoir_scan.launches += 1
    return alloc, tid, used, res


vbr_reservoir_scan.launches = 0
