"""Kernel K1: the greedy water-fill bit allocation over rows of bands.

Replaces tac/ops/pallas_alloc.py:water_fill_rows (warm=True), whose
Pallas body is warm_start_tile + water_fill_tile. The CUDA source is
tac_torch/csrc/water_fill.cu (the chain itself in water_fill.cuh, shared
with kernel K3); ``water_fill_rows_plain`` below is the same
decision chain in plain PyTorch, batched over rows, and is what the
wrapper runs for tensors on the CPU.

Decision chain (SPEC.md §6, exact vs tac/bitalloc.py:water_fill):
  * warm start: a water-level bisection (1 round × 8 steps) grants the
    prefix of the descending event order in closed form — exact for any
    converged level (tac/bitalloc.py:_warm_start has the lemma);
  * loop to a fixpoint: grant to the eligible band of largest
    need = smr − DEC[alloc] (ties to the lowest band), k bits at once
    while it stays strictly ahead of the runner-up; when nothing is
    affordable, free the highest band holding a lone bit.
``need`` is one subtraction of a table value, never a fused multiply-add.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tac_torch import _build

MANT_MAX = 16          # max mantissa bits per line
DB_PER_BIT = 6.02      # SNR gain per granted bit
# DEC[k] = 6.02·k, the shared decrement table (k = 0..MANT_MAX)
DEC_TABLE = np.arange(MANT_MAX + 1, dtype=np.float64) * DB_PER_BIT
MAX_BANDS = 128        # four bands per lane of a warp in the kernel
# K1's warm start, rounds x water-level bisection steps, as the kernel is
# built with it (_build.WARM_START)
WARM_ROUNDS, WARM_BISECT = _build.WARM_START["water_fill"]

_DEC32 = np.ascontiguousarray(DEC_TABLE, np.float32)


def _dec(dtype, device) -> torch.Tensor:
    return torch.as_tensor(DEC_TABLE, dtype=dtype, device=device)


def _warm_start(smr, nl, valid, rem, dec, m_cap: int, rounds: int,
                n_bisect: int):
    """Row-batched mirror of tac's warm_start_tile: smr [R, B], nl [R, B],
    rem [R, 1] → (alloc0 [R, B], rem [R, 1])."""
    neg = torch.tensor(float("-inf"), dtype=smr.dtype, device=smr.device)
    big = torch.tensor(1e30, dtype=smr.dtype, device=smr.device)
    keys = torch.where(valid[..., None], smr[..., None] - dec[:m_cap], neg)
    alloc0 = torch.zeros(smr.shape, dtype=torch.int64, device=smr.device)
    for _ in range(rounds):
        # bands unaffordable at the round's start stay so through its whole
        # grant descent (remaining only shrinks): their events drop out
        afford = nl <= rem
        keys_r = torch.where(afford[..., None], keys, neg)
        live_any = valid & afford & (alloc0 < m_cap)
        top = torch.where(live_any, smr - dec[alloc0], neg)
        hi = top.amax(-1, keepdim=True)
        lo = torch.where(live_any, keys_r[..., m_cap - 1],
                         big).amin(-1, keepdim=True) - 1.0

        def granted(t, keys_r=keys_r, alloc0=alloc0):
            cnt = (keys_r > t[..., None]).sum(-1)
            return torch.clamp(cnt - alloc0, min=0)

        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            cost = (granted(mid) * nl).sum(-1, keepdim=True)
            good = cost <= rem
            lo = torch.where(good, lo, mid)
            hi = torch.where(good, mid, hi)
        g = granted(hi)
        alloc0 = alloc0 + g
        rem = rem - (g * nl).sum(-1, keepdim=True)
    return alloc0, rem


def water_fill_rows_plain(smr_q: torch.Tensor, n_lines: torch.Tensor,
                          budgets: torch.Tensor, *, max_mant: int = MANT_MAX,
                          rounds: int = WARM_ROUNDS,
                          n_bisect: int = WARM_BISECT) -> torch.Tensor:
    """Plain PyTorch K1: the decision chain of warm_start_tile +
    water_fill_tile, batched over rows, in smr_q's float type (f32 for the
    fast path, f64 for parity).

    smr_q [R, B] grid-snapped SMRs; n_lines int [B] or [R, B]; budgets
    int [R]. Returns int32 [R, B] allocations. ``rounds`` × ``n_bisect`` is
    the warm start (K1's 1 × 8 by default; K3 runs 1 × 12; 0 rounds is a
    cold start): the allocations are the same at any setting, only the
    number of loop trips differs. Every call adds its rows' loop trips
    (grants + freezes after the warm start) to
    ``water_fill_rows_plain.trips``."""
    r, nb = smr_q.shape
    dev = smr_q.device
    max_mant = min(max_mant, MANT_MAX)
    dec = _dec(smr_q.dtype, dev)
    neg = torch.tensor(float("-inf"), dtype=smr_q.dtype, device=dev)
    nl = n_lines.to(torch.int64).expand(r, nb)
    valid = nl > 0
    band = torch.arange(nb, device=dev)
    alloc, rem = _warm_start(smr_q, nl, valid, budgets.to(torch.int64)[:, None],
                             dec, max_mant, rounds, n_bisect)
    live = valid.clone()            # valid and not frozen
    mm = torch.arange(max_mant, device=dev)
    dec_m = dec[:max_mant]
    trips = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        need = smr_q - dec[alloc]
        eligible = live & (alloc < max_mant) & (nl <= rem)
        any_grant = eligible.any(-1, keepdim=True)
        # grant: argmax need over eligible bands, ties to the lowest band
        masked = torch.where(eligible, need, neg)
        mx = masked.amax(-1, keepdim=True)
        bsel = torch.where(eligible & (masked == mx), band, nb).amin(
            -1, keepdim=True)
        # (a row with no eligible band reads band nb - 1: it does not grant)
        at = bsel.clamp(max=nb - 1)
        n_b, smr_b, alloc_b = nl.gather(-1, at), smr_q.gather(-1, at), \
            alloc.gather(-1, at)
        need2 = torch.where(eligible & (band != bsel), need, neg).amax(
            -1, keepdim=True)
        # multi-grant: k = #{m in [alloc_b, max_mant) : smr_b - DEC[m] > need2}
        k = ((mm >= alloc_b) & (smr_b - dec_m > need2)).sum(-1, keepdim=True)
        k = torch.minimum(k, max_mant - alloc_b)
        k = torch.minimum(k, torch.div(rem, n_b.clamp(min=1),
                                       rounding_mode="floor"))
        k = k.clamp(min=1)
        # freeze: the highest band holding a lone bit returns it for good (on
        # a row without one, the freeze changes nothing)
        lone = (alloc == 1) & live
        any_lone = lone.any(-1, keepdim=True)
        fhot = lone & (band == torch.where(lone, band, -1).amax(-1, keepdim=True))
        active = any_grant | any_lone
        if not bool(active.any()):
            water_fill_rows_plain.trips += int(trips)
            return alloc.to(torch.int32)
        trips += active.sum()
        alloc = torch.where(any_grant, alloc.scatter_add(-1, at, k),
                            torch.where(fhot, 0, alloc))
        rem = torch.where(any_grant, rem - k * n_b,
                          rem + torch.where(fhot, nl, 0).sum(-1, keepdim=True))
        live = live & ~(fhot & ~any_grant)


water_fill_rows_plain.trips = 0

_dec_filled: set = set()      # (entry name, device) whose DEC table is filled


def fill_dec_table(kernel: str, entry: str, device: int) -> None:
    """Fill the constant DEC table of one kernel library on `device`, once
    (every library that includes water_fill.cuh has its own copy)."""
    if (entry, device) in _dec_filled:
        return
    set_dec = _build.entry(kernel, entry, [ctypes.c_void_p, ctypes.c_int])
    err = set_dec(_DEC32.ctypes.data, device)
    if err:
        raise RuntimeError(f"{entry}: DEC table upload failed: CUDA error {err}")
    _dec_filled.add((entry, device))


def _lib(device: int):
    """The kernel's C entry; fills the DEC table on `device` at first use."""
    fill_dec_table("water_fill", "tac_water_fill_set_dec", device)
    return _build.entry("water_fill", "tac_water_fill_rows",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])


def water_fill_rows(smr_q: torch.Tensor, n_lines: torch.Tensor,
                    budgets: torch.Tensor, *, max_mant: int = MANT_MAX
                    ) -> torch.Tensor:
    """K1: greedy water-fill of every row (tac water_fill_rows, warm=True).

    smr_q f32 [R, B≤128] grid-snapped SMRs; n_lines int32 [B] (shared) or
    [R, B] (per row); budgets int32 [R]. Returns int32 [R, B].

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count the launch in ``water_fill_rows.launches``) or raise."""
    if smr_q.device.type == "cpu":
        return water_fill_rows_plain(smr_q, n_lines, budgets, max_mant=max_mant)
    if smr_q.device.type != "cuda":
        raise ValueError(f"water_fill_rows: unsupported device {smr_q.device}")
    r, nb = smr_q.shape
    for name, t, dt in (("smr_q", smr_q, torch.float32),
                        ("n_lines", n_lines, torch.int32),
                        ("budgets", budgets, torch.int32)):
        if t.device != smr_q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"water_fill_rows: {name} must be a contiguous "
                             f"{dt} tensor on {smr_q.device}")
    if not 0 < nb <= MAX_BANDS:
        raise ValueError(f"water_fill_rows takes 1..{MAX_BANDS} bands, got {nb}")
    if n_lines.shape not in ((nb,), (r, nb)) or budgets.shape != (r,):
        raise ValueError("water_fill_rows: n_lines must be [B] or [R, B] and "
                         "budgets [R]")
    out = torch.empty((r, nb), dtype=torch.int32, device=smr_q.device)
    if r == 0:
        return out
    device = smr_q.device.index or 0
    err = _lib(device)(smr_q.data_ptr(), n_lines.data_ptr(), budgets.data_ptr(),
                       out.data_ptr(), r, nb, nb if n_lines.dim() == 2 else 0,
                       min(max_mant, MANT_MAX), device,
                       torch.cuda.current_stream(smr_q.device).cuda_stream)
    if err:
        raise RuntimeError(f"water_fill kernel launch failed: CUDA error {err}")
    water_fill_rows.launches += 1
    return out


water_fill_rows.launches = 0
