"""Per-band mantissa bit allocation (counterpart of tac/bitalloc.py, SPEC.md §6).

Decisions depend on floats only through ``smr_q`` (the SMR snapped to a
1/16-dB grid) and ``need = smr_q − DEC[alloc]`` with DEC a shared table,
so any implementation of the greedy chain gives the same integers. The
chain itself lives beside kernel K1 (tac_torch/ops/alloc.py), whose plain
version is the row-batched loop used here; parity runs it in f64.
"""

from __future__ import annotations

import torch

from tac_torch.ops.alloc import (DB_PER_BIT, DEC_TABLE, MANT_MAX,  # noqa: F401
                                 water_fill_rows_plain)

SMR_GRID = 16.0        # SMR decision grid: 1/16 dB


def snap_smr(smr: torch.Tensor) -> torch.Tensor:
    """Snap SMRs to the 1/16 dB decision grid (SPEC.md §10 item 2);
    torch.round rounds half to even, as jnp.round does."""
    return torch.round(smr * SMR_GRID) / SMR_GRID


def water_fill(smr_q: torch.Tensor, n_lines: torch.Tensor, budget: int,
               max_mant: int = MANT_MAX) -> torch.Tensor:
    """Greedy water-filling with lone-bit cleanup over rows.

    smr_q: float [..., B] grid-snapped SMRs; n_lines: int [B] or [..., B]
    (0 = band above Nyquist, never allocated); budget: mantissa bits per
    row. Returns int32 [..., B] with values in {0} ∪ [2, max_mant]."""
    lead, nb = smr_q.shape[:-1], smr_q.shape[-1]
    rows = smr_q.reshape(-1, nb)
    nl = n_lines if n_lines.dim() == 1 else n_lines.reshape(-1, nb)
    budgets = torch.full((rows.shape[0],), budget, dtype=torch.int64,
                         device=smr_q.device)
    return water_fill_rows_plain(rows, nl, budgets,
                                 max_mant=max_mant).reshape(*lead, nb)


def allocate(smr: torch.Tensor, n_lines: torch.Tensor, budget: int,
             mode: str = "greedy", max_mant: int = MANT_MAX) -> torch.Tensor:
    """Dispatch over allocation modes: greedy / const_mnr water-fill the
    masked SMR, const_snr the band-peak SPL, uniform an all-zero need."""
    if mode == "uniform":
        smr = torch.zeros_like(smr)
    return water_fill(snap_smr(smr), n_lines, budget, max_mant)


def alloc_to_code(alloc: torch.Tensor) -> torch.Tensor:
    """alloc ∈ {0} ∪ [2,16] → 4-bit code c (c=0 ⇔ alloc=0, else c=alloc-1)."""
    return torch.where(alloc > 0, alloc - 1, 0).to(torch.int32)


def code_to_alloc(code: torch.Tensor) -> torch.Tensor:
    return torch.where(code > 0, code + 1, 0).to(torch.int32)
