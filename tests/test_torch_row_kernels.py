"""PyTorch port: CPU emulations of the arithmetic of K6 (tac_torch/csrc/
row_gemm.cu, a register-blocked FFMA sgemm) and K7 (tac_torch/csrc/
segment_sum.cu, a warp per row), held against their plain versions.

- K6: every output one chain of fused multiply-adds in k order from 0 (the
  product of two f32 exact in f64, the sum rounded once to f32), whatever
  the tile: within K·2⁻²³·Σ|a||b| of ``row_matmul_plain`` at every product
  shape of the presets, and row-invariant at M ∈ {1, 3, 2 049} (the tile
  the kernel picks is checked on the card, tests/test_torch_cuda.py);
- K7: the row staged in 1 024-float chunks, one double accumulator per
  segment (a lane takes segments i and i + 32) carried across chunks, the
  transient detector's nested prefixes included: bit for bit
  ``segment_sums_plain``.
"""

import numpy as np
import pytest
import torch

from tac_torch import bands
from tac_torch.config import PRESETS
from tac_torch.ops import row_gemm as k6
from tac_torch.ops import segment_sum as k7

CHUNK, LANES = 1024, 32       # K7's staged floats a chunk, lanes a warp


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _k6_emulated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K6's arithmetic in plain torch: acc = fma(a[:, k], b[k, :], acc) for
    k in order from acc = 0, each fused multiply-add as the f64 sum of the
    f32 accumulator and the exact f64 product, rounded to f32 (elementwise:
    no row's value touches another's)."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    ad, bd = a.double(), b.double()
    for i in range(b.shape[0]):
        acc = (acc.double() + ad[:, i, None] * bd[None, i, :]).float()
    return acc


def _noisy_rows(rng, m, k):
    t = np.arange(m * k).reshape(m, k) / 44100.0
    return torch.from_numpy((0.4 * np.sin(2 * np.pi * 440 * t)
                             + 0.05 * rng.standard_normal((m, k))
                             ).astype(np.float32))


def _product_shapes():
    hs = {cfg.n_mdct_lines for cfg in PRESETS.values()}
    hs |= {cfg.n_mdct_lines_short for cfg in PRESETS.values()
           if cfg.use_block_switch}
    return sorted(((2 * h, h) for h in hs), reverse=True)


@pytest.mark.parametrize("k,n", _product_shapes())
def test_k6_emulation_within_its_bound_of_plain(k, n):
    """K6's arithmetic at each product shape of the presets, on noisy
    rows: within K·2⁻²³·Σ|a||b| of the plain version per output, and far
    inside it."""
    rng = np.random.default_rng(k)
    a = _noisy_rows(rng, 5, k)
    b = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)
                          ).astype(np.float32))
    got = _k6_emulated(a, b)
    want = k6.row_matmul_plain(a, b)
    scale = (a.abs().double() @ b.abs().double()) * (k * 2.0 ** -23)
    ratio = float(((got.double() - want.double()).abs() / scale).max())
    assert ratio <= 1.0
    assert ratio <= 0.05, ratio


def test_k6_emulation_rows_invariant():
    """K6's arithmetic reads no other row: a row's outputs are the same
    bits at M = 1, 3 and 2 049 (the 2 049th row in a tile of its own)."""
    rng = np.random.default_rng(1)
    a = _noisy_rows(rng, 2049, 64)
    b = torch.from_numpy((rng.standard_normal((64, 32)) / 8).astype(np.float32))
    full = _k6_emulated(a, b)
    for m in (1, 3):
        assert torch.equal(_k6_emulated(a[:m], b), full[:m]), m
    assert torch.equal(_k6_emulated(a[2048:], b), full[2048:])


def _k7_emulated(x: np.ndarray, ranges) -> np.ndarray:
    """K7's additions in numpy: the row staged CHUNK floats at a time from
    the lowest start, a double accumulator per segment carried from chunk to
    chunk (lane i takes segments i and i + 32). Vectorized over rows: each
    row's additions are its own."""
    rows, nseg = x.shape[0], len(ranges)
    out = np.zeros((rows, nseg), np.float32)
    live = [(s, e) for s, e in ranges if s < e]
    lo = min((s for s, _ in live), default=0)
    hi = max((e for _, e in live), default=0)
    acc = np.zeros((rows, 2 * LANES))
    for c0 in range(lo, hi, CHUNK):
        buf = x[:, c0:min(c0 + CHUNK, hi)].astype(np.float64)
        for lane in range(LANES):
            for seg in (lane, lane + LANES):
                if seg < nseg:
                    s, e = ranges[seg]
                    for i in range(max(s, c0) - c0, min(e, c0 + CHUNK) - c0):
                        acc[:, seg] += buf[:, i]
    out[:] = acc[:, :nseg]
    return out


def _spread_rows(rng, m, length):
    return (rng.random((m, length))
            * np.exp(4 * rng.standard_normal((m, length)))).astype(np.float32)


@pytest.mark.parametrize("case", ["transient_prefixes", "bands_1024",
                                  "bands_128", "segs_33", "segs_64",
                                  "long_rows", "long_prefixes"])
def test_k7_emulation_equals_plain(case):
    """K7's additions equal the plain version bit for bit: the transient
    detector's nested prefixes (rows of 1 023), the psy bands at H = 1 024
    and 128, 33 and 64 segments (a lane takes two), and rows longer than
    one chunk with segments, and nested prefixes, across chunk edges."""
    rng = np.random.default_rng(len(case))
    tables = []
    if case == "transient_prefixes":
        x = _spread_rows(rng, 9, 1023)
        tables.append(tuple((0, int(e)) for e in
                            np.round(np.arange(9) * 1022 / 8).astype(int)))
    elif case.startswith("bands"):
        h = int(case.split("_")[1])
        x = _spread_rows(rng, 9, h)
        tables.append(tuple(bands.band_line_ranges(44100, h)))
    elif case.startswith("segs"):
        nseg = int(case.split("_")[1])
        x = _spread_rows(rng, 7, 600)
        cuts = np.sort(rng.integers(0, 601, 2 * nseg)).reshape(nseg, 2)
        tables.append(tuple((int(s), int(e)) for s, e in cuts))
    elif case == "long_rows":
        x = _spread_rows(rng, 5, 2600)
        tables.append(((10, 2600), (1000, 1030), (1023, 1025), (0, 0),
                       (2047, 2600)))
    else:
        x = _spread_rows(rng, 5, 2600)
        tables.append(((0, 0), (0, 1024), (0, 1500), (0, 1500), (0, 2600)))
    for ranges in tables:
        want = k7.segment_sums_plain(torch.from_numpy(x), ranges).numpy()
        np.testing.assert_array_equal(_k7_emulated(x, ranges), want)
