"""Kernels K1 and K2 on an NVIDIA GPU against their plain PyTorch versions
(exact: allocations and words are integers), including the constructed
row where a fused multiply-add would flip a water-fill decision.

Marked `cuda`; run on a machine with a card:
    python -m pytest tests/test_torch_cuda.py -m cuda -q
Without one, every test skips (the fixture decides, so every worker
collects the same tests)."""

import numpy as np
import pytest
import torch

from tac_torch import bands
from tac_torch import bitalloc as tba
from tac_torch.ops import alloc as tk1
from tac_torch.ops import bitpack as tbp
from tac_torch.ops import pack as tk2

pytestmark = pytest.mark.cuda

NL = bands.lines_per_band(44100, 1024)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _k1_both(dev, smr, nl, budgets, max_mant=16):
    s = torch.as_tensor(smr, dtype=torch.float32, device=dev).contiguous()
    n = torch.as_tensor(nl, dtype=torch.int32, device=dev).contiguous()
    b = torch.as_tensor(budgets, dtype=torch.int32, device=dev).contiguous()
    before = tk1.water_fill_rows.launches
    got = tk1.water_fill_rows(s, n, b, max_mant=max_mant)
    assert tk1.water_fill_rows.launches == before + 1
    want = tk1.water_fill_rows_plain(s, n, b, max_mant=max_mant)
    torch.cuda.synchronize()
    return got.cpu().numpy(), want.cpu().numpy()


@pytest.mark.parametrize("case", ["random", "budgets", "ties", "joint",
                                  "per_row", "max_mant"])
def test_k1_kernel_equals_plain(dev, case):
    rng = np.random.default_rng(7)
    smr = tba.snap_smr(torch.tensor(rng.normal(10, 25, (3000, 25)))).numpy()
    nl, budgets, mm = NL, np.full(3000, 1282), 16
    if case == "budgets":
        budgets = rng.choice([0, 5, 12, 600, 5000], 3000)
    elif case == "ties":
        smr = np.stack([np.zeros(25), np.full(25, 90.0), np.full(25, -90.0),
                        np.r_[np.full(5, 50.0), np.full(20, -50.0)]])
        budgets = np.full(4, 1282)
    elif case == "joint":
        smr = np.concatenate([smr, smr[::-1]], 1)
        nl, budgets = np.concatenate([NL, NL]), np.full(3000, 2564)
    elif case == "per_row":
        nl = rng.integers(0, 60, (3000, 25))
    elif case == "max_mant":
        mm = 9
    got, want = _k1_both(dev, smr, nl, budgets, mm)
    np.testing.assert_array_equal(got, want)


def test_k1_fma_row(dev):
    """fl(s1 - DEC[11]) == s0 exactly, while the fused form is an ulp above:
    a contracted kernel would give [0, 12]."""
    got, want = _k1_both(dev, [[22.924339294433594, 89.14434051513672]],
                         [1, 2], [24])
    np.testing.assert_array_equal(got, [[2, 11]])
    np.testing.assert_array_equal(want, [[2, 11]])


@pytest.mark.parametrize("nf,cap", [(1075, 1518), (300, 587), (40, 6638)])
def test_k2_kernel_equals_plain(dev, nf, cap):
    rng = np.random.default_rng(nf)
    wids = rng.integers(0, 17, (2000, nf))
    wids[rng.random(wids.shape) < 0.5] = 0
    vals = rng.integers(0, 1 << 16, wids.shape) & ((1 << np.maximum(wids, 1)) - 1)
    c0, c1, word0, _ = tbp.field_words(torch.tensor(vals, device=dev),
                                       torch.tensor(wids, device=dev))
    w32 = -(-cap // 32)
    before = tk2.scatter_words_rows.launches
    got = tk2.scatter_words_rows(c0, c1, word0, w32=w32)
    assert tk2.scatter_words_rows.launches == before + 1
    want = tk2.scatter_words_rows_plain(c0, c1, word0, w32=w32)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
