"""Kernels K1-K8 on an NVIDIA GPU against their plain PyTorch versions
(K1-K4 exact: allocations, words, reservoir decisions and mantissas are
integers; K5 within 5e-6 of the largest line; K6 within K·2⁻²³·Σ|a||b|;
K7 equal to its plain version on the CPU; K8 the same kept maskers and
SMRs within 0.001 dB), including the constructed
row where a fused multiply-add would flip a water-fill decision, K6's,
K7's and K8's rows bit for bit across row counts and places, the block-switch
paths end to end, fast encodes whose bytes do not depend on the batch or
the stream's pushes, and parity bytes on DC / Nyquist equal to the CPU's.

Marked `cuda`; run on a machine with a card:
    python -m pytest tests/test_torch_cuda.py -m cuda -q
Without one, every test skips (the fixture decides, so every worker
collects the same tests)."""

import numpy as np
import pytest
import torch

from tac_torch import bands
from tac_torch import bitalloc as tba
from tac_torch import codec as tc
from tac_torch.config import PRESETS
from tac_torch.ops import alloc as tk1
from tac_torch.ops import bitpack as tbp
from tac_torch.ops import huffdec as tk4
from tac_torch.ops import mdct_fused as tk5
from tac_torch.ops import pack as tk2
from tac_torch.ops import psy_smr as tk8
from tac_torch.ops import row_gemm as tk6
from tac_torch.ops import segment_sum as tk7
from tac_torch.ops import vbr_scan as tk3

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
                                  "per_row", "bs_widths", "max_mant",
                                  "extremes"])
def test_k1_kernel_equals_plain(dev, case):
    rng = np.random.default_rng(7)
    smr = tba.snap_smr(torch.tensor(rng.normal(10, 25, (3000, 25)))).numpy()
    nl, budgets, mm = NL, np.full(3000, 1282), 16
    if case == "extremes":
        # ±0, ±inf, the 1e30 sentinel, 3e38, and rows near 1e8, where an ulp
        # (8) exceeds a bit's 6.02 dB and the warm start's events tie
        special = np.float32([0.0, -0.0, np.inf, -np.inf, 1e30, -1e30, 3e38,
                              -3e38, 1e8, -1e8, 1.5e8 + 16, 12345.678])
        smr = rng.choice(special, (3000, 25)).astype(np.float32)
        smr[:500] = rng.normal(1e8, 100, (500, 25)).astype(np.float32)
        budgets = rng.choice([0, 5, 600, 1282, 5000], 3000)
    elif case == "budgets":
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
    elif case == "bs_widths":
        # the block-switch path: long and grouped-short (K = 8) widths mixed
        short = 8 * bands.lines_per_band(44100, 128)
        nl, budgets = (np.where(rng.random((3000, 1)) < 0.3, short, NL),
                       np.full(3000, 1280))
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


@pytest.mark.parametrize("nf,cap", [(1075, 1518), (300, 587), (40, 6638),
                                    (2100, 13030)])
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


def _k3_both(dev, smr, bh, nl, res0, base, cap, max_mant=16):
    args = (tba.snap_smr(torch.as_tensor(smr, dtype=torch.float32, device=dev))
            .contiguous(),
            torch.as_tensor(bh, dtype=torch.int32, device=dev).contiguous(),
            torch.as_tensor(nl, dtype=torch.int32, device=dev).contiguous(),
            torch.as_tensor(res0, dtype=torch.int32, device=dev).contiguous())
    before = tk3.vbr_reservoir_scan.launches
    got = tk3.vbr_reservoir_scan(*args, base=base, cap=cap, max_mant=max_mant)
    assert tk3.vbr_reservoir_scan.launches == before + 1
    want = tk3.vbr_reservoir_scan_plain(*args, base=base, cap=cap,
                                        max_mant=max_mant)
    torch.cuda.synchronize()
    return [g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want]


def _k3_inputs(rng, f, lanes, nl, n_sets):
    smr = rng.normal(8, 22, (f, lanes, len(nl)))
    m = rng.integers(2, 9, (f, lanes, len(nl), 7 * n_sets))
    bh = (m * nl[None, None, :, None] * rng.uniform(0.7, 1.3, m.shape))
    return smr, bh.astype(np.int32)


@pytest.mark.parametrize("case", ["one_set", "two_sets_ties", "three_sets",
                                  "per_frame", "joint", "res0", "max_mant"])
def test_k3_kernel_equals_plain(dev, case):
    rng = np.random.default_rng(11)
    f, lanes, nl, n_sets = 8, 5, NL, {"one_set": 1, "three_sets": 3}.get(case, 2)
    base, cap, mm = 700, 2800, 16
    res0 = np.zeros(lanes, np.int32)
    if case == "joint":
        nl, base, cap = np.concatenate([NL, NL]), 1400, 5600
    smr, bh = _k3_inputs(rng, f, lanes, nl, n_sets)
    nl_arg = nl
    if case == "two_sets_ties":
        raw = (np.arange(2, 9)[None, :] * NL[:, None]).astype(np.int32)
        bh[0, 0, :, :7] = raw                      # set 1 == raw
        bh[1, 1, :, 7:] = bh[1, 1, :, :7]          # set 2 == set 1
        bh[2, 2, :, 7:] = np.minimum(bh[2, 2, :, :7], raw) - 1
    elif case == "per_frame":
        short = 2 * bands.lines_per_band(44100, 512)
        nl_arg = np.where(rng.random((f, lanes, 1)) < 0.4, short, NL)
    elif case == "res0":
        res0 = rng.integers(0, cap, lanes)
    elif case == "max_mant":
        mm = 9
    got, want = _k3_both(dev, smr, bh, nl_arg, res0, base, cap, mm)
    for g, w, what in zip(got, want, ["alloc", "tid", "used", "res"]):
        np.testing.assert_array_equal(g, w, err_msg=what)
    if case == "two_sets_ties":
        assert got[1][0, 0] != 1 and got[1][1, 1] != 2 and got[1][2, 2] == 2
    if case == "res0":                             # the split-chain property
        head, _ = _k3_both(dev, smr[:3], bh[:3], nl, res0, base, cap)
        tail, _ = _k3_both(dev, smr[3:], bh[3:], nl, head[3][-1], base, cap)
        for g, h, t in zip(got, head, tail):
            np.testing.assert_array_equal(g, np.concatenate([h, t]))


def test_k3_fma_row(dev):
    """K1's constructed row as a one-frame, one-lane chain: the shared
    decision chain must not contract smr - DEC[alloc] here either."""
    bh = np.zeros((1, 1, 2, 7), np.int32)
    got, want = _k3_both(dev, [[[22.924339294433594, 89.14434051513672]]], bh,
                         [1, 2], [0], 24, 96)
    np.testing.assert_array_equal(got[0], [[[2, 11]]])
    np.testing.assert_array_equal(want[0], [[[2, 11]]])


@pytest.mark.parametrize("case", ["b50", "b100", "lanes33"])
def test_k3_slot_templates_and_lanes(dev, case):
    """K3 at 50 and 100 bands (the 2- and 4-slot chains; K1's 4-slot chain
    beside it) and at 33 lanes. (A chain resumed across two launches from a
    nonzero res0 is test_k3_kernel_equals_plain's res0 case.)"""
    rng = np.random.default_rng(13)
    f, lanes, nl, base, cap = 9, 5, NL, 700, 2800
    if case in ("b50", "b100"):
        k = 2 if case == "b50" else 4
        nl = np.concatenate([NL] * k)
        base, cap = k * 700, k * 2800
    elif case == "lanes33":
        lanes = 33
    smr, bh = _k3_inputs(rng, f, lanes, nl, 2)
    got, want = _k3_both(dev, smr, bh, nl, np.zeros(lanes), base, cap)
    for g, w, what in zip(got, want, ["alloc", "tid", "used", "res"]):
        np.testing.assert_array_equal(g, w, err_msg=f"{case}: {what}")
    if case == "b100":
        rows = tba.snap_smr(torch.tensor(rng.normal(10, 25, (500, 100)))).numpy()
        k1_got, k1_want = _k1_both(dev, rows, nl, np.full(500, 4 * 1282))
        np.testing.assert_array_equal(k1_got, k1_want)


def _k4_both(dev, words, mant_start, m_line, tid, huff):
    """K4's multi-set entry and its plain version on the same inputs, each
    on its own copy of a random raw reading (the kernel fills its copy's
    Huffman rows in place)."""
    rng = np.random.default_rng(len(words))
    args = [torch.as_tensor(a, dtype=torch.int32, device=dev).contiguous()
            for a in (words, mant_start, m_line, tid)]
    raw = torch.as_tensor(rng.integers(0, 1 << 16, np.shape(m_line)),
                          dtype=torch.int32, device=dev)
    before = tk4.huffman_decode_sets.launches
    got = tk4.huffman_decode_sets(*args, raw.clone(), huff)
    assert tk4.huffman_decode_sets.launches == before + 1
    want = tk4.huffman_decode_sets_plain(*args, raw.clone(), huff)
    torch.cuda.synchronize()
    return got.cpu().numpy(), want.cpu().numpy(), raw.cpu().numpy()


def _random_rows(rng, k, h, w32):
    words = rng.integers(0, 1 << 32, (k, w32), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    m_line = rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 13, 16], (k, h))
    return words, rng.integers(0, 200, k), m_line, rng.choice([0, 1, 2, 3, 7], k)


@pytest.mark.parametrize("sid", [1, 2, 3, 0])
@pytest.mark.parametrize("shape", [(300, 128, 128), (70, 100, 6)])
def test_k4_kernel_equals_plain_on_random_bits(dev, sid, shape):
    """Random payload bits and sizes of every class (m = 0, 1, [2, 8] with
    escapes under set 3, 9..16) and random tids in {0, 1, 2, 3, 7}, under
    set `sid` alone (as tableId 1; 0: all three sets); the narrow shape
    walks past the payload, where both clip to the last word; H = 100 is no
    multiple of the tile."""
    k, h, w32 = shape
    rng = np.random.default_rng(100 * sid + h)
    huff = tc.make_consts(PRESETS["vbr-huffman"], dev).huff
    huff = huff if sid == 0 else (huff[sid - 1],)
    words, mant_start, m_line, tid = _random_rows(rng, k, h, w32)
    got, want, raw = _k4_both(dev, words, mant_start, m_line, tid, huff)
    np.testing.assert_array_equal(got, want)
    walked = (tid >= 1) & (tid <= len(huff))
    np.testing.assert_array_equal(got[~walked], raw[~walked])


def test_k4_all_raw_rows_keep_their_reading(dev):
    """A decode with no Huffman-coded row: the launch returns at once and
    every row keeps its raw mantissas."""
    rng = np.random.default_rng(9)
    huff = tc.make_consts(PRESETS["vbr-huffman"], dev).huff
    words, mant_start, m_line, _ = _random_rows(rng, 200, 1024, 208)
    got, want, raw = _k4_both(dev, words, mant_start, m_line,
                              np.zeros(200, np.int32), huff)
    np.testing.assert_array_equal(got, raw)
    np.testing.assert_array_equal(want, raw)


def test_k4_stall_on_uncovered_peek(dev):
    """A table whose m = 2 codes leave a peek uncovered: length 0, symbol 0,
    the cursor stays, in the kernel as in the plain walk."""
    from tac_torch import huffman as th

    arrays = dict(th.host_tables(1))
    pak = np.array(arrays["dec_pak"])
    lmax = pak.shape[1].bit_length() - 1
    longest = int((pak[0] >> 16).max())
    # the highest of the longest codewords spans the LUT's last entries
    pak[0, -(1 << (lmax - longest)):] = 0
    arrays["dec_pak"] = pak
    hc = th.device_tables(arrays, dev)
    peek = int(np.flatnonzero(pak[0] == 0)[0])
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, (64, 64), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    words[0] = np.uint32(peek << (32 - lmax)).view(np.int32)
    m_line = rng.choice([0, 2, 2, 2, 5, 9], (64, 128))
    m_line[0] = 2
    got, want, _ = _k4_both(dev, words, np.zeros(64, np.int32), m_line,
                            np.ones(64, np.int32), (hc,))
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all()


def test_vbr_round_trip_runs_k2_k3_k4(dev):
    """encode_array → bytes → decode_array on a VBR config launches K2, K3
    and K4, and the card's stream decodes like the CPU's."""
    from tac_torch import api

    fs = 44100
    t = np.arange(fs // 2) / fs
    rng = np.random.default_rng(3)
    x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 554 * t),
                  0.3 * np.sin(2 * np.pi * 660 * t)
                  + 0.02 * rng.standard_normal(len(t))], 1)
    cfg = PRESETS["vbr-huffman"]
    counts = [tk2.scatter_words_rows, tk3.vbr_reservoir_scan,
              tk4.huffman_decode_sets]
    before = [c.launches for c in counts]
    data = api.encode_array(x, cfg, device=dev)
    k4_before = tk4.huffman_decode_sets.launches
    y = api.decode_array(data, "fast", device=dev)[0]
    assert all(c.launches > b for c, b in zip(counts, before))
    assert tk4.huffman_decode_sets.launches == k4_before + 1   # one per decode
    y_cpu = api.decode_array(api.encode_array(x, cfg, device="cpu"), "fast",
                             device="cpu")[0]

    def snr(a, b):
        return 10 * np.log10(np.mean(a ** 2) / np.mean((a - b) ** 2))

    assert abs(snr(x, y) - snr(x, y_cpu)) < 0.1


@pytest.mark.parametrize("channels,h,t", [(2, 256, 256 * 24), (2, 256, 256 * 24 + 123),
                                          (2, 1024, 1024 * 24 + 57),
                                          (1, 256, 256 * 3 + 1), (3, 128, 5000),
                                          (2, 64, 1000), (5, 1024, 40000)])
def test_k5_kernel_equals_plain(dev, channels, h, t):
    """K5 against its plain version within 5e-6 · max|ref| (two f32 sums over
    2h terms): T off the hop, F = 5 mono, h below the kernel's 128-line
    tile, and row tiles that cross channels."""
    from tac_torch.dsp import mdct as tm
    from tac_torch.dsp.window import sine_window

    rng = np.random.default_rng(h + t)
    basis = torch.tensor(tm.mdct_basis(h, sine_window(2 * h)), device=dev)
    x = torch.tensor(rng.standard_normal((channels, t)).astype(np.float32),
                     device=dev)
    before = tk5.mdct_frames_fused.launches
    got = tk5.mdct_frames_fused(x, h, basis)
    assert tk5.mdct_frames_fused.launches == before + 1
    want = tk5.mdct_frames_plain(x, h, basis)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (channels, tm.num_frames(t, h), h)
    assert float((got - want).abs().max()) <= 5e-6 * float(want.abs().max())


@pytest.mark.parametrize("channels,h,t", [(2, 4, 1000), (3, 256, 100), (1, 64, 1)])
def test_k5_small_transforms_and_short_signals(dev, channels, h, t):
    """K5 at h = 4 (far under the kernel's 128-line tile and 32-sample
    step) and on signals shorter than one hop (F = 2)."""
    from tac_torch.dsp import mdct as tm
    from tac_torch.dsp.window import sine_window

    rng = np.random.default_rng(h * t)
    basis = torch.tensor(tm.mdct_basis(h, sine_window(2 * h)), device=dev)
    x = torch.tensor(rng.standard_normal((channels, t)).astype(np.float32),
                     device=dev)
    got = tk5.mdct_frames_fused(x, h, basis)
    want = tk5.mdct_frames_plain(x, h, basis)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (channels, tm.num_frames(t, h), h)
    assert float((got - want).abs().max()) <= 5e-6 * float(want.abs().max())


def test_k5_refuses_bad_arguments(dev):
    x = torch.zeros((2, 1000), device=dev)
    with pytest.raises(ValueError):
        tk5.mdct_frames_fused(x, 6, torch.zeros((12, 6), device=dev))
    with pytest.raises(ValueError):
        tk5.mdct_frames_fused(x, 8, torch.zeros((16, 8)))
    with pytest.raises(ValueError):
        tk5.mdct_frames_fused(x.double(), 8, torch.zeros((16, 8), device=dev))


def _strike_clip(seconds, fs=44100):
    rng = np.random.default_rng(4)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = np.stack([0.3 * np.sin(2 * np.pi * 330 * (c + 1) * t)
                  + 0.01 * rng.standard_normal(n) for c in range(2)], 1)
    k = np.arange(800)
    burst = 0.5 * np.exp(-k / 100.0) * np.sin(2 * np.pi * 3000 * k / fs)
    for pos in range(fs // 7, n - 900, fs // 5):
        x[pos:pos + 800] += burst[:, None]
    return x


@pytest.mark.parametrize("huffman", [False, True])
def test_bs_round_trip_runs_its_kernels(dev, huffman):
    """encode_array → bytes → decode_array on the block-switch configs at
    full width launches K1 + K2 (fixed rate) or K2 + K3 + K4 (the combo),
    and the card's stream decodes like the CPU's."""
    from tac_torch import api

    x = _strike_clip(1.0)
    cfg = PRESETS["vbr-bs"].replace(use_huffman=huffman)
    counts = ([tk2.scatter_words_rows, tk3.vbr_reservoir_scan,
               tk4.huffman_decode_sets] if huffman
              else [tk1.water_fill_rows, tk2.scatter_words_rows])
    before = [c.launches for c in counts]
    data = api.encode_array(x, cfg, device=dev)
    y = api.decode_array(data, "fast", device=dev)[0]
    assert all(c.launches > b for c, b in zip(counts, before))
    y_cpu = api.decode_array(api.encode_array(x, cfg, device="cpu"), "fast",
                             device="cpu")[0]

    def snr(a, b):
        return 10 * np.log10(np.mean(a ** 2) / np.mean((a - b) ** 2))

    assert abs(snr(x, y) - snr(x, y_cpu)) < 0.1


def test_filterbank_path_runs_k5(dev):
    from tac_torch import filterbank

    cfg = PRESETS["stereo44-128"]
    x = _strike_clip(1.0).T.astype(np.float32)
    before = tk5.mdct_frames_fused.launches
    lines = filterbank.mdct_analysis(x, cfg, device=dev)
    assert tk5.mdct_frames_fused.launches == before + 1
    y = filterbank.mdct_synthesis(lines, cfg, x.shape[1], device=dev).cpu().numpy()
    # f32 sums of 2 048 terms in sequence: about eps * sqrt(2048), -111 dB
    assert 10 * np.log10(np.mean(x ** 2) / np.mean((x - y) ** 2)) > 110.0


# ------------------------------------------------------------ mid/side ---

GOLDEN_CASES = {   # tools/golden.py:cases(), on the port's presets
    "config1_mono16_64": ("mono16-64", {}, "mono16"),
    "config2_stereo44_128": ("stereo44-128", {}, "stereo44"),
    "config3_vbr_huffman": ("vbr-huffman", {}, "stereo44"),
    "config5_blockswitch": ("streaming-ll", {}, "transient44"),
    "config6_vbr_blockswitch": ("vbr-bs", {"n_mdct_lines": 256,
                                           "n_mdct_lines_short": 64,
                                           "n_channels": 1}, "transient44"),
    "config7_ms_stereo": ("stereo44-128-ms", {}, "stereo44"),
    "config8_ms_vbr": ("vbr-ms", {}, "stereo44"),
    "config9_ms_blockswitch": ("ms-bs", {"n_mdct_lines": 256,
                                         "n_mdct_lines_short": 64},
                               "transient44_stereo"),
    "config10_ms_vbr_blockswitch": ("vbr-ms-bs", {"n_mdct_lines": 256,
                                                  "n_mdct_lines_short": 64},
                                    "transient44_stereo"),
}


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_parity_on_card_matches_goldens(dev, name):
    """Parity precision on the card (cuFFT MDCT, f64 cuBLAS psy products,
    the f64 allocation loops on CUDA tensors) hashes to
    goldens/streams.json, as on the CPU."""
    import hashlib
    import json
    import os
    import sys

    from tac_torch import api

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "tools"))
    import golden

    preset, change, clip = GOLDEN_CASES[name]
    x, fs = golden.clips()[clip]
    cfg = PRESETS[preset].replace(precision="parity", sample_rate=fs, **change)
    data = api.encode_array(x, cfg, device=dev)
    with open(os.path.join(repo, "goldens", "streams.json")) as f:
        want = json.load(f)[name]
    assert {"sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data)} == want


def _ms_clips(n=3, seconds=1.0):
    """n correlated stereo clips with strikes: the second channel 0.8 of
    the first plus a little noise of its own."""
    x = _strike_clip(seconds)[:, 0]
    rng = np.random.default_rng(6)
    return np.stack([np.stack([(0.6 + 0.2 * i) * x,
                               (0.5 + 0.2 * i) * x
                               + 0.01 * rng.standard_normal(len(x))])
                     for i in range(n)])                  # [n, 2, T]


@pytest.mark.parametrize("family", ["ms", "ms_bs"])
def test_k1_real_joint_rows(dev, family):
    """K1 at the joint rows an M/S encode gives it: the snapped SMRs of
    pair-adjacent rows joined to [R/2, 50], 2·budget, with the shared map
    (fixed-rate M/S) or each pair's state-selected widths (M/S × block
    switching), equal to its plain version."""
    from tac_torch import blockswitch as tb

    x = torch.as_tensor(_ms_clips(), device=dev)
    with torch.no_grad():
        if family == "ms":
            cfg = PRESETS["stereo44-128-ms"]
            c = tc.make_consts(cfg, dev)
            fr = tc.fb.frame_signal(tc.input_signal(x, cfg, c.dtype, dev),
                                    cfg.n_mdct_lines).transpose(-3, -2)
            _, smr = tc.analyze_frame(fr.reshape(-1, fr.shape[-1]), cfg, c)
            nl, budget = torch.cat([c.n_lines, c.n_lines]), 2 * c.budget
        else:
            cfg = PRESETS["ms-bs"]
            c = tb.make_bs_consts(cfg, dev)
            frames, states = tb._frames_and_states(x, cfg, c, dev)
            fr = frames.transpose(-3, -2).reshape(-1, frames.shape[-1])
            st = states.transpose(-2, -1).reshape(-1)
            assert (st == tb.SHORT).any()
            _, sl, _, ss = tb.analyze_frame_bs(fr, st, cfg, c)
            smr = tb.select_by_state(st, sl, ss)
            nl = tb.state_n_lines(st, c).reshape(-1, 50)
            budget = 2 * c.cl.budget
        smr_q = tba.snap_smr(smr).float().reshape(-1, 50)
    got, want = _k1_both(dev, smr_q, nl, np.full(smr_q.shape[0], budget))
    np.testing.assert_array_equal(got, want)
    # the joint rows do move bits between mid and side
    bits = got.reshape(-1, 2, 25) * nl.reshape(-1, 2, 25).cpu().numpy()
    assert bits.sum(-1).max() > budget // 2


@pytest.mark.parametrize("family", ["vbr_ms", "vbr_ms_bs"])
def test_k3_pair_lanes(dev, family):
    """K3 with one lane per M/S pair over 2B = 50 bands, base 2·budget and
    cap 4·2·budget, on the phase-1 output of a batched encode: the shared
    map (vbr-ms) or per-frame state-selected widths [F, P, 50]
    (vbr-ms-bs), equal to its plain version."""
    from tac_torch import blockswitch as tb

    x = torch.as_tensor(_ms_clips(), device=dev)
    with torch.no_grad():
        if family == "vbr_ms":
            cfg = PRESETS["vbr-ms"]
            c = tc.make_consts(cfg, dev)
            frames = tc.fb.frame_signal(tc.input_signal(x, cfg, c.dtype, dev),
                                        cfg.n_mdct_lines)
            _, smr, bh = tc._vbr_phase1_lanes(tc.to_lanes(frames, cfg), cfg, c)
            nl, budget = torch.cat([c.n_lines, c.n_lines]), c.budget
        else:
            cfg = PRESETS["vbr-ms-bs"]
            c = tb.make_bs_consts(cfg, dev)
            frames, states = tb._frames_and_states(x, cfg, c, dev)
            lane_states = tb.lane_states(states, cfg)
            _, _, smr, bh = tb._bs_vbr_phase1(tc.to_lanes(frames, cfg),
                                              lane_states, cfg, c)
            nl = tb.state_n_lines(lane_states.transpose(0, 1), c).repeat(1, 1, 2)
            budget = c.cl.budget
    assert smr.shape[1:] == (3, 50)
    got, want = _k3_both(dev, smr, bh, nl, np.zeros(3), 2 * budget,
                         cfg.reservoir_factor * 2 * budget)
    for g, w, what in zip(got, want, ["alloc", "tid", "used", "res"]):
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert (got[1] > 0).any()


@pytest.mark.parametrize("preset", ["stereo44-128-ms", "vbr-ms", "ms-bs",
                                    "vbr-ms-bs"])
def test_ms_round_trip_runs_its_kernels(dev, preset):
    """encode_array → bytes → decode_array on each M/S preset at full width
    launches its kernels (K1 + K2 fixed rate; K2 + K3 + K4 under VBR), and
    the card's stream decodes like the CPU's (SNR within 0.1 dB)."""
    from tac_torch import api

    x = _ms_clips(1)[0].T
    cfg = PRESETS[preset]
    counts = ([tk2.scatter_words_rows, tk3.vbr_reservoir_scan,
               tk4.huffman_decode_sets] if cfg.use_huffman
              else [tk1.water_fill_rows, tk2.scatter_words_rows])
    before = [c.launches for c in counts]
    data = api.encode_array(x, cfg, device=dev)
    y = api.decode_array(data, "fast", device=dev)[0]
    assert all(c.launches > b for c, b in zip(counts, before))
    y_cpu = api.decode_array(api.encode_array(x, cfg, device="cpu"), "fast",
                             device="cpu")[0]

    def snr(a, b):
        return 10 * np.log10(np.mean(a ** 2) / np.mean((a - b) ** 2))

    assert abs(snr(x, y) - snr(x, y_cpu)) < 0.1


# ------------------------------------------------ streaming, seek, fuzz ---

@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_stream_parity_on_card_matches_goldens(dev, name):
    """The golden clips streamed in parity on the card, in seeded random
    pushes of 1-699 samples, hash to goldens/streams.json, as offline."""
    import hashlib
    import json
    import os
    import sys

    from tac_torch.streaming import StreamEncoder

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "tools"))
    import golden

    preset, change, clip = GOLDEN_CASES[name]
    x, fs = golden.clips()[clip]
    cfg = PRESETS[preset].replace(precision="parity", sample_rate=fs, **change)
    enc = StreamEncoder(cfg, n_channels=x.shape[1], device=dev)
    rng = np.random.default_rng(5)
    parts, i = [enc.header(len(x))], 0
    while i < len(x):
        n = int(rng.integers(1, 700))
        parts.append(enc.push(x[i:i + n]))
        i += n
    data = b"".join(parts) + enc.flush()
    with open(os.path.join(repo, "goldens", "streams.json")) as f:
        want = json.load(f)[name]
    assert hashlib.sha256(data).hexdigest() == want["sha256"]


@pytest.mark.parametrize("precision", ["fast", "parity"])
def test_decode_range_on_card(dev, precision):
    """decode_range on the card over tests/test_seek.py's ranges of a
    vbr-ms-bs stream: exactly the full decode's samples in parity, within
    2e-5 in fast precision; K4 launches."""
    from tac_torch import api

    x = _ms_clips(1)[0].T
    cfg = PRESETS["vbr-ms-bs"].replace(precision=precision)
    data = api.encode_array(x, cfg, device=dev)
    full = api.decode_array(data, precision, device=dev)[0]
    n, h = full.shape[0], cfg.n_mdct_lines
    before = tk4.huffman_decode_sets.launches
    for s0, s1 in [(0, n), (0, 1), (n - 1, n), (h, 3 * h), (h - 1, h + 1),
                   (5 * h + 17, 7 * h - 3), (1234, 20000)]:
        got = api.decode_range(data, s0, s1, precision, device=dev)[0]
        assert got.shape == (s1 - s0, 2)
        if precision == "parity":
            assert np.array_equal(got, full[s0:s1]), (s0, s1)
        else:
            np.testing.assert_allclose(got, full[s0:s1], atol=2e-5)
    assert tk4.huffman_decode_sets.launches > before


def test_fuzz_on_card_keeps_the_context(dev):
    """Mutated VBR × block-switch streams (bit flips, truncations, length
    prefixes) through decode_array, decode_range and StreamDecoder.push on
    the card: a typed error or finite audio, and the CUDA context alive
    (a synchronize) after every case."""
    from tac_torch import api
    from tac_torch.bitstream import CorruptStreamError, read_header
    from tac_torch.streaming import StreamDecoder

    x = _strike_clip(0.3)
    data = api.encode_array(x, PRESETS["vbr-bs"].replace(
        n_mdct_lines=256, n_mdct_lines_short=64), device=dev)
    off = read_header(data)[1]
    rng = np.random.default_rng(13)
    prefixes, pos = [], off
    while pos + 2 <= len(data):
        prefixes.append(pos)
        pos += 2 + (data[pos] | (data[pos + 1] << 8))
    mutants = []
    for _ in range(12):
        buf = bytearray(data)
        for b in rng.integers(off * 8, len(data) * 8, rng.integers(1, 17)):
            buf[b // 8] ^= 1 << (b % 8)
        mutants.append(bytes(buf))
    mutants += [data[:int(rng.integers(off, len(data)))] for _ in range(4)]
    for _ in range(4):
        buf = bytearray(data)
        p = prefixes[int(rng.integers(0, len(prefixes)))]
        buf[p], buf[p + 1] = int(rng.integers(0, 256)), int(rng.integers(0, 256))
        mutants.append(bytes(buf))
    for m in mutants:
        for call in (lambda: api.decode_array(m, "fast", device=dev)[0],
                     lambda: api.decode_range(m, 100, 5000, device=dev)[0],
                     lambda: StreamDecoder.from_header(m, device=dev)[0]
                     .push(m[off:])):
            try:
                y = call()
                assert np.all(np.isfinite(y))
            except (CorruptStreamError, ValueError):
                pass
            torch.cuda.synchronize()


def test_fast_stream_mid_push_kernels_equal_plain(dev, monkeypatch):
    """Fast streams on the card: K1's inputs from pushes in the middle of a
    streaming-ll stream and K3's from pushes in the middle of a vbr-bs
    stream (resumed from a carried fill above 0) give the kernel's plain
    version's integers."""
    from tac_torch.ops import vbr_scan
    from tac_torch.streaming import StreamEncoder

    log = {"k1": [], "k3": []}
    k1_kernel, k3_kernel = tc.water_fill_rows, tc.vbr_reservoir_scan

    def rec_k1(*a, **kw):
        log["k1"].append((a, kw))
        return k1_kernel(*a, **kw)

    def rec_k3(*a, **kw):
        log["k3"].append((a, kw))
        return k3_kernel(*a, **kw)

    x = _strike_clip(1.0)
    for preset, hop in (("streaming-ll", 256), ("vbr-bs", 1024)):
        cfg = PRESETS[preset]
        xin = x[:, 0] if cfg.n_channels == 1 else x
        enc = StreamEncoder(cfg, n_channels=cfg.n_channels, device=dev)
        for i in range(-(-len(xin) // hop)):
            if 20 <= i <= 24:
                # a fresh encoder resumed from the state: its first push
                # runs eagerly, so that the kernels are called from Python
                # (a streaming-ll encoder replays its later pushes)
                enc = _resumed(enc, dev)
            if i == 20:
                monkeypatch.setattr(tc, "water_fill_rows", rec_k1)
                monkeypatch.setattr(tc, "vbr_reservoir_scan", rec_k3)
            enc.push(xin[i * hop:(i + 1) * hop])
            if i == 24:
                monkeypatch.undo()
    assert log["k1"] and log["k3"]
    assert max(int(a[3].max()) for a, _ in log["k3"]) > 0
    for a, kw in log["k1"]:
        assert torch.equal(tk1.water_fill_rows(*a, **kw),
                           tk1.water_fill_rows_plain(*a, **kw))
    for a, kw in log["k3"]:
        for g, w in zip(vbr_scan.vbr_reservoir_scan(*a, **kw),
                        vbr_scan.vbr_reservoir_scan_plain(*a, **kw)):
            assert torch.equal(g, w)


def _resumed(enc, dev):
    """A fresh StreamEncoder of enc's config carrying on from enc's state
    (through its bytes)."""
    from tac_torch.streaming import StreamEncoder, StreamState

    fresh = StreamEncoder(enc.cfg, device=dev)
    fresh.state = StreamState.from_bytes(enc.state.to_bytes())
    return fresh


def _device_launches(fn) -> dict:
    """fn() under the profiler → the launches on the card of each
    hand-written kernel (by ``tracing.DEVICE_KERNELS``' names), those a
    replayed graph makes among them."""
    from torch.profiler import ProfilerActivity, profile

    from tac_torch import tracing

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if "CUDA" in str(getattr(e, "device_type", ""))]
    return {k: sum(v in n for n in names)
            for k, v in tracing.DEVICE_KERNELS.items()}


def _graph_stream(dev, cfg, x, sizes, resume_at):
    """x through a StreamEncoder in pushes of `sizes`, moved at push
    resume_at into a fresh encoder from its state, then the flush; every
    push's bytes at once through a StreamDecoder. Tracing on, under the
    profiler → (bytes, PCM, snapshot, the kernels' launch counters, their
    launches on the card, the encoders, the decoder)."""
    from tac_torch import tracing
    from tac_torch.streaming import StreamDecoder, StreamEncoder

    enc = StreamEncoder(cfg, device=dev)
    dec = StreamDecoder.from_header(enc.header(0), device=dev)[0]
    encs, sent, pcm = [enc], [], []
    before = tracing.launches()

    def run():
        i = 0
        for k, n in enumerate(sizes + [None]):
            if k == resume_at:
                encs.append(_resumed(encs[-1], dev))
            sent.append(encs[-1].flush() if n is None
                        else encs[-1].push(x[i:i + n]))
            pcm.append(dec.push(sent[-1]))
            i += n or 0

    tracing.enable(True)
    tracing.reset()
    try:
        on_card = _device_launches(run)
        snap = tracing.snapshot()
    finally:
        tracing.enable(False)
        tracing.reset()
    after = tracing.launches()
    return (b"".join(sent), np.concatenate(pcm), snap,
            {k: after[k] - before[k] for k in after}, on_card, encs, dec)


@pytest.mark.parametrize("preset", ["streaming-ll", "stereo44-128", "ms-bs"])
def test_graph_pushes_equal_eager(dev, preset, monkeypatch):
    """Fast fixed-rate streams on the card, pushes replayed as CUDA graphs
    against the same pushes run eagerly: over 210 pushes of one to three
    frames (their order seeded), a resume into a fresh encoder at push 105
    and the flush, the same bytes and the decoder's PCM bit for bit; the
    kernels' ``.launches`` count only the eager pushes' and the captures'
    calls, while the card launches the kernels in the replays too; each
    shape run eagerly once, captured at most once and replayed on every
    later push, the graph spans inside the core spans."""
    from tac_torch import streaming

    cfg = PRESETS[preset]
    h = cfg.n_mdct_lines
    sizes = [h * int(m) for m in np.random.default_rng(len(preset))
             .integers(1, 4, 210)]
    x = _strike_clip(sum(sizes) / cfg.sample_rate + 0.01)
    x = x[:, 0] if cfg.n_channels == 1 else x
    with torch.no_grad():
        got = _graph_stream(dev, cfg, x, sizes, 105)
        monkeypatch.setattr(streaming, "graphed", lambda c, d: False)
        want = _graph_stream(dev, cfg, x, sizes, 105)
    assert got[0] == want[0]
    assert got[1].shape == want[1].shape and np.array_equal(got[1], want[1])
    assert want[2]["counters"]["graph_replays"] == 0
    spans, counters = got[2]["spans"], got[2]["counters"]
    coders = [e.graphs for e in got[5]] + [got[6].graphs]
    cores = sum(s[0] in ("tac.stream.enc.core", "tac.stream.dec.decode")
                for s in spans)
    eager = sum(len(g.seen) for g in coders)
    # Python calls the kernels in an encoder's eager pushes and captures
    # alone, as often a call as the eager twin does in every push (the
    # fixed-rate decoders call none); the card launches them in every push
    # (the profiler drops a few of these kernels' records in a window, so
    # its count is a lower bound here)
    enc_cores = sum(s[0] == "tac.stream.enc.core" for s in spans)
    enc_python = sum(len(g.seen) + len(g.graphs) for g in coders[:-1])
    for k in want[3]:
        assert got[3][k] * enc_cores == want[3][k] * enc_python
    # K7 adds the transient detector's sums (block switching): the psy's
    # band sums are K8's
    for k in ("water_fill_rows", "scatter_words_rows", "row_matmul",
              "psy_smr_rows") + (("segment_sums",) if cfg.use_block_switch
                                 else ()):
        assert got[3][k] < got[4][k] <= want[3][k]
    assert all(len(g.seen) <= streaming.GRAPHS for g in coders)
    assert 0 < counters["graph_captures"] == sum(len(g.graphs)
                                                 for g in coders) <= eager
    assert counters["graph_replays"] == cores - eager > 400
    for kind in ("capture", "replay"):
        inside = [spans[s[3]][0] for s in spans
                  if s[0] == f"tac.stream.graph.{kind}"]
        assert set(inside) == {"tac.stream.enc.core", "tac.stream.dec.decode"}
        assert len(inside) == counters[f"graph_{kind}s"]


def _corpus_wavs(tmp_path, n=4):
    """n seeded stereo 44.1 kHz WAVs of 1.0-1.9 s (two length buckets)."""
    from tac_torch.io.wav import write_wav

    rng = np.random.default_rng(11)
    paths = []
    for i in range(n):
        m = int(44100 * (1.0 + 0.3 * i))
        t = np.arange(m) / 44100
        x = 0.4 * np.sin(2 * np.pi * (220 + 55 * i) * t) \
            + 0.02 * rng.standard_normal(m)
        p = str(tmp_path / f"c{i}.wav")
        write_wav(p, np.stack([x, 0.8 * np.roll(x, 31)], 1), 44100)
        paths.append(p)
    return paths


def test_parity_corpus_on_card_equals_solo(dev, tmp_path):
    """The corpus preset in parity precision on the card: each batched .pac
    equals the solo encode_array on the card, byte for byte, and K2 packs
    the batch (parity allocates with the plain f64 loops)."""
    import os

    from tac_torch import api
    from tac_torch.corpus import CorpusTranscoder
    from tac_torch.io.wav import read_wav

    cfg = PRESETS["corpus"].replace(precision="parity")
    paths = _corpus_wavs(tmp_path)
    out = tmp_path / "out"
    tc_ = CorpusTranscoder(cfg, str(out), batch_size=4, device=dev)
    tc_._encode_one = None                      # no per-clip fallback
    before = tk2.scatter_words_rows.launches
    assert tc_.run(paths, log=lambda *a: None)["ok"] == 4
    assert tk2.scatter_words_rows.launches > before
    for p in paths:
        pac = out / (os.path.basename(p)[:-4] + ".pac")
        assert pac.read_bytes() == api.encode_array(read_wav(p)[0], cfg,
                                                    device=dev)


def test_cli_encode_on_card_runs_k1_k2(dev, tmp_path, capsys):
    """The CLI's encode with no --device runs on the card: K1 and K2
    launch, and the file is encode_array's bytes on the card."""
    from tac_torch import api, cli
    from tac_torch.io.wav import read_wav

    src = _corpus_wavs(tmp_path, 1)[0]
    pac = str(tmp_path / "o.pac")
    before = (tk1.water_fill_rows.launches, tk2.scatter_words_rows.launches)
    assert cli.main(["encode", src, pac, "--preset", "corpus"]) == 0
    assert tk1.water_fill_rows.launches > before[0]
    assert tk2.scatter_words_rows.launches > before[1]
    assert open(pac, "rb").read() == api.encode_array(
        read_wav(src)[0], PRESETS["corpus"], device=dev)


def test_vbr_corpus_decode_on_card_runs_k4(dev, tmp_path):
    """corpus-decode of vbr-huffman streams on the card: one K4 launch per
    batch, each WAV within one 16-bit LSB of the solo decode on the card;
    all-zero padding rows decode to silence through K4."""
    import os

    from tac_torch import api, family, parallel
    from tac_torch.corpus import CorpusDecoder, CorpusTranscoder
    from tac_torch.io.wav import read_wav

    cfg = PRESETS["vbr-huffman"]
    paths = _corpus_wavs(tmp_path)
    enc = tmp_path / "enc"
    CorpusTranscoder(cfg, str(enc), batch_size=4, device=dev).run(
        paths, log=lambda *a: None)
    pacs = [str(enc / (os.path.basename(p)[:-4] + ".pac")) for p in paths]
    dec = CorpusDecoder(str(tmp_path / "dec"), batch_size=4, device=dev)
    dec._decode_one = None
    before = tk4.huffman_decode_sets.launches
    assert dec.run(pacs, log=lambda *a: None)["ok"] == 4
    assert tk4.huffman_decode_sets.launches == before + 1
    for p in pacs:
        y = read_wav(str(tmp_path / "dec" / (os.path.basename(p)[:-4]
                                              + ".wav")))[0]
        ref = api.decode_array(open(p, "rb").read(), "fast", device=dev)[0]
        np.testing.assert_allclose(
            y, np.clip(np.round(ref * 32768.0), -32768, 32767) / 32768.0,
            rtol=0, atol=1.001 / 32768.0)
    w32 = family.payload_words(cfg)
    zeros = np.zeros((2, 2, 32, w32), np.int32)
    before = tk4.huffman_decode_sets.launches
    y = parallel.decode_batch_packed(zeros, cfg, 31 * cfg.n_mdct_lines,
                                     pcm16=True, device=dev)
    assert tk4.huffman_decode_sets.launches == before + 1
    assert y.dtype == torch.int16 and not y.any()


# every fast product's (K, N): 2H -> H, and 2Hs -> Hs on block switching
K6_SHAPES = sorted({(2 * h, h) for cfg in PRESETS.values()
                    for h in (cfg.n_mdct_lines, cfg.n_mdct_lines_short
                              if cfg.use_block_switch else cfg.n_mdct_lines)})


def _noisy_rows(dev, m, k, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(m * k).reshape(m, k) / 44100.0
    return torch.as_tensor(0.4 * np.sin(2 * np.pi * 440 * t)
                           + 0.05 * rng.standard_normal((m, k)),
                           dtype=torch.float32, device=dev)


@pytest.mark.parametrize("k,n", K6_SHAPES)
def test_k6_kernel_equals_plain(dev, k, n):
    """K6 at every product shape of the presets, 2 049 rows: within
    K·2⁻²³·Σ|a||b| of its plain version, one launch."""
    a = _noisy_rows(dev, 2049, k, k)
    b = torch.as_tensor(np.random.default_rng(n).standard_normal((k, n))
                        / np.sqrt(k), dtype=torch.float32, device=dev)
    before = tk6.row_matmul.launches
    got = tk6.row_matmul(a, b)
    assert tk6.row_matmul.launches == before + 1
    want = tk6.row_matmul_plain(a, b)
    scale = (a.abs().double() @ b.abs().double()) * (k * 2.0 ** -23)
    assert bool(((got.double() - want.double()).abs() <= scale).all())


@pytest.mark.parametrize("k,n", K6_SHAPES)
def test_k6_kernel_equals_plain_at_one_row(dev, k, n):
    """K6 at every product shape on a single row (a tile of zeros but one
    row) and on the same row as row 2 048 of a 2 049-row call (a row tile
    of its own): within K·2⁻²³·Σ|a||b| of the plain version, and the same
    bits in both places."""
    a = _noisy_rows(dev, 2049, k, k + 1)
    b = torch.as_tensor(np.random.default_rng(n + 1).standard_normal((k, n))
                        / np.sqrt(k), dtype=torch.float32, device=dev)
    one = tk6.row_matmul(a[2048:], b)
    want = tk6.row_matmul_plain(a[2048:], b)
    scale = (a[2048:].abs().double() @ b.abs().double()) * (k * 2.0 ** -23)
    assert bool(((one.double() - want.double()).abs() <= scale).all())
    assert torch.equal(tk6.row_matmul(a, b)[2048:], one)


@pytest.mark.parametrize("k,n", K6_SHAPES)
def test_k6_tile_fills_the_card_at_every_product_shape(dev, k, n):
    """The tile the built kernel takes for a [K, N] product gives a
    2 048-row launch (the codec's chunk) 128 blocks at every product shape
    of the presets; it is asked with no row count, and a one-row call
    gives the bits of the same row in a 2 048-row call."""
    bm, bn = tk6.tile(k, n)
    assert 2048 % bm == 0 and (2048 // bm) * -(-n // bn) == 128, (bm, bn)
    a = _noisy_rows(dev, 2048, k, k + 2)
    b = torch.as_tensor(np.random.default_rng(n + 2).standard_normal((k, n))
                        / np.sqrt(k), dtype=torch.float32, device=dev)
    assert torch.equal(tk6.row_matmul(a[-1:], b), tk6.row_matmul(a, b)[-1:])


def test_k6_rows_invariant(dev):
    """K6's rows are equal bit for bit whatever M (1, 2, 3, 2047, 2048,
    2049, 20 704), the row's place (a permutation) or the leading axes."""
    a = _noisy_rows(dev, 20704, 2048)
    b = tc.make_consts(PRESETS["stereo44-128"], dev).fwd_basis
    full = tk6.row_matmul(a, b)
    for m in (1, 2, 3, 2047, 2048, 2049):
        assert torch.equal(tk6.row_matmul(a[:m], b), full[:m]), m
    perm = torch.randperm(20704, device=dev)
    assert torch.equal(tk6.row_matmul(a[perm], b), full[perm])
    sub = a[:2048, :2048].reshape(2048, 8, 256).contiguous()
    short = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (256, 128)) / 16, dtype=torch.float32, device=dev)
    assert torch.equal(tk6.row_matmul(sub, short).reshape(-1, 128),
                       tk6.row_matmul(sub.reshape(-1, 256), short))
    # each row at other places of its tile and of a thread's rows
    for shift in (1, 5, 63, 64, 65, 127):
        assert torch.equal(tk6.row_matmul(a[shift:shift + 2048], b),
                           full[shift:shift + 2048]), shift


def test_k7_kernel_equals_plain_and_rows_invariant(dev):
    """K7 on band ranges and on prefix ranges equals its plain version on
    the CPU bit for bit, and its rows do not depend on M or their place."""
    rng = np.random.default_rng(3)
    x = (rng.random((2049, 1024)) * np.exp(4 * rng.standard_normal(
        (2049, 1024)))).astype(np.float32)
    xd = torch.as_tensor(x, device=dev)
    bands_ = tuple(bands.band_line_ranges(44100, 1024))
    prefixes = tuple((0, int(e)) for e in
                     np.round(np.arange(9) * 1022 / 8).astype(int))
    for ranges in (bands_, prefixes):
        before = tk7.segment_sums.launches
        got = tk7.segment_sums(xd, ranges)
        assert tk7.segment_sums.launches == before + 1
        assert torch.equal(got.cpu(), tk7.segment_sums_plain(
            torch.from_numpy(x), ranges))
        for m in (1, 2, 3, 2047, 2048):
            assert torch.equal(tk7.segment_sums(xd[:m], ranges), got[:m]), m
        perm = torch.randperm(2049, device=dev)
        assert torch.equal(tk7.segment_sums(xd[perm], ranges), got[perm])


@pytest.mark.parametrize("case", ["segs_40", "segs_64", "long_rows",
                                  "long_prefixes", "unaligned_rows"])
def test_k7_many_segments_and_long_rows(dev, case):
    """K7 where a lane takes two segments (40, 64), on rows longer than its
    1 024-float chunk (segments and nested prefixes across chunk edges),
    and on rows of 1 023 floats (the transient detector's, not 16-byte
    aligned): equal to its plain version on the CPU bit for bit."""
    rng = np.random.default_rng(len(case))
    length = {"long_rows": 5000, "long_prefixes": 5000,
              "unaligned_rows": 1023}.get(case, 1024)
    x = (rng.random((777, length)) * np.exp(4 * rng.standard_normal(
        (777, length)))).astype(np.float32)
    if case.startswith("segs"):
        nseg = int(case.split("_")[1])
        cuts = np.sort(rng.integers(0, length + 1, 2 * nseg)).reshape(nseg, 2)
        ranges = tuple((int(s), int(e)) for s, e in cuts)
    elif case == "long_rows":
        ranges = ((10, 5000), (1000, 1030), (1023, 1025), (0, 0), (2047, 4097))
    elif case == "long_prefixes":
        ranges = ((0, 0), (0, 1024), (0, 3000), (0, 3000), (0, 5000))
    else:
        ranges = tuple((0, int(e)) for e in
                       np.round(np.arange(9) * 1022 / 8).astype(int))
    got = tk7.segment_sums(torch.as_tensor(x, device=dev), ranges)
    assert torch.equal(got.cpu(), tk7.segment_sums_plain(torch.from_numpy(x),
                                                         ranges))


@pytest.mark.parametrize("preset,n", [("mono16-64", 4096),
                                      ("vbr-huffman", 8192)])
def test_zero_line_parity_on_card_equals_cpu(dev, preset, n):
    """DC and Nyquist (MDCT lines zero in exact arithmetic) in parity on
    the card: the same bytes as the CPU encode, which
    tests/test_torch_edge.py holds equal to tac's."""
    from tac_torch import api

    change = {} if preset == "mono16-64" else {"sample_rate": 16000,
                                               "n_channels": 1}
    cfg = PRESETS[preset].replace(precision="parity", **change)
    for x in (np.full((n, 1), 0.25),
              (0.25 * np.cos(np.pi * np.arange(n)))[:, None]):
        assert api.encode_array(x, cfg, device=dev) == \
            api.encode_array(x, cfg, device="cpu")


@pytest.mark.parametrize("family", ["corpus", "vbr-huffman"])
def test_fast_corpus_on_card_equals_solo(dev, tmp_path, family):
    """Fast precision on the card: each batched .pac, noisy clips and pure
    tones alike, equals the solo encode_array on the card byte for byte
    (K6 and K8 make a row's floats independent of the batch), and the
    batch ran K6 and K8."""
    import os

    from tac_torch import api
    from tac_torch.corpus import CorpusTranscoder
    from tac_torch.io.wav import read_wav, write_wav

    cfg = PRESETS[family]
    paths = _corpus_wavs(tmp_path)
    for i, f0 in enumerate((220.0, 330.0)):
        t = np.arange(int(44100 * (1.1 + 0.4 * i))) / 44100
        x = sum(a * np.sin(2 * np.pi * f0 * k * t)
                for k, a in [(1, 0.4), (2, 0.2), (3, 0.1), (7, 0.03)])
        p = str(tmp_path / f"tone{i}.wav")
        write_wav(p, np.stack([x, 0.8 * x], 1), 44100)
        paths.append(p)
    out = tmp_path / "out"
    job = CorpusTranscoder(cfg, str(out), batch_size=6, device=dev)
    job._encode_one = None                      # no per-clip fallback
    before = (tk6.row_matmul.launches, tk8.psy_smr_rows.launches)
    assert job.run(paths, log=lambda *a: None)["ok"] == 6
    assert tk6.row_matmul.launches > before[0]
    assert tk8.psy_smr_rows.launches > before[1]
    for p in paths:
        pac = out / (os.path.basename(p)[:-4] + ".pac")
        assert pac.read_bytes() == api.encode_array(read_wav(p)[0], cfg,
                                                    device=dev), p


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_fast_stream_on_card_equals_offline(dev, name):
    """A golden family in fast precision on the card, streamed in seeded
    pushes of one or two hops: byte-identical to encode_array."""
    import os
    import sys

    from tac_torch import api
    from tac_torch.streaming import StreamEncoder

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import golden

    preset, change, clip = GOLDEN_CASES[name]
    x, fs = golden.clips()[clip]
    cfg = PRESETS[preset].replace(precision="fast", sample_rate=fs, **change)
    rng = np.random.default_rng(len(name))
    enc = StreamEncoder(cfg, n_channels=x.shape[1], device=dev)
    out, i = [enc.header(len(x))], 0
    while i < len(x):
        n = cfg.n_mdct_lines * int(rng.integers(1, 3))
        out.append(enc.push(x[i:i + n]))
        i += n
    assert b"".join(out) + enc.flush() == api.encode_array(x, cfg, device=dev)


# K8's models: the band model at H = 1 024, the line model at H = 256 with
# a per-row gain, the short line model at H = 64 (every line a candidate,
# four rows a block, empty bands) and the flagship with no noise maskers
K8_MODELS = ("band_1024", "line_256_gain", "short_64", "no_noise")
NEG32 = float(np.float32(-1e30))


def _k8_inputs(dev, model, m=2049, seed=0):
    """K8's inputs on the card: (re, im, lines, consts, gain or None) of m
    rows, re / im by K6 from noisy harmonic frames; row 0 tied peaks (more
    equal isolated peaks than maskers where H allows, one clear winner),
    row 1 silent."""
    from tac_torch import blockswitch as tbs
    from tac_torch import psy

    if model in ("band_1024", "no_noise"):
        cfg = PRESETS["stereo44-128"].replace(
            psy_noise_maskers=model == "band_1024")
        c = psy.make_consts(cfg, dev)
    else:
        bc = tbs.make_bs_consts(PRESETS["streaming-ll"], dev)
        c = bc.cl.psy if model == "line_256_gain" else bc.psy_short
    h = c.freqs.shape[0]
    rng = np.random.default_rng(seed + h)
    frames = _noisy_rows(dev, m, 2 * h, seed + h)
    re, im = tk6.row_matmul(frames, c.fft_cos), tk6.row_matmul(frames,
                                                               c.fft_sin)
    ii = np.full(h, 1e-6, np.float32)
    ii[5:h - 2:3] = 1.0
    ii[3] = 2.0
    re[0] = torch.as_tensor(np.sqrt(ii / c.fft_gain), dtype=torch.float32,
                            device=dev)
    im[0] = 0.0
    re[1] = im[1] = 0.0
    lines = torch.as_tensor(0.3 * rng.standard_normal((m, h)),
                            dtype=torch.float32, device=dev)
    lines[1] = 0.0
    gain = (torch.as_tensor(rng.uniform(0.5, 8.0, m), dtype=torch.float32,
                            device=dev) if model == "line_256_gain" else None)
    return re, im, lines, c, gain


def _k8_plain(re, im, lines, c, gain=None):
    """The plain psy model on K8's inputs → (smr, kept maskers' indices,
    -1 past the valid ones)."""
    from tac_torch import psy

    ii = c.fft_gain * (re * re + im * im)
    _, _, top_idx, _, _, valid, _ = psy._tonal_maskers(ii, c)
    return (psy.smrs_from_intensity(ii, lines, c, gain),
            torch.where(valid, top_idx, -1).to(torch.int32))


@pytest.mark.parametrize("m", [1, 2, 2047, 2048, 2049])
@pytest.mark.parametrize("model", K8_MODELS)
def test_k8_kernel_equals_plain(dev, model, m):
    """K8 on m rows in one launch against the plain model on the card:
    the same kept maskers (tied peaks keep the lowest indices), SMRs within
    0.001 dB, empty bands exactly _NEG; each row the same bits as in a
    2 049-row launch."""
    re, im, lines, c, gain = _k8_inputs(dev, model)
    full = tk8.psy_smr_rows(re, im, lines, c, gain, maskers=True)
    args = [t[:m] for t in (re, im, lines)] + [c, None if gain is None
                                               else gain[:m]]
    before = tk8.psy_smr_rows.launches
    got, idx = tk8.psy_smr_rows(*args, maskers=True)
    assert tk8.psy_smr_rows.launches == before + 1
    want, want_idx = _k8_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx)
    assert torch.equal(got, full[0][:m]) and torch.equal(idx, full[1][:m])
    h = c.freqs.shape[0]
    assert idx[0].tolist() == ([3] + list(range(5, h - 2, 3))
                               + [-1] * 64)[:idx.shape[1]]
    if m > 1:
        assert int((idx[1] >= 0).sum()) == 0
    empty = c.n_lines == 0
    assert (model == "short_64") == bool(empty.any())
    assert bool((got[:, empty] == NEG32).all())
    assert bool((want[:, empty] == NEG32).all())
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("model", K8_MODELS)
def test_k8_rows_invariant(dev, model):
    """K8's rows are the same bits under a permutation of the rows and
    under leading axes."""
    re, im, lines, c, gain = _k8_inputs(dev, model, seed=1)
    got = tk8.psy_smr_rows(re, im, lines, c, gain)
    perm = torch.randperm(re.shape[0], device=dev)
    assert torch.equal(tk8.psy_smr_rows(
        re[perm], im[perm], lines[perm], c,
        None if gain is None else gain[perm]), got[perm])
    lead = tk8.psy_smr_rows(re[:2048].reshape(512, 4, -1),
                            im[:2048].reshape(512, 4, -1),
                            lines[:2048].reshape(512, 4, -1), c,
                            None if gain is None else gain[:2048].reshape(
                                512, 4))
    assert torch.equal(lead.reshape(2048, -1), got[:2048])


def test_k8_refuses_bad_arguments(dev):
    """K8 raises on a float64 row, mismatched shapes, a width other than
    the constants' H, a per-row gain of the wrong shape, constants on the
    CPU, rows on the CPU; a psy call on the card in parity never launches
    it."""
    from tac_torch import psy

    re, im, lines, c, gain = _k8_inputs(dev, "line_256_gain", m=8)
    bad = [dict(re=re.double()), dict(lines=lines[:4]),
           dict(re=re[:, :128], im=im[:, :128], lines=lines[:, :128]),
           dict(gain=gain[:4]), dict(gain=gain.double())]
    for change in bad:
        kw = dict(re=re, im=im, lines=lines, gain=gain)
        kw.update(change)
        with pytest.raises(ValueError, match="psy_smr_rows"):
            tk8.psy_smr_rows(kw["re"], kw["im"], kw["lines"], c, kw["gain"])
    cpu_c = psy.make_consts(PRESETS["streaming-ll"], "cpu")
    with pytest.raises(ValueError, match="psy_smr_rows"):
        tk8.psy_smr_rows(re, im, lines, cpu_c)
    with pytest.raises(ValueError, match="psy_smr_rows"):
        tk8.psy_smr_rows(re.cpu(), im.cpu(), lines.cpu(), cpu_c)
    before = tk8.psy_smr_rows.launches
    cp = psy.make_consts(PRESETS["streaming-ll"].replace(precision="parity"),
                         dev)
    frames = _noisy_rows(dev, 8, 512).double()
    psy.calc_smrs(frames, frames[:, :256], cp)
    torch.cuda.synchronize()
    assert tk8.psy_smr_rows.launches == before
