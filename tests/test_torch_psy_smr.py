"""PyTorch port: K8 (the fast psy model after its DFT, tac_torch/csrc/
psy_smr.cu) on the CPU.

- A plain-torch emulation of K8's arithmetic (the candidates as 64-bit
  (value, index) keys in a total order, masker intensities added in rank
  order, noise bands added in index order in double, the band model's
  (masker, band) table, band maxima) against ``calc_smrs``'s plain model
  on the band model at H = 1 024, the line model at H = 256 with a per-row
  gain, the short line model at H = 64 (every line a candidate) and a
  preset with the noise maskers off: the same kept maskers, SMRs within
  0.001 dB, empty bands exactly ``_NEG``; on noisy rows, tied peaks, silent
  rows;
- CPU and float64 (parity) frames take the plain path: the counter does
  not move;
- the wrapper's argument checks (CPU tensors included: it launches or
  raises), and on a CUDA tensor whose kernel cannot be built it raises and
  never runs the plain model.
"""

import numpy as np
import pytest
import torch

from tac_torch import _build
from tac_torch import blockswitch as tbs
from tac_torch import codec as tc
from tac_torch import psy
from tac_torch.config import PRESETS
from tac_torch.ops import psy_smr as k8

NEG32 = float(np.float32(psy._NEG))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _spread_i(z, zm, up, top):
    """[R] maskers at points z [P] → intensities [R, P] (K8's spread_i)."""
    dz = z - zm[:, None]
    drop = torch.where(dz < 0, 27.0 * (-dz), up[:, None] * dz)
    return psy.intensity_from_spl(top[:, None] - drop)


def _up_slope(lvl):
    return torch.clamp(27.0 - 0.367 * torch.clamp(lvl - 40.0, min=0.0),
                       min=0.0)


def _k8_emulated(re, im, lines, c, gain=None):
    """K8's arithmetic in plain torch on rows [R, H] → (smr [R, B], kept
    maskers' indices [R, k], -1 past the valid ones)."""
    r, h = re.shape
    ii = c.fft_gain * (re * re + im * im)
    inf = torch.full((r, 1), float("inf"))
    zero = torch.zeros((r, 1))
    is_peak = ((ii > torch.cat([inf, ii[:, :-1]], 1))
               & (ii >= torch.cat([ii[:, 1:], inf], 1)))
    agg = (ii + torch.cat([zero, ii[:, :-1]], 1)) + torch.cat([ii[:, 1:], zero],
                                                              1)
    peak = torch.where(is_peak, agg, 0.0)
    k = min(c.max_maskers, h)
    if k <= h // 2:                       # pair compaction
        pa, pb = peak[:, 0::2], peak[:, 1::2]
        sel = pb > pa
        val = torch.where(sel, pb, pa)
        idx = torch.arange(h // 2) * 2 + sel.long()
    else:
        val, idx = peak, torch.arange(h).expand(r, h)
    # the kernel's keys: (0x7fffffff - bits(value)) << 32 | index, ascending
    keys = ((0x7FFFFFFF - val.view(torch.int32).long()) << 32) | idx
    keys = torch.sort(keys, dim=1).values[:, :k]
    top_v = (0x7FFFFFFF - (keys >> 32)).to(torch.int32).view(torch.float32)
    top_idx = keys & 0xFFFFFFFF
    valid = top_v > 0.0
    prod = ii * c.freqs
    pc = prod.gather(1, top_idx)
    pl = torch.where(top_idx > 0, prod.gather(1, (top_idx - 1).clamp(min=0)),
                     pc)
    pr = torch.where(top_idx < h - 1,
                     prod.gather(1, (top_idx + 1).clamp(max=h - 1)), pc)
    fm = ((pl + pc) + pr) / torch.clamp(top_v, min=1e-40)
    lm = psy.spl_from_intensity(top_v)
    m_z, m_up, m_top = psy.bark(fm), _up_slope(lm), lm - c.delta_tonal
    nb = len(c.band_ranges)
    if c.noise_maskers:
        thr = top_v[:, k - 1:k]
        tie = torch.where(valid[:, k - 1:k], top_idx[:, k - 1:k], -1)
        kept = (peak > 0.0) & ((peak > thr) | ((peak == thr)
                                              & (torch.arange(h) <= tie)))
        no = torch.zeros((r, 1), dtype=torch.bool)
        near = (kept | torch.cat([kept[:, 1:], no], 1)
                | torch.cat([no, kept[:, :-1]], 1))
        nline = torch.where(near, 0.0, ii).double()
        e = torch.zeros((r, nb), dtype=torch.float64)
        for b, (s, t) in enumerate(c.band_ranges):
            for i in range(s, t):                 # index order, in double
                e[:, b] = e[:, b] + nline[:, i]
        e = e.float()
        ln = psy.spl_from_intensity(e)
        n_ok, n_up, n_top = e > 0.0, _up_slope(ln), ln - c.delta_noise
    g = c.mdct_gain if gain is None else gain[:, None]
    line_spl = psy.spl_from_intensity(g * (lines * lines))
    if c.band_thresh:
        zlo, zhi = c.zedge_lo, c.zedge_hi
        acc = torch.zeros((r, nb))
        for m in range(k):                        # rank order
            v = torch.minimum(_spread_i(zlo, m_z[:, m], m_up[:, m], m_top[:, m]),
                              _spread_i(zhi, m_z[:, m], m_up[:, m], m_top[:, m]))
            acc = torch.where(valid[:, m:m + 1], acc + v, acc)
        if c.noise_maskers:
            accn = torch.zeros((r, nb))
            for b in range(nb):
                nz = c.noise_z[b].expand(r)
                v = torch.minimum(_spread_i(zlo, nz, n_up[:, b], n_top[:, b]),
                                  _spread_i(zhi, nz, n_up[:, b], n_top[:, b]))
                accn = torch.where(n_ok[:, b:b + 1], accn + v, accn)
            acc = acc + accn
        thr_spl = psy.spl_from_intensity(acc + c.quiet_band_i)
        smr = torch.stack([line_spl[:, s:t].amax(1) - thr_spl[:, b] if t > s
                           else torch.full((r,), NEG32)
                           for b, (s, t) in enumerate(c.band_ranges)], 1)
    else:
        acc = torch.zeros((r, h))
        for m in range(k):
            v = _spread_i(c.zline, m_z[:, m], m_up[:, m], m_top[:, m])
            acc = torch.where(valid[:, m:m + 1], acc + v, acc)
        if c.noise_maskers:
            accn = torch.zeros((r, h))
            for b in range(nb):
                v = _spread_i(c.zline, c.noise_z[b].expand(r), n_up[:, b],
                              n_top[:, b])
                accn = torch.where(n_ok[:, b:b + 1], accn + v, accn)
            acc = acc + accn
        d = line_spl - psy.spl_from_intensity(acc + c.quiet_i)
        smr = torch.stack([d[:, s:t].amax(1) if t > s
                           else torch.full((r,), NEG32)
                           for s, t in c.band_ranges], 1)
    return smr, torch.where(valid, top_idx, -1).to(torch.int32)


def _plain(re, im, lines, c, gain=None):
    """The plain model on the DFT rows → (smr [R, B], kept maskers'
    indices [R, k], -1 past the valid ones)."""
    ii = c.fft_gain * (re * re + im * im)
    _, _, top_idx, _, _, valid, _ = psy._tonal_maskers(ii, c)
    return (psy.smrs_from_intensity(ii, lines, c, gain),
            torch.where(valid, top_idx, -1).to(torch.int32))


def _consts(model):
    """(psy constants, whether a per-row gain applies) of each model."""
    if model == "band_1024":
        return psy.make_consts(PRESETS["stereo44-128"], "cpu"), False
    if model == "no_noise":
        cfg = PRESETS["stereo44-128"].replace(psy_noise_maskers=False)
        return psy.make_consts(cfg, "cpu"), False
    c = tbs.make_bs_consts(PRESETS["streaming-ll"], torch.device("cpu"))
    return (c.cl.psy, True) if model == "line_256_gain" else (c.psy_short,
                                                              False)


def _rows(c, m, seed):
    """(re, im, lines) [m, H]: a tied-peaks row (more equal isolated peaks
    than maskers, one clear winner), a silent row, then noisy harmonic
    frames through the psy DFT and a stand-in MDCT."""
    h = c.freqs.shape[0]
    rng = np.random.default_rng(seed)
    t = np.arange(m * 2 * h).reshape(m, 2 * h) / 44100.0
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 3100 * t)
         + 0.05 * rng.standard_normal((m, 2 * h))).astype(np.float32)
    xt = torch.from_numpy(x)
    re, im = xt @ c.fft_cos, xt @ c.fft_sin
    ii = np.full(h, 1e-6, np.float32)
    ii[5:h - 2:3] = 1.0                  # isolated, equal peaks
    ii[3] = 2.0
    re[0] = torch.from_numpy(np.sqrt(ii / c.fft_gain).astype(np.float32))
    im[0] = 0.0
    re[1] = im[1] = 0.0
    lines = torch.from_numpy((0.3 * rng.standard_normal((m, h))
                              ).astype(np.float32))
    lines[1] = 0.0
    return re.contiguous(), im.contiguous(), lines


@pytest.mark.parametrize("model", ["band_1024", "line_256_gain", "short_64",
                                   "no_noise"])
def test_k8_emulation_equals_plain(model):
    """K8's arithmetic against calc_smrs's plain model: the same kept
    maskers (tied peaks keep the lowest indices), SMRs within 0.001 dB,
    empty bands exactly _NEG."""
    c, per_row = _consts(model)
    h = c.freqs.shape[0]
    re, im, lines = _rows(c, 6, h)
    gain = (torch.tensor([1.0, 2.5, 8.0, 3.2, 7.7, 0.9], dtype=torch.float32)
            if per_row else None)
    got, idx = _k8_emulated(re, im, lines, c, gain)
    want, want_idx = _plain(re, im, lines, c, gain)
    assert torch.equal(idx, want_idx)
    k = min(c.max_maskers, h)
    # the clear winner, then the equal peaks from the lowest index up
    peaks = [3] + list(range(5, h - 2, 3))
    assert idx.shape == (6, k) and idx[0].tolist() == (
        peaks + [-1] * k)[:k]
    assert int((idx[1] >= 0).sum()) == 0
    empty = c.n_lines == 0
    assert bool((got[:, empty] == NEG32).all())
    assert bool((want[:, empty] == NEG32).all())
    assert (model == "short_64") == bool(empty.any())
    assert float((got - want).abs().max()) <= 1e-3
    assert bool(torch.isfinite(got).all())


def test_cpu_and_parity_take_the_plain_path():
    """calc_smrs on CPU frames (fast, f32) and in parity (f64, the FFT) runs
    the plain model: K8's counter does not move, and the fast result is
    the plain model's on the DFT rows."""
    before = k8.psy_smr_rows.launches
    cfg = PRESETS["stereo44-128"]
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.standard_normal((3, 2048)).astype(np.float32))
    lines = torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32))
    c = tc.make_consts(cfg, torch.device("cpu"))
    got = psy.calc_smrs(frames, lines, c.psy)
    re, im = psy._dft(frames, c.psy)
    assert torch.equal(got, _plain(re, im, lines, c.psy)[0])
    cp = tc.make_consts(cfg.replace(precision="parity"), torch.device("cpu"))
    smr = psy.calc_smrs(frames.double(), lines.double(), cp.psy)
    assert smr.dtype == torch.float64
    assert k8.psy_smr_rows.launches == before


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: reaches the wrapper's
    kernel branch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, t)


@pytest.mark.parametrize("case", ["dtype", "shape", "width", "gain_shape",
                                  "gain_dtype", "consts_device",
                                  "cpu_tensors"])
def test_k8_wrapper_refuses_bad_arguments(case, monkeypatch):
    """The wrapper checks its arguments before it loads the kernel: a
    wrong dtype, mismatched shapes, a width other than the constants' H, a
    per-row gain of the wrong shape or dtype, constants on another device,
    rows on the CPU (the plain model is ``calc_smrs``'s to run)."""
    monkeypatch.setattr(_build, "entry", lambda *a, **kw: pytest.fail(
        "the kernel was loaded for a call it refuses"))
    c, _ = _consts("line_256_gain")
    cc = c._replace(freqs=_on_card(c.freqs))
    x = torch.ones(4, 256)
    re, im, lines = _on_card(x), _on_card(x.clone()), _on_card(x.clone())
    gain = None
    if case == "dtype":
        re = _on_card(x.double())
    elif case == "shape":
        lines = _on_card(torch.ones(2, 2, 256))
    elif case == "width":
        re, im, lines = (_on_card(torch.ones(4, 128)) for _ in range(3))
    elif case == "gain_shape":
        gain = _on_card(torch.ones(4, 1))
    elif case == "gain_dtype":
        gain = _on_card(torch.ones(4, dtype=torch.float64))
    elif case == "consts_device":
        cc = c
    else:
        re, im, lines, cc = x, x.clone(), x.clone(), c
    with pytest.raises(ValueError, match="psy_smr_rows"):
        k8.psy_smr_rows(re, im, lines, cc, gain)


def test_k8_wrapper_raises_without_its_kernel(monkeypatch):
    """On a CUDA tensor the wrapper launches its kernel or raises: with no
    kernel to load it raises the loader's error and never runs the plain
    model."""
    def no_kernel(*a, **kw):
        raise RuntimeError("nvcc not found: set CUDA_HOME")

    def fell_back(*a, **kw):
        raise AssertionError("the wrapper fell back to the plain model")

    monkeypatch.setattr(_build, "entry", no_kernel)
    monkeypatch.setattr(psy, "smrs_from_intensity", fell_back)
    c, _ = _consts("band_1024")
    c = c._replace(freqs=_on_card(c.freqs))
    x = _on_card(torch.ones(2, 1024))
    before = k8.psy_smr_rows.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k8.psy_smr_rows(x, x, x, c)
    assert k8.psy_smr_rows.launches == before
