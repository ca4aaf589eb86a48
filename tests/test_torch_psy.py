"""PyTorch port vs tac: the psychoacoustic model (tac_torch/psy.py) and the
constants both packages share (tac_torch/consts.py). Both packages get the
same constants (tac's, via consts_from_numpy) and the same numpy frames."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tac import codec as jc
from tac import psy as jp
from tac.config import PRESETS as JPRESETS
from tac_torch import codec as tc
from tac_torch import consts as tconsts
from tac_torch import psy as tp
from tac_torch.config import PRESETS as TPRESETS


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tac_arrays(jcons) -> dict:
    """tac's CodecConsts / PsyConsts leaves as numpy arrays."""
    out = {k: np.asarray(getattr(jcons, k)) for k in tconsts.CODEC_LEAVES}
    p = jcons.psy
    out["psy"] = None if p is None else {
        k: None if getattr(p, k) is None else np.asarray(getattr(p, k))
        for k in tconsts.PSY_LEAVES}
    return out


def _frames(rng, fs, n, count):
    t = np.arange(count * n // 2 + n) / fs
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 3100 * t)
         + 0.05 * rng.standard_normal(len(t)))
    idx = np.arange(count)[:, None] * (n // 2) + np.arange(n)[None, :]
    return x[idx]


@pytest.mark.parametrize("preset,precision", [("stereo44-128", "fast"),
                                              ("stereo44-128", "parity"),
                                              ("mono16-64", "parity")])
def test_consts_from_numpy_equals_make_consts(preset, precision):
    """tac's constant arrays uploaded by consts_from_numpy equal the port's
    own make_consts leaf by leaf (values and dtype), scalars included."""
    jcfg = JPRESETS[preset].replace(precision=precision)
    tcfg = TPRESETS[preset].replace(precision=precision)
    jcons = jc.make_consts(jcfg)
    got = tconsts.consts_from_numpy(tcfg, _tac_arrays(jcons), "cpu")
    own = tc.make_consts(tcfg, torch.device("cpu"))
    pairs = [(k, getattr(got, k), getattr(own, k)) for k in tconsts.CODEC_LEAVES]
    if own.psy is not None:
        alone = tp.make_consts(tcfg, "cpu")        # tac/psy.py:make_consts
        pairs += [("psy-alone." + k, getattr(alone, k), getattr(own.psy, k))
                  for k in tconsts.PSY_LEAVES]
        pairs += [("psy." + k, getattr(got.psy, k), getattr(own.psy, k))
                  for k in tconsts.PSY_LEAVES]
        for k in ("fft_gain", "mdct_gain", "band_thresh", "band_ranges"):
            assert getattr(own.psy, k) == getattr(jcons.psy, k), k
    else:
        assert jcons.psy is None and got.psy is None
    for k, a, b in pairs:
        if a is None or b is None:
            assert a is None and b is None, k
            continue
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert own.budget == jcons.budget and own.mdct_gain == jcons.mdct_gain
    assert own.band_ranges == jcons.band_ranges


def test_band_smrs_fast_match_tac(rng):
    """Flagship fast path (band-granular psy, f32): SMRs within 2e-3 dB.
    Both sides compute in f32 with other summation orders (XLA:CPU vs
    PyTorch matmuls and reductions): a few f32 ulp of intensity, far below
    the 1/16-dB decision grid."""
    cfg = JPRESETS["stereo44-128"]
    jcons = jc.make_consts(cfg)
    tcons = tconsts.consts_from_numpy(TPRESETS["stereo44-128"],
                                      _tac_arrays(jcons), "cpu")
    assert tcons.psy.band_thresh and jcons.psy.band_thresh
    fr = _frames(rng, 44100, 2048, 24).astype(np.float32)
    lines = fr @ np.asarray(jcons.fwd_basis)
    want = np.asarray(jax.jit(jax.vmap(
        lambda f, l: jp.calc_smrs(f, l, jcons.psy)))(
        jnp.asarray(fr), jnp.asarray(lines)))
    got = tp.calc_smrs(torch.from_numpy(fr), torch.from_numpy(lines),
                       tcons.psy).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_line_smrs_parity_match_tac(rng):
    """Parity path (line-granular psy, f64 FFT): SMRs within 1e-9 dB."""
    cfg = JPRESETS["stereo44-128"].replace(precision="parity")
    jcons = jc.make_consts(cfg)
    tcons = tconsts.consts_from_numpy(cfg_t := TPRESETS["stereo44-128"].replace(
        precision="parity"), _tac_arrays(jcons), "cpu")
    assert not tcons.psy.band_thresh and cfg_t.precision == "parity"
    fr = _frames(rng, 44100, 2048, 8)
    lines = np.asarray(jax.jit(jax.vmap(
        lambda f: jc.analyze_frame(f, cfg, jcons)[0]))(jnp.asarray(fr)))
    want = np.asarray(jax.jit(jax.vmap(
        lambda f, l: jp.calc_smrs(f, l, jcons.psy)))(
        jnp.asarray(fr), jnp.asarray(lines)))
    got = tp.calc_smrs(torch.from_numpy(fr), torch.from_numpy(lines),
                       tcons.psy).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    thr_t = tp.masked_threshold(torch.from_numpy(fr), tcons.psy).numpy()
    thr_j = np.asarray(jax.jit(jax.vmap(
        lambda f: jp.masked_threshold(f, jcons.psy)))(jnp.asarray(fr)))
    np.testing.assert_allclose(thr_t, thr_j, rtol=1e-9, atol=0)


def test_tied_peaks_keep_lowest_indices():
    """More equal peaks than max_maskers: the stable sort must keep the
    lowest-index peaks, exactly as tac's two-key sort does — same masker
    set, same order, same noise-masker exclusion."""
    cfg = JPRESETS["stereo44-128"]
    jcons = jc.make_consts(cfg)
    tcons = tconsts.consts_from_numpy(TPRESETS["stereo44-128"],
                                      _tac_arrays(jcons), "cpu")
    h = cfg.n_mdct_lines
    ii = np.full(h, 1e-6, np.float32)
    ii[5:1000:6] = 1.0                  # 166 identical isolated peaks
    ii[3] = 2.0                         # one clear winner
    peak_t, top_i_t, idx_t, *_ = tp._tonal_maskers(
        torch.from_numpy(ii)[None], tcons.psy)
    peak_j, top_i_j, idx_j, *_, valid_j, k = jp._tonal_maskers(
        jnp.asarray(ii), jcons.psy)
    np.testing.assert_array_equal(idx_t[0].numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(top_i_t[0].numpy(), np.asarray(top_i_j))
    assert idx_t[0, 0] == 3 and list(idx_t[0, 1:4]) == [5, 11, 17]
    ln_t, nv_t = tp._noise_band_maskers(
        torch.from_numpy(ii)[None], peak_t, top_i_t, idx_t, top_i_t > 0, k,
        tcons.psy)
    ln_j, nv_j = jp._noise_band_maskers(jnp.asarray(ii), peak_j, top_i_j,
                                        idx_j, valid_j, k, jcons.psy)
    np.testing.assert_array_equal(nv_t[0].numpy(), np.asarray(nv_j))
    np.testing.assert_allclose(ln_t[0].numpy(), np.asarray(ln_j), rtol=0,
                               atol=1e-4)   # f32 per-band sums, other order
