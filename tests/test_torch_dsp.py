"""PyTorch port vs tac: windows, MDCT bases, framing, FFT MDCT and the
quantizer (tac_torch/dsp, tac_torch/quant.py). Inputs are made with numpy
from a seed and handed to both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tac import quant as jq
from tac.dsp import mdct as jm
from tac.dsp import window as jw
from tac_torch import quant as tq
from tac_torch.dsp import mdct as tm
from tac_torch.dsp import window as tw


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ["sine", "hann", "kbd"])
@pytest.mark.parametrize("n", [16, 2048])
def test_windows_equal(name, n):
    # identical NumPy f64 construction: exact
    np.testing.assert_array_equal(tw.window_fn(name, n, 4.0),
                                  jw.window_fn(name, n, 4.0))


@pytest.mark.parametrize("h", [64, 1024])
def test_bases_equal(h):
    w = jw.sine_window(2 * h)
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(tm.mdct_basis(h, w, dt),
                                      jm.mdct_basis(h, w, dt))
        np.testing.assert_array_equal(tm.imdct_basis(h, w, dt),
                                      jm.imdct_basis(h, w, dt))


@pytest.mark.parametrize("t", [1, 64, 65, 639])
def test_framing_and_overlap_add_equal(rng, t):
    h = 64
    x = rng.uniform(-1, 1, (2, t))
    fr_t = tm.frame_signal(torch.from_numpy(x), h)
    fr_j = np.asarray(jm.frame_signal(jnp.asarray(x), h))
    assert fr_t.shape == (2, tm.num_frames(t, h), 2 * h)
    np.testing.assert_array_equal(fr_t.numpy(), fr_j)          # pure copies
    y = rng.standard_normal(fr_j.shape)
    np.testing.assert_allclose(                                 # one add each
        tm.overlap_add(torch.from_numpy(y), h, t).numpy(),
        np.asarray(jm.overlap_add(jnp.asarray(y), h, t)), rtol=0, atol=0)


@pytest.mark.parametrize("h", [8, 512, 1024])
def test_mdct_fft_matches_tac_and_direct(rng, h):
    x = rng.standard_normal((3, 2 * h))
    got = tm.mdct_fft(torch.from_numpy(x), h).numpy()
    # SPEC §10.3: f64 FFT forms within 1e-11 of each other and the direct sum
    np.testing.assert_allclose(got, np.asarray(jm.mdct_fft(jnp.asarray(x), h)),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(got, jm.mdct_direct(x, h), rtol=0, atol=1e-11)
    np.testing.assert_allclose(tm.mdct_direct(torch.from_numpy(x), h).numpy(),
                               jm.mdct_direct(x, h), rtol=0, atol=1e-11)
    X = rng.standard_normal((3, h))
    np.testing.assert_allclose(tm.imdct_fft(torch.from_numpy(X), h).numpy(),
                               np.asarray(jm.imdct_fft(jnp.asarray(X), h)),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(tm.imdct_direct(torch.from_numpy(X), h).numpy(),
                               jm.imdct_direct(X, h), rtol=0, atol=1e-11)


def test_perfect_reconstruction(rng):
    """window → MDCT → IMDCT → window → OLA reproduces the signal (SPEC §3);
    f64 round trip within 1e-11."""
    h = 128
    w = torch.from_numpy(tw.sine_window(2 * h))
    t = 7 * h + 13
    x = torch.from_numpy(rng.uniform(-1, 1, (2, t)))
    fr = tm.frame_signal(x, h) * w
    out = tm.overlap_add(tm.imdct_fft(tm.mdct_fft(fr, h), h) * w, h, t)
    np.testing.assert_allclose(out.numpy(), x.numpy(), rtol=0, atol=1e-11)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantizer_integer_exact(rng, dtype):
    """quantize / scale factor / mantissa / dequantize equal tac's for every
    mantissa width 0..16 (integer results exact; dequantized floats exact
    too: the same IEEE operations in the same order)."""
    a = (rng.uniform(-1, 1, (17, 256)) * 2.0 ** -rng.integers(0, 14, (17, 1))
         ).astype(dtype)
    m = np.repeat(np.arange(17, dtype=np.int32)[:, None], 256, 1)
    at, mt = torch.from_numpy(a), torch.from_numpy(m)
    aj, mj = jnp.asarray(a), jnp.asarray(m)
    np.testing.assert_array_equal(tq.quantize_uniform(at, mt + 15).numpy(),
                                  np.asarray(jq.quantize_uniform(aj, mj + 15)))
    sf_t = tq.scale_factor(at, 4, mt)
    sf_j = jq.scale_factor(aj, 4, mj)
    np.testing.assert_array_equal(sf_t.numpy(), np.asarray(sf_j))
    mant_t = tq.mantissa(at, sf_t, 4, mt)
    mant_j = jq.mantissa(aj, sf_j, 4, mj)
    np.testing.assert_array_equal(mant_t.numpy(), np.asarray(mant_j))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    np.testing.assert_array_equal(
        tq.dequantize_mantissa(mant_t, sf_t, 4, mt, tdt).numpy(),
        np.asarray(jq.dequantize_mantissa(
            mant_j, sf_j, 4, mj,
            jnp.float64 if dtype == np.float64 else jnp.float32)))
