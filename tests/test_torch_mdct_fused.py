"""PyTorch port vs tac: kernel K5's plain version (tac_torch/ops/mdct_fused.py)
against tac's Pallas fused framing + MDCT kernel in interpret mode and
against ``frame_signal @ basis``, on the cases of tests/test_pallas_mdct.py;
and the filterbank path built on it (tac_torch/filterbank.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tac.dsp import mdct as jm
from tac.dsp.window import sine_window
from tac.ops.pallas_mdct import mdct_frames_pallas
from tac_torch import filterbank
from tac_torch.config import PRESETS as TPRESETS
from tac_torch.dsp import mdct as tm
from tac_torch.ops import mdct_fused as tk5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("h,channels,t", [(256, 2, 256 * 24), (256, 2, 256 * 24 + 123),
                                          (1024, 2, 1024 * 24 + 57),
                                          (256, 1, 256 * 3 + 1)])
def test_plain_k5_equals_tac_kernel_and_reference(h, channels, t):
    """Same seeded signal through tac's Pallas kernel (interpret mode), tac's
    ``frame_signal @ basis`` and the port's plain K5: all agree within
    5e-6 · max|ref| (f32 sums over 2h terms in three orders); T is no
    multiple of h in three cases and F = 5 (odd, mono) in the last."""
    rng = np.random.default_rng(h + t)
    basis = jm.mdct_basis(h, sine_window(2 * h), np.float32)
    x = rng.standard_normal((channels, t)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(mdct_frames_pallas(jnp.asarray(x), h, basis))
    ref = np.asarray(jm.frame_signal(jnp.asarray(x), h) @ jnp.asarray(basis))
    got = tk5.mdct_frames_fused(torch.tensor(x), h, torch.tensor(basis)).numpy()
    assert got.shape == ref.shape == (channels, jm.num_frames(t, h), h)
    tol = 5e-6 * np.max(np.abs(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(got, kern, rtol=0, atol=tol)


def test_plain_k5_is_frame_signal_times_basis():
    """The unfolded view of the padded signal is frame_signal's frame matrix
    exactly (any leading axes), so the plain version is the port's own
    fast-path MDCT."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 3, 1000)).astype(np.float32))
    for h in (64, 128):
        frames = tk5.pad_signal(x, h).unfold(-1, 2 * h, h)
        assert torch.equal(frames, tm.frame_signal(x, h))
        basis = torch.tensor(tm.mdct_basis(h, sine_window(2 * h)))
        got = tk5.mdct_frames_plain(x, h, basis)
        assert got.shape == (2, 3, tm.num_frames(1000, h), h)
        torch.testing.assert_close(got, tm.frame_signal(x, h) @ basis,
                                   rtol=0, atol=1e-6)


def test_k5_wrapper_refuses_what_the_kernel_does_not_take():
    """Only CPU tensors take the plain version; any other device is the
    kernel's or an error (here: the meta device)."""
    basis = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        tk5.mdct_frames_fused(torch.zeros((2, 64), device="meta"), 4, basis)
    before = tk5.mdct_frames_fused.launches
    assert tk5.mdct_frames_fused(torch.zeros((2, 64)), 4, basis).shape == (2, 17, 4)
    assert tk5.mdct_frames_fused.launches == before     # no kernel on the CPU


def test_filterbank_path_round_trip(monkeypatch):
    """PCM → mdct_analysis (K5) → mdct_synthesis → PCM reconstructs the
    signal to f32 rounding (TDAC; over 120 dB), needs a card unless told,
    and its lines are the codec's own fast-path lines."""
    cfg = TPRESETS["stereo44-128"].replace(n_mdct_lines=256)
    rng = np.random.default_rng(8)
    x = (0.3 * rng.standard_normal((3, 2, 5000))).astype(np.float32)
    lines = filterbank.mdct_analysis(x, cfg, device="cpu")
    assert lines.shape == (3, 2, tm.num_frames(5000, 256), 256)
    assert lines.dtype == torch.float32
    y = filterbank.mdct_synthesis(lines, cfg, 5000, device="cpu").numpy()
    assert y.shape == x.shape
    snr = 10 * np.log10(np.mean(x ** 2) / np.mean((x - y) ** 2))
    assert snr > 120.0, snr
    ref = jm.frame_signal(jnp.asarray(x), 256) @ jnp.asarray(
        jm.mdct_basis(256, sine_window(512), np.float32))
    np.testing.assert_allclose(lines.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-6 * float(np.max(np.abs(ref))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        filterbank.mdct_analysis(x, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        filterbank.mdct_synthesis(lines, cfg, 5000)
