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


def _rna_tf32_reference(v: np.ndarray) -> np.ndarray:
    """TF32 rounding of f32 values in float64 arithmetic: 11 significant
    bits, to nearest, ties away from zero (zeros and subnormals included)."""
    v64 = v.astype(np.float64)
    mag = np.abs(v64)
    e = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    e = np.maximum(e, -126)                        # subnormals: fixed ulp
    ulp = np.exp2(e - 10)
    return (np.sign(v64) * np.floor(mag / ulp + 0.5) * ulp).astype(np.float32)


def test_split_tf32_is_round_to_nearest_and_exact():
    """K5's operand split: big has its low 13 mantissa bits zero and is v
    rounded to TF32 as PTX cvt.rna does (ties away from zero), and
    big + small == v exactly in f32."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal(4000).astype(np.float32) * np.float32(
        10.0) ** rng.integers(-30, 30, 4000).astype(np.float32)
    bits = base.view(np.uint32)
    ties = ((bits & ~np.uint32(0x1FFF)) | np.uint32(0x1000)).view(np.float32)
    special = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -3e-39, 3.4e38, 1.0 + 2 ** -11,
                        1.0 + 3 * 2 ** -11], np.float32)
    v = np.concatenate([base, ties, special])
    big, small = tk5.split_tf32(torch.tensor(v))
    big, small = big.numpy(), small.numpy()
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_equal(big, _rna_tf32_reference(v))
    np.testing.assert_array_equal(big + small, v)
    # ties go away from zero: 1 + 2^-11 -> 1 + 2^-10, 1 + 3·2^-11 -> 1 + 2^-9
    np.testing.assert_array_equal(big[-2:], np.float32([1 + 2 ** -10, 1 + 2 ** -9]))


def _three_term_tf32(frames: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """The kernel's product emulated in plain torch: both operands split,
    the small parts read by the tensor core with their low 13 bits cut (the
    worst a TF32 read can do to them), three f32 products summed smallest
    first."""
    def cut(t):
        return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)

    fb, fs = tk5.split_tf32(frames)
    bb, bs = tk5.split_tf32(basis)
    return (cut(fs) @ bb + fb @ cut(bs)) + fb @ bb


@pytest.mark.parametrize("what,h", [("stereo clip 2 s", 1024), ("white noise", 256)])
def test_split_tf32_product_keeps_full_f32_accuracy(what, h):
    """The 3×TF32 product stays within K5's gate (5e-6 · max|ref|) of the
    f32 product, with a margin: under 1e-6 · max|ref|, on a 2-s harmonic
    stereo clip at h = 1024 and on white noise at h = 256."""
    rng = np.random.default_rng(h)
    if what == "white noise":
        x = rng.standard_normal((2, 44100)).astype(np.float32)
    else:
        t = np.arange(2 * 44100) / 44100
        sig = sum(a * np.sin(2 * np.pi * 440 * k * t)
                  for k, a in [(1, 0.4), (2, 0.2), (3, 0.1), (7, 0.03)])
        x = np.stack([sig, 0.8 * sig + 0.02 * rng.standard_normal(len(t))])
        x = x.astype(np.float32)
    basis = torch.tensor(tm.mdct_basis(h, sine_window(2 * h)), dtype=torch.float32)
    frames = tk5.pad_signal(torch.tensor(x), h).unfold(-1, 2 * h, h)
    ref = frames @ basis
    got = _three_term_tf32(frames, basis)
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-6, err
    assert err <= 5e-6
    # one TF32 pass misses the gate: the split is what keeps full accuracy
    fb, _ = tk5.split_tf32(frames)
    bb, _ = tk5.split_tf32(basis)
    one = float((fb @ bb - ref).abs().max()) / float(ref.abs().max())
    assert one > 5e-6, one
