"""PyTorch port vs tac: the fixed-rate codec end to end (tac_torch/codec.py,
api.py, bitstream.py) — decision layers byte for byte, fast-mode round
trip, cross-decoding, the golden parity digests, and the device policy."""

import hashlib
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tac import api as japi
from tac import codec as jc
from tac.config import PRESETS as JPRESETS
from tac.dsp import mdct as jm
from tac.ops import bitpack as jbp
from tac_torch import api as tapi
from tac_torch import bitstream as tbs
from tac_torch import codec as tc
from tac_torch.config import PRESETS as TPRESETS
from tac_torch.ops import bitpack as tbp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def clip44():
    """The parity suite's 0.5 s stereo multi-sine (tests/test_parity.py)."""
    fs = 44100
    t = np.arange(fs // 2) / fs
    sig = sum(a * np.sin(2 * np.pi * f * t)
              for a, f in [(0.43, 440), (0.24, 554), (0.15, 660),
                           (0.12, 880), (0.05, 4400), (0.03, 8800)])
    rng = np.random.default_rng(42)
    return np.stack([sig, 0.8 * sig + 0.02 * rng.standard_normal(len(t))], 1)


def _snr(x, y):
    return 10 * np.log10(np.mean(x ** 2) / max(np.mean((x - y) ** 2), 1e-30))


def test_decision_layers_byte_identical(clip44):
    """SPEC §10.1: fed tac's own MDCT lines and SMRs (flagship, fast), the
    port's allocation (K1's plain version), quantizer, field layout and
    packer (K2's plain version) give tac's payload words and stream bytes
    exactly."""
    cfg = JPRESETS["stereo44-128"]
    c = jc.make_consts(cfg)
    frames = jm.frame_signal(jnp.asarray(clip44.T, c.dtype), cfg.n_mdct_lines)
    frames = frames.reshape(-1, frames.shape[-1])
    # tac's layers jitted, as its encode runs them (eager vmaps dispatch op
    # by op: four times the time for the same integers)
    lines, smr = jax.jit(jax.vmap(lambda f: jc.analyze_frame(f, cfg, c)))(
        frames)
    code = jax.jit(jax.vmap(lambda l, s: jc.quantize_lines(l, s, cfg, c)))(
        lines, smr)
    cap = jc.payload_capacity_bits(cfg, c)
    want_w, want_n = jax.jit(lambda code: jbp.pack_rows(
        *jc.payload_fields(code, cfg, c), cap))(code)

    tcfg = TPRESETS["stereo44-128"]
    tcons = tc.make_consts(tcfg, CPU)
    assert tc.payload_capacity_bits(tcfg, tcons) == cap
    lt, st = torch.tensor(np.asarray(lines)), torch.tensor(np.asarray(smr))
    tcode = tc.quantize_given_alloc(lt, tc.allocate_rows(st, tcfg, tcons),
                                    tcfg, tcons)
    for k in ("ovs", "alloc_code", "scale", "mant"):
        np.testing.assert_array_equal(getattr(tcode, k).numpy(),
                                      np.asarray(getattr(code, k)), err_msg=k)
    got_w, got_n = tbp.pack_rows(*tc.payload_fields(tcode, tcfg, tcons), cap)
    got_w = got_w.numpy().view(np.uint32)
    np.testing.assert_array_equal(got_w, np.asarray(want_w))
    assert tbp.rows_to_stream(got_w, got_n.numpy()) == jbp.rows_to_stream(
        np.asarray(want_w), np.asarray(want_n))


def test_fast_round_trip_and_cross_decode(clip44):
    """Flagship fast path vs tac fast: round-trip SNR within 0.1 dB and
    ≥ 99.9 % of mantissas equal (SPEC §10, as tests/test_parity.py holds
    fast against parity); each package decodes the other's stream to what
    the stream's own package decodes (f32 IMDCT: within 1e-5)."""
    x = clip44
    d_tac = japi.encode_array(x, JPRESETS["stereo44-128"])
    d_port = tapi.encode_array(x, TPRESETS["stereo44-128"], device="cpu")
    y_tt = japi.decode_array(d_tac, precision="fast")[0]
    y_pp = tapi.decode_array(d_port, precision="fast", device="cpu")[0]
    assert y_pp.shape == x.shape and y_pp.dtype == np.float32
    assert abs(_snr(x, y_tt) - _snr(x, y_pp)) < 0.1

    def mantissas(data):
        hdr, off = tbs.read_header(data)
        cfg = tapi.header_config(hdr, "fast")
        f = jm.num_frames(hdr.num_samples, hdr.n_mdct_lines)
        offs, lens = tbs.split_blocks(data, off, f * hdr.n_channels)
        w32 = -(-tc.payload_capacity_bits(cfg) // 32)
        rows = tbp.stream_to_rows(data, offs, lens, w32).view(np.int32)
        return tc._unpack_raw_fields(torch.from_numpy(rows), cfg,
                                     tc.make_consts(cfg, CPU)).mant.numpy()

    assert np.mean(mantissas(d_tac) == mantissas(d_port)) >= 0.999
    y_pt = tapi.decode_array(d_tac, precision="fast", device="cpu")[0]
    y_tp = japi.decode_array(d_port, precision="fast")[0]
    np.testing.assert_allclose(y_pt, y_tt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(y_tp, y_pp, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,preset,material", [
    ("config1_mono16_64", "mono16-64", "mono16"),
    ("config2_stereo44_128", "stereo44-128", "stereo44")])
def test_parity_digests_match_goldens(name, preset, material):
    """Parity precision (f64, FFT MDCT, line psy, f64 allocation): the
    port's streams hash to goldens/streams.json, and its parity decode
    equals tac's to 1e-7 (f64 FFTs of two libraries, cast to float32)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden

    x, fs = golden.clips()[material]
    cfg = TPRESETS[preset].replace(precision="parity", sample_rate=fs)
    data = tapi.encode_array(x, cfg, device="cpu")
    with open(golden.GOLDEN_PATH) as f:
        want = json.load(f)[name]
    assert {"sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data)} == want
    y = tapi.decode_array(data, device="cpu")[0]
    np.testing.assert_allclose(y, japi.decode_array(data)[0], rtol=0, atol=1e-7)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    """Without a card, entry points raise unless the caller passes
    device="cpu": no silent fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2048, 2))
    for preset in ("stereo44-128", "vbr-huffman"):
        cfg = TPRESETS[preset]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.encode_array(x, cfg)
        data = tapi.encode_array(x, cfg, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.decode_array(data)
    with pytest.raises(RuntimeError):
        tc.encode_clip_packed(x.T, TPRESETS["stereo44-128"])


@pytest.mark.parametrize("preset", ["stereo44-128-ms", "vbr-ms", "ms-bs",
                                    "vbr-ms-bs"])
def test_ms_odd_channels_rejected(preset):
    """Mid/side butterflies adjacent channel pairs: a 3-channel array under
    an M/S preset (fixed rate, VBR, block switching, the combo) raises
    ValueError, as tests/test_multichannel.py::test_odd_channels_ms_rejected
    holds for tac, and no stream is written."""
    with pytest.raises(ValueError, match="even channel count"):
        tapi.encode_array(np.zeros((600, 3)), TPRESETS[preset], device="cpu")
    with pytest.raises(ValueError):
        TPRESETS[preset].replace(n_channels=3)
