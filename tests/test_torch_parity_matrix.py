"""PyTorch port vs tac's oracle across tac's wider config matrix
(tests/test_parity_matrix.py) and on tac's quad material
(tests/test_multichannel.py), on the CPU:

- all nine configurations of the matrix (kbd and hann windows, const_snr,
  const_mnr, H = 512 and 2 048, 48 kHz and 32 kHz, 3 scale bits) encode in
  parity to the oracle's bytes and decode to the clip's shape;
- the quad clip in the raw, vbr and combo families: parity bytes equal
  the oracle's, and the fast round trip passes tac's SNR checks (the
  clip and each channel).
"""

import numpy as np
import pytest
import torch

from tac.config import CodecConfig as JConfig
from tac.config import PRESETS as JPRESETS
from tac.oracle import encode_array as oracle_encode
from tac_torch import api
from tac_torch.config import PRESETS, CodecConfig


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _clip(fs: int) -> np.ndarray:
    """tests/test_parity_matrix.py's clip: two tones and a little noise."""
    t = np.arange(fs // 3) / fs
    rng = np.random.default_rng(9)
    x = (0.4 * np.sin(2 * np.pi * 440 * t)
         + 0.15 * np.sin(2 * np.pi * 1870 * t)
         + 0.01 * rng.standard_normal(len(t)))
    return x[:, None]


@pytest.mark.parametrize("kw", [
    dict(window="kbd"),
    dict(window="hann"),
    dict(alloc_mode="const_snr", use_psy=False),
    dict(alloc_mode="const_mnr"),
    dict(n_mdct_lines=512),
    dict(n_mdct_lines=2048),
    dict(sample_rate=48000),
    dict(sample_rate=32000),
    dict(n_scale_bits=3, n_mant_size_bits=4),
], ids=["kbd", "hann", "const_snr", "const_mnr", "h512", "h2048", "fs48k",
        "fs32k", "scale3"])
def test_byte_parity(kw):
    kw = dict(kw)
    fs = kw.pop("sample_rate", 44100)
    common = dict(sample_rate=fs, n_channels=1, bitrate_bps=96_000,
                  precision="parity", **kw)
    x = _clip(fs)
    data = api.encode_array(x, CodecConfig(**common), device="cpu")
    assert data == oracle_encode(x, JConfig(**common)), f"parity broken for {kw}"
    y, fs2 = api.decode_array(data, device="cpu")
    assert fs2 == fs and y.shape[0] == x.shape[0]


@pytest.fixture(scope="module")
def quad():
    """tests/test_multichannel.py's quad: four tones, a little noise and a
    transient local to channel 2."""
    fs = 16000
    t = np.arange(int(fs * 0.4)) / fs
    rng = np.random.default_rng(3)
    chans = [0.4 * np.sin(2 * np.pi * f0 * t) for f0 in (330, 440, 550, 660)]
    x = np.stack(chans, 1) + 0.01 * rng.standard_normal((len(t), 4))
    x[2500:2600, 2] += np.linspace(0, 0.4, 100)
    return x


def _quad_change(mode: str) -> dict:
    return dict(n_channels=4, bitrate_bps=256_000, n_mdct_lines=256,
                use_psy=(mode != "raw"),
                alloc_mode="greedy" if mode != "raw" else "uniform",
                use_huffman=(mode in ("vbr", "combo")),
                use_block_switch=(mode == "combo"),
                n_mdct_lines_short=64 if mode == "combo" else 0)


@pytest.mark.parametrize("mode", ["raw", "vbr", "combo"])
def test_quad_parity_bytes(mode, quad):
    change = _quad_change(mode)
    data = api.encode_array(quad, PRESETS["mono16-64"].replace(
        precision="parity", **change), device="cpu")
    assert data == oracle_encode(quad, JPRESETS["mono16-64"].replace(
        precision="parity", **change))


@pytest.mark.parametrize("mode", ["raw", "vbr", "combo"])
def test_quad_round_trip(mode, quad):
    """tests/test_multichannel.py::test_quad_round_trip: the fast round
    trip above 5 dB, each channel above 3 dB."""
    cfg = PRESETS["mono16-64"].replace(precision="fast", **_quad_change(mode))
    data = api.encode_array(quad, cfg, device="cpu")
    y, fs = api.decode_array(data, precision="fast", device="cpu")
    assert y.shape == quad.shape and fs == 16000
    err = quad - y
    snr = 10 * np.log10((quad ** 2).sum() / (err ** 2).sum())
    assert snr > 5.0, f"quad {mode} SNR {snr:.1f} dB"
    for ch in range(4):
        e = quad[:, ch] - y[:, ch]
        snr_ch = 10 * np.log10((quad[:, ch] ** 2).sum() / (e ** 2).sum())
        assert snr_ch > 3.0, f"ch {ch} SNR {snr_ch:.1f} dB"
