"""PyTorch port: sample-accurate random access (tac_torch.api.decode_range,
the counterpart of tac/api.py:decode_range). Decoding only the frames that
cover [start, stop) gives the full decode's samples: exactly in parity
precision, on the port's parity streams of the nine golden configs (every
stream family; their bytes are goldens/streams.json's, held by
tests/test_torch_streaming.py), and within 2e-5 in fast precision; the
indices clamp and an empty range is [0, C]. No JAX call."""

import os
import sys

import numpy as np
import pytest
import torch

from tac_torch import api as tapi
from tac_torch.config import PRESETS as TPRESETS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tools/golden.py:cases(), on the port's presets
GOLDEN = {
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


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def material():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden

    return golden.clips()


def _ranges(n: int, h: int, seed: int = 7):
    """tests/test_seek.py's ranges: the whole clip, the first and the last
    sample, aligned, interior, and four seeded random ones."""
    rng = np.random.default_rng(seed)
    out = [(0, n), (0, 1), (n - 1, n), (h, 3 * h),
           (h - 1, h + 1), (5 * h + 17, 7 * h - 3)]
    return out + [tuple(int(v) for v in sorted(rng.integers(0, n, 2)))
                  for _ in range(4)]


@pytest.mark.parametrize("name", list(GOLDEN))
def test_decode_range_parity_exact(name, material):
    preset, change, clip = GOLDEN[name]
    x, fs = material[clip]
    cfg = TPRESETS[preset].replace(precision="parity", sample_rate=fs, **change)
    data = tapi.encode_array(x, cfg, device="cpu")
    full, fs2 = tapi.decode_array(data, device="cpu")
    n = full.shape[0]
    for s0, s1 in _ranges(n, cfg.n_mdct_lines):
        got, fs3 = tapi.decode_range(data, s0, s1, precision="parity",
                                     device="cpu")
        assert fs3 == fs2 == fs and got.shape == (s1 - s0, full.shape[1])
        assert np.array_equal(got, full[s0:s1]), (name, s0, s1)


def _sig(n_ch, fs=16000, seconds=0.4):
    """tests/test_seek.py's material: two tones, a ramp transient, noise."""
    t = np.arange(int(fs * seconds)) / fs
    s = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1970 * t)
    s[3000:3120] += np.linspace(0, 0.4, 120)
    s = s + 0.01 * np.random.default_rng(1).standard_normal(len(t))
    return s if n_ch == 1 else np.stack([s, 0.8 * np.roll(s, 31)], 1)


H = 256
FAST = {   # tests/test_seek.py's FAMILIES
    "raw": TPRESETS["mono16-64"].replace(n_mdct_lines=H, precision="fast"),
    "vbr": TPRESETS["mono16-64"].replace(n_mdct_lines=H, use_huffman=True,
                                         use_psy=True, alloc_mode="greedy",
                                         precision="fast"),
    "bs": TPRESETS["mono16-64"].replace(n_mdct_lines=H, use_block_switch=True,
                                        n_mdct_lines_short=64,
                                        precision="fast"),
    "ms-combo": TPRESETS["mono16-64"].replace(
        n_mdct_lines=H, n_channels=2, stereo_mode="ms", use_block_switch=True,
        use_huffman=True, n_mdct_lines_short=64, use_psy=True,
        alloc_mode="greedy", precision="fast"),
}


@pytest.mark.parametrize("family", list(FAST))
def test_decode_range_fast_within_tolerance(family):
    cfg = FAST[family]
    data = tapi.encode_array(_sig(cfg.n_channels), cfg, device="cpu")
    full, _ = tapi.decode_array(data, precision="fast", device="cpu")
    for s0, s1 in _ranges(full.shape[0], H):
        got, _ = tapi.decode_range(data, s0, s1, device="cpu")
        assert got.shape == (s1 - s0, full.shape[1])
        np.testing.assert_allclose(got, full[s0:s1], atol=2e-5,
                                   err_msg=f"{family} range {s0}:{s1}")


def test_decode_range_edges():
    """Empty ranges give [0, C]; indices clamp to [0, num_samples]; a stop
    past the end is cut at the last sample."""
    cfg = FAST["raw"]
    data = tapi.encode_array(_sig(1), cfg, device="cpu")
    full, _ = tapi.decode_array(data, precision="fast", device="cpu")
    n = full.shape[0]
    for s0, s1 in ((0, 0), (500, 400), (n + 5, n + 50), (-30, -2)):
        got, fs = tapi.decode_range(data, s0, s1, device="cpu")
        assert got.shape == (0, 1) and got.dtype == np.float32 and fs == 16000
    got, _ = tapi.decode_range(data, -50, n + 999, device="cpu")
    np.testing.assert_allclose(got, full, atol=2e-5)
    got, _ = tapi.decode_range(data, n - 3, n + 10, device="cpu")
    np.testing.assert_allclose(got, full[n - 3:], atol=2e-5)
    assert got.shape == (3, 1)


def test_decode_range_needs_a_card_unless_told(monkeypatch):
    data = tapi.encode_array(_sig(1)[:2000], FAST["raw"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.decode_range(data, 0, 100)
