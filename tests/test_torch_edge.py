"""PyTorch port vs tac on tac's edge material (tests/test_edge_cases.py,
tests/test_e2e.py), on the CPU:

- DC and Nyquist in parity: every MDCT line of the material is zero in
  exact arithmetic but one, so the stream codes the sign of the f64 FFT's
  rounding noise; the port's bytes equal tac's (``tac.api`` and its
  oracle, whose bytes tac's parity tests hold equal) under ``mono16-64``
  and, at 16 kHz mono on 8 192 samples, under ``vbr-huffman`` and
  ``vbr-bs``;
- clip lengths that do not divide the hop (1, 511, 512, 513, 10 000),
  silence and full scale, and the 8 kbps and 512 kbps edge bitrates: parity
  bytes equal the oracle's, and the decodes pass tac's own checks;
- malformed streams and invalid configs raise as tac's do.
"""

import struct

import numpy as np
import pytest
import torch

from tac import api as japi
from tac.config import PRESETS as JPRESETS
from tac.oracle import encode_array as oracle_encode
from tac_torch import api, bitstream
from tac_torch.bitstream import CorruptStreamError
from tac_torch.config import PRESETS, CodecConfig

FS = 16000


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _parity_pair(preset: str, **change):
    """(tac's config, the port's) of one preset in parity precision."""
    return (JPRESETS[preset].replace(precision="parity", **change),
            PRESETS[preset].replace(precision="parity", **change))


def _snr(x, y):
    return 10 * np.log10(np.mean(x ** 2) / max(np.mean((x - y) ** 2), 1e-30))


def _dc_or_nyquist(material: str, n: int) -> np.ndarray:
    """tests/test_edge_cases.py::test_dc_and_nyquist_survive's material."""
    if material == "dc":
        return np.full((n, 1), 0.25)
    return (0.25 * np.cos(np.pi * np.arange(n)))[:, None]


MONO16 = dict(sample_rate=FS, n_channels=1)


@pytest.mark.parametrize("material", ["dc", "nyquist"])
@pytest.mark.parametrize("preset,n,change", [
    ("mono16-64", 4096, {}),
    ("vbr-huffman", 8192, MONO16),
    ("vbr-bs", 8192, MONO16),
])
def test_dc_and_nyquist_parity_bytes_equal_tacs(preset, n, change, material):
    """Parity on lines that are zero in exact arithmetic: the port's
    forward FFT is numpy's, as tac's CPU XLA and the oracle's are, so the
    coded signs of the rounding noise, and with them the bytes, are
    tac's."""
    x = _dc_or_nyquist(material, n)
    jcfg, tcfg = _parity_pair(preset, **change)
    got = api.encode_array(x, tcfg, device="cpu")
    assert got == oracle_encode(x, jcfg)
    y, fs = api.decode_array(got, device="cpu")
    assert fs == tcfg.sample_rate and y.shape == x.shape
    assert np.isfinite(y).all()


def test_dc_and_nyquist_parity_bytes_equal_tac_api():
    """The same material under ``mono16-64`` against ``tac.api`` itself."""
    jcfg, tcfg = _parity_pair("mono16-64")
    for material in ("dc", "nyquist"):
        x = _dc_or_nyquist(material, 4096)
        assert api.encode_array(x, tcfg, device="cpu") == \
            japi.encode_array(x, jcfg), material


@pytest.mark.parametrize("t_len", [1, 511, 512, 513, 10000])
def test_odd_length_and_mono(t_len):
    """tests/test_e2e.py::test_odd_length_and_mono in parity: lengths that
    do not divide the hop, mono; bytes equal the oracle's."""
    x = (0.3 * np.sin(2 * np.pi * 300 * np.arange(t_len) / FS))[:, None]
    jcfg, tcfg = _parity_pair("mono16-64")
    data = api.encode_array(x, tcfg, device="cpu")
    assert data == oracle_encode(x, jcfg)
    y, fs = api.decode_array(data, device="cpu")
    assert fs == FS and y.shape == (t_len, 1)
    if t_len > 1024:
        assert _snr(x[:, 0], y[:, 0]) > 10


@pytest.mark.parametrize("material", ["silence", "full_scale"])
def test_silence_and_full_scale(material):
    """tests/test_e2e.py::test_silence_and_fullscale in parity: bytes equal
    the oracle's; silence decodes to (near) zero, full scale within the
    MDCT's ringing and above 10 dB."""
    n = np.arange(4096)
    x = (np.zeros(4096) if material == "silence"
         else 0.999 * np.sin(2 * np.pi * 440 * n / FS))[:, None]
    jcfg, tcfg = _parity_pair("mono16-64")
    data = api.encode_array(x, tcfg, device="cpu")
    assert data == oracle_encode(x, jcfg)
    y = api.decode_array(data, device="cpu")[0]
    if material == "silence":
        assert np.max(np.abs(y)) < 1e-6
    else:
        assert np.max(np.abs(y)) < 1.5
        assert _snr(x[:, 0], y[:, 0]) > 10


@pytest.mark.parametrize("bitrate", [8_000, 512_000])
def test_edge_bitrates(bitrate):
    """tests/test_edge_cases.py's bit-starved (8 kbps) and high (512 kbps)
    rates in parity: bytes equal the oracle's; the starved stream decodes
    to finite audio, the rich one above 55 dB."""
    n = 4096 if bitrate == 8_000 else 8192
    amp = 0.3 if bitrate == 8_000 else 0.5
    x = (amp * np.sin(2 * np.pi * 440 * np.arange(n) / FS))[:, None]
    jcfg, tcfg = _parity_pair("mono16-64", bitrate_bps=bitrate)
    data = api.encode_array(x, tcfg, device="cpu")
    assert data == oracle_encode(x, jcfg)
    y = api.decode_array(data, device="cpu")[0]
    assert y.shape == (n, 1) and np.isfinite(y).all()
    if bitrate == 512_000:
        assert _snr(x[:, 0], y[:, 0]) > 55


def _mono_stream() -> bytes:
    x = 0.3 * np.sin(2 * np.pi * 440 * np.arange(4000) / FS)
    return api.encode_array(x, PRESETS["mono16-64"], device="cpu")


def test_bad_magic_rejected():
    with pytest.raises(ValueError, match="magic"):
        bitstream.read_header(b"NOPE" + b"\x00" * 64)


def test_bad_version_rejected():
    data = bytearray(_mono_stream())
    struct.pack_into("<H", data, 4, 99)          # corrupt version
    with pytest.raises(ValueError, match="version"):
        bitstream.read_header(bytes(data))


def test_inflated_length_prefix_rejected():
    """A u16 block length past the header-implied capacity raises a
    corrupt-stream error."""
    data = bytearray(_mono_stream())
    _, off = bitstream.read_header(bytes(data))
    struct.pack_into("<H", data, off, 0xFFF0)    # inflate first block length
    with pytest.raises(CorruptStreamError):
        api.decode_array(bytes(data), device="cpu")


def test_truncated_stream_rejected():
    data = _mono_stream()
    with pytest.raises(CorruptStreamError):
        api.decode_array(data[: len(data) - len(data) // 4], device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(n_mdct_lines=1000), "power of two"),
    (dict(window="boxcar"), "window"),
    (dict(use_block_switch=True, n_mdct_lines=256, n_mdct_lines_short=96),
     "divide"),
])
def test_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        CodecConfig(**kw)
    # the huffman x block-switch combo is legal (SPEC.md §8)
    CodecConfig(use_block_switch=True, use_huffman=True,
                n_mdct_lines=256, n_mdct_lines_short=64)
