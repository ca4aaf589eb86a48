"""PyTorch port vs tac: mid/side streams cross-decode. tac decodes the
port's M/S VBR stream, and the port decodes tac's fixed-rate M/S fast
stream, each to what the stream's own package decodes."""

import os
import sys

import numpy as np
import pytest
import torch

from tac import api as japi
from tac.config import PRESETS as JPRESETS
from tac_torch import api as tapi
from tac_torch import bitstream as tbs
from tac_torch.config import PRESETS as TPRESETS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def clip44():
    """The golden suite's 0.5 s stereo multi-sine (22 frames a channel)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden

    return golden.clips()["stereo44"][0]


def _snr(x, y):
    return 10 * np.log10(np.mean(x ** 2) / max(np.mean((x - y) ** 2), 1e-30))


def test_tac_decodes_port_ms_vbr_stream(clip44):
    """The port's vbr-ms fast stream carries the M/S flag and decodes in
    tac to the port's own decode (f32 IMDCT: within 1e-5)."""
    data = tapi.encode_array(clip44, TPRESETS["vbr-ms"], device="cpu")
    hdr = tbs.read_header(data)[0]
    assert hdr.ms and hdr.huffman
    y_pp = tapi.decode_array(data, "fast", device="cpu")[0]
    y_tp = japi.decode_array(data, precision="fast")[0]
    assert y_pp.shape == clip44.shape and _snr(clip44, y_pp) > 10.0
    np.testing.assert_allclose(y_tp, y_pp, rtol=0, atol=1e-5)


def test_port_decodes_tac_ms_fast_stream(clip44):
    """tac's stereo44-128-ms fast stream decodes in the port (its W32 sized
    from the doubled M/S capacity) to tac's own decode, within 1e-5."""
    data = japi.encode_array(clip44, JPRESETS["stereo44-128-ms"])
    y_tt = japi.decode_array(data, precision="fast")[0]
    y_pt = tapi.decode_array(data, "fast", device="cpu")[0]
    assert y_pt.shape == clip44.shape and _snr(clip44, y_pt) > 10.0
    np.testing.assert_allclose(y_pt, y_tt, rtol=0, atol=1e-5)
