"""PyTorch port vs tac: streaming encode and decode (tac_torch/streaming.py,
the counterpart of tac/streaming.py). The references are tac's own golden
digests (goldens/streams.json), so the family-wide checks make no JAX
call: the port's StreamEncoder under seeded random pushes, and across a
mid-stream StreamState resume, hashes to the golden of each of the nine
configs; StreamState's bytes are tac's, both ways; one tac encoder's state
resumes in the port; the StreamDecoder equals the offline decode (exactly
in parity) under random byte pieces, keeps one half-block of delay and
refuses an oversize block; chunked fast VBR keeps tac's rate and quality
contract; and the entry points need a card unless told."""

import hashlib
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from tac_torch import api as tapi
from tac_torch import bitstream as tbs
from tac_torch.config import PRESETS as TPRESETS
from tac_torch.dsp.mdct import num_frames
from tac_torch.streaming import StreamDecoder, StreamEncoder, StreamState

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
# the families that carry state beyond the overlap half: the reservoir, the
# flag history and lookahead, both, and both per M/S pair
STATEFUL = ["config3_vbr_huffman", "config5_blockswitch",
            "config6_vbr_blockswitch", "config10_ms_vbr_blockswitch"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def material():
    """tools/golden.py's clips (numpy only) and its digests."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden

    with open(golden.GOLDEN_PATH) as f:
        return golden.clips(), json.load(f)


def _case(name, material):
    preset, change, clip = GOLDEN[name]
    x, fs = material[0][clip]
    cfg = TPRESETS[preset].replace(precision="parity", sample_rate=fs, **change)
    return x, cfg


def _digest(data: bytes) -> dict:
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}


def _push_random(enc, x, rng, lo=1, hi=700):
    out, i = [], 0
    while i < len(x):
        n = int(rng.integers(lo, hi))
        out.append(enc.push(x[i:i + n]))
        i += n
    return b"".join(out)


def _feed(dec, data, off, rng, hi=1500):
    outs, pos = [], off
    while pos < len(data):
        step = int(rng.integers(1, hi))
        outs.append(dec.push(data[pos:pos + step]))
        pos += step
    return np.concatenate(outs, 0)


@pytest.fixture(scope="module")
def chunked(material):
    """name → the port's parity stream of that golden clip, pushed in
    pushes of 1-699 samples from a seeded generator (made once a module)."""
    made = {}

    def stream(name):
        if name not in made:
            x, cfg = _case(name, material)
            enc = StreamEncoder(cfg, n_channels=x.shape[1], device="cpu")
            made[name] = (enc.header(len(x)) + _push_random(
                enc, x, np.random.default_rng(5)) + enc.flush())
        return made[name]
    return stream


@pytest.mark.parametrize("name", list(GOLDEN))
def test_stream_chunked_matches_golden(name, material, chunked):
    """Parity precision, pushes of 1-699 samples from a seeded generator:
    header + pushes + flush hashes to the golden of the offline stream."""
    assert _digest(chunked(name)) == material[1][name]


@pytest.mark.parametrize("name", STATEFUL)
def test_checkpoint_resume_matches_golden(name, material):
    """A StreamState serialized mid-stream (mid-half, with pending samples)
    resumes in a new encoder to the golden bytes."""
    x, cfg = _case(name, material)
    cut = len(x) // 2 + 123
    enc = StreamEncoder(cfg, n_channels=x.shape[1], device="cpu")
    part1 = enc.header(len(x)) + enc.push(x[:cut])
    blob = enc.state.to_bytes()
    enc2 = StreamEncoder(cfg, n_channels=x.shape[1], device="cpu")
    enc2.state = StreamState.from_bytes(blob)
    assert enc2.state.pending.shape[1] == cut % cfg.n_mdct_lines
    part2 = enc2.push(x[cut:]) + enc2.flush()
    assert _digest(part1 + part2) == material[1][name]


def _state_fields(rng, c=2, h=8, lanes=1, pending=3):
    return dict(prior=rng.standard_normal((c, h)),
                look=rng.standard_normal((c, h)),
                pending=rng.standard_normal((c, pending)),
                reservoir=rng.integers(0, 5000, lanes).astype(np.int64),
                t_hist=rng.random((lanes, 2)) < 0.5, blocks_out=17,
                primed=True)


@pytest.mark.parametrize("lanes,pending", [(1, 3), (2, 0)])
def test_state_bytes_equal_tac(lanes, pending):
    """The same fields serialize to the same bytes in tac and in the port,
    and each package's from_bytes reads the other's blob field for field
    (dtypes included)."""
    from tac.streaming import StreamState as JState

    f = _state_fields(np.random.default_rng(lanes), lanes=lanes,
                      pending=pending)
    ours, theirs = StreamState(**f).to_bytes(), JState(**f).to_bytes()
    assert ours == theirs
    for got in (StreamState.from_bytes(theirs), JState.from_bytes(ours)):
        for k_, v in f.items():
            g = getattr(got, k_)
            if isinstance(v, np.ndarray):
                assert g.dtype == v.dtype and np.array_equal(g, v), k_
            else:
                assert g == v, k_


def test_tac_state_resumes_in_the_port():
    """tac's StreamEncoder codes the first part of a short streaming-ll
    clip in parity and writes its state; the port resumes from that blob
    and flushes. The joined bytes equal the port's offline encode_array.
    (The file's one JAX encode: H = 256, 0.3 s of audio.)"""
    from tac.config import PRESETS as JPRESETS
    from tac.streaming import StreamEncoder as JEncoder

    fs = 44100
    t = np.arange(int(0.3 * fs)) / fs
    x = 0.3 * np.sin(2 * np.pi * 440 * t)
    x[6000:6400] += 0.5 * np.exp(-np.arange(400) / 80.0) * np.sin(
        2 * np.pi * 2800 * np.arange(400) / fs)
    cut = 5000 + 77
    jenc = JEncoder(JPRESETS["streaming-ll"].replace(precision="parity"),
                    n_channels=1)
    part1 = jenc.header(len(x)) + jenc.push(x[:cut])
    cfg = TPRESETS["streaming-ll"].replace(precision="parity")
    enc = StreamEncoder(cfg, n_channels=1, device="cpu")
    enc.state = StreamState.from_bytes(jenc.state.to_bytes())
    assert enc.state.primed and enc.state.t_hist.dtype == bool
    part2 = enc.push(x[cut:]) + enc.flush()
    assert part1 + part2 == tapi.encode_array(x, cfg, device="cpu")


@pytest.mark.parametrize("name", ["config2_stereo44_128",
                                  "config3_vbr_huffman",
                                  "config6_vbr_blockswitch",
                                  "config9_ms_blockswitch",
                                  "config10_ms_vbr_blockswitch"])
def test_stream_decoder_parity_equals_decode_array(name, chunked):
    """Parity precision, random byte pieces: the StreamDecoder's output is
    exactly decode_array's, with the header's sample count."""
    data = chunked(name)
    want = tapi.decode_array(data, device="cpu")[0]
    dec, off = StreamDecoder.from_header(data, precision="parity",
                                         device="cpu")
    got = _feed(dec, data, off, np.random.default_rng(3), hi=3000)
    assert got.shape == want.shape and np.array_equal(got, want)


def _clip(seconds=0.5, fs=44100, stereo=False):
    """tests/test_streaming.py's clip: a tone with one burst, plus a little
    noise (card-vs-CPU material needs some)."""
    t = np.arange(int(fs * seconds)) / fs
    x = 0.3 * np.sin(2 * np.pi * 440 * t)
    x[len(t) // 2:len(t) // 2 + 500] += 0.5 * np.exp(
        -np.arange(500) / 80.0) * np.sin(2 * np.pi * 2800 * np.arange(500) / fs)
    x += 0.002 * np.random.default_rng(11).standard_normal(len(t))
    return np.stack([x, 0.7 * x], axis=1) if stereo else x


@pytest.mark.parametrize("preset", ["vbr-huffman", "streaming-ll"])
def test_stream_decoder_fast_within_tolerance(preset):
    """Fast precision: the StreamDecoder under random byte pieces agrees
    with decode_array within 2e-5 (f32 matmuls of other batch shapes)."""
    x = _clip(0.3)
    cfg = TPRESETS[preset].replace(n_channels=1)
    data = tapi.encode_array(x, cfg, device="cpu")
    want, _ = tapi.decode_array(data, precision="fast", device="cpu")
    dec, off = StreamDecoder.from_header(data, device="cpu")
    got = _feed(dec, data, off, np.random.default_rng(4))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_stream_decoder_latency_one_half_block():
    """Frame i's blocks finish exactly samples [(i-1)·H, i·H): after k
    whole frames the decoder has emitted (k-1)·H samples, never more."""
    x = _clip(0.1)
    cfg = TPRESETS["streaming-ll"].replace(n_channels=1)
    h = cfg.n_mdct_lines
    data = tapi.encode_array(x, cfg, device="cpu")
    hdr, off = tbs.read_header(data)
    dec, _ = StreamDecoder.from_header(data, device="cpu")
    offs, lens = tbs.split_blocks(data, off, num_frames(hdr.num_samples, h))
    got = 0
    for i in range(6):
        got += dec.push(data[offs[i] - 2: offs[i] + lens[i]]).shape[0]
        assert got == min(i * h, hdr.num_samples), (i, got)


def test_stream_decoder_rejects_oversize_block():
    """A length prefix over the frame's capacity raises CorruptStreamError,
    not a decode of garbage."""
    cfg = TPRESETS["stereo44-128"].replace(n_channels=1)
    data = tapi.encode_array(np.zeros(3000), cfg, device="cpu")
    dec, _ = StreamDecoder.from_header(data, device="cpu")
    with pytest.raises(tbs.CorruptStreamError):
        dec.push(struct.pack("<H", 0xFFF0) + b"\x00" * 0xFFF0)


def test_chunked_fast_mode_contract():
    """Fast precision, stereo VBR in 3 000-sample pushes: the stream may
    differ from the offline one at grid ties, but its size is within 0.1 %
    and its decode within 40 dB of the offline decode
    (tests/test_streaming.py::test_chunked_fast_mode_contract)."""
    x2 = _clip(0.5, stereo=True)
    cfg = TPRESETS["vbr-huffman"]
    offline = tapi.encode_array(x2, cfg, device="cpu")
    enc = StreamEncoder(cfg, n_channels=2, device="cpu")
    out = [enc.header(len(x2))]
    for i in range(0, len(x2), 3000):
        out.append(enc.push(x2[i:i + 3000]))
    stream = b"".join(out) + enc.flush()
    assert abs(len(stream) - len(offline)) <= max(4, len(offline) // 1000)
    ys, _ = tapi.decode_array(stream, precision="fast", device="cpu")
    yo, _ = tapi.decode_array(offline, precision="fast", device="cpu")
    err = ys - yo
    snr = 10 * np.log10(np.sum(yo ** 2) / max(np.sum(err ** 2), 1e-30))
    assert snr >= 40.0, snr


def test_stream_entry_points_need_a_card_unless_told(monkeypatch):
    """Without a card, StreamEncoder and StreamDecoder raise unless the
    caller passes device="cpu": no silent fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TPRESETS["vbr-bs"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamEncoder(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamDecoder(cfg)
    data = StreamEncoder(cfg, device="cpu").header(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamDecoder.from_header(data)
