"""The port's WAV I/O (tac_torch/io/wav.py) against tac's (tac/io/wav.py):
every sample format the reader takes, the RIFF walk's odd-chunk padding,
the error files, and the 16-bit writer's bytes for float and int16 input."""

import struct

import numpy as np
import pytest

from tac.io import wav as jwav
from tac_torch.io import wav as twav

FS = 16000


def _chunk(cid: bytes, body: bytes) -> bytes:
    return cid + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _fmt(tag: int, ch: int, bits: int) -> bytes:
    return _chunk(b"fmt ", struct.pack("<HHIIHH", tag, ch, FS,
                                       FS * ch * bits // 8, ch * bits // 8,
                                       bits))


def _riff(*chunks: bytes) -> bytes:
    body = b"WAVE" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _pcm(ch: int, bits: int, float_: bool = False) -> bytes:
    """0.25 s of seeded noise in [-0.99, 0.99], ch channels interleaved."""
    x = np.clip(0.5 * np.random.default_rng(bits + ch).standard_normal(
        (FS // 4, ch)), -0.99, 0.99)
    if float_:
        return x.astype("<f4").tobytes()
    if bits == 24:
        v = np.round(x * 8388608.0).astype("<i4").view(np.uint8)
        return v.reshape(-1, 4)[:, :3].tobytes()
    return np.round(x * 2.0 ** (bits - 1)).astype(f"<i{bits // 8}").tobytes()


CASES = {
    "i16_mono": lambda: _riff(_fmt(1, 1, 16), _chunk(b"data", _pcm(1, 16))),
    "i16_stereo": lambda: _riff(_fmt(1, 2, 16), _chunk(b"data", _pcm(2, 16))),
    "i24_stereo": lambda: _riff(_fmt(1, 2, 24), _chunk(b"data", _pcm(2, 24))),
    "i32_mono": lambda: _riff(_fmt(1, 1, 32), _chunk(b"data", _pcm(1, 32))),
    "f32_stereo": lambda: _riff(_fmt(3, 2, 32),
                                _chunk(b"data", _pcm(2, 32, True))),
    "extensible_i24": lambda: _riff(_fmt(0xFFFE, 1, 24),
                                    _chunk(b"data", _pcm(1, 24))),
    # an odd-sized chunk before the data: the walk skips its pad byte
    "odd_extra_chunk": lambda: _riff(_fmt(1, 2, 16), _chunk(b"LIST", b"abc"),
                                     _chunk(b"data", _pcm(2, 16))),
    # a data chunk that does not end on a whole frame: the tail is dropped
    "torn_frame": lambda: _riff(_fmt(1, 2, 16),
                                _chunk(b"data", _pcm(2, 16)[:-2])),
    "not_riff": lambda: b"not a wav file at all",
    "no_data_chunk": lambda: _riff(_fmt(1, 1, 16)),
    "unsupported_u8": lambda: _riff(_fmt(1, 1, 8), _chunk(b"data", b"\x80" * 64)),
    "unsupported_f64": lambda: _riff(_fmt(3, 1, 64), _chunk(b"data", b"\0" * 64)),
}


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:                  # compared by type below
        return type(e)


@pytest.mark.parametrize("case", list(CASES))
def test_wav_equals_tac(case, tmp_path):
    """read_wav gives tac's float64 [T, C] and rate exactly, or raises the
    exception type tac raises; write_wav of what was read, as float and as
    int16 (the device pcm16 decode's output), writes tac's bytes."""
    src = tmp_path / "in.wav"
    src.write_bytes(CASES[case]())
    want = _outcome(jwav.read_wav, str(src))
    got = _outcome(twav.read_wav, str(src))
    if isinstance(want, type):
        assert got is want and issubclass(got, ValueError), (got, want)
        return
    (x, fs), (y, fs2) = want, got
    assert fs2 == fs == FS and y.dtype == np.float64
    np.testing.assert_array_equal(y, x)
    pcm16 = np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)
    for i, data in enumerate((y, pcm16, y[:, 0])):
        a, b = tmp_path / f"tac{i}.wav", tmp_path / f"port{i}.wav"
        jwav.write_wav(str(a), data, fs)
        twav.write_wav(str(b), data, fs)
        assert b.read_bytes() == a.read_bytes(), i
    assert twav.read_wav(str(tmp_path / "port1.wav"))[0].shape == y.shape
