"""RIFF/WAVE PCM I/O (counterpart of tac/io/wav.py, numpy only).

The whole clip is read into a [T, C] float array in one vectorized step.
Reads 16/24/32-bit integer and 32-bit float PCM (format 1, 3 or
WAVE_FORMAT_EXTENSIBLE); writes 16-bit PCM.
"""

from __future__ import annotations

import struct
import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float64[T, C] in [-1, 1), sample_rate). Raises
    ValueError on a file that is not RIFF/WAVE, one without a fmt or data
    chunk, and an unsupported sample format."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    off = 12
    fmt = None
    pcm = None
    while off + 8 <= len(data):
        cid, size = data[off:off + 4], struct.unpack_from("<I", data, off + 4)[0]
        body = data[off + 8:off + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif cid == b"data":
            pcm = body
        off += 8 + size + (size & 1)        # chunks are padded to even size
    if fmt is None or pcm is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, n_ch, fs, _, _, bits = fmt
    if audio_fmt == 3 and bits == 32:
        x = np.frombuffer(pcm, "<f4").astype(np.float64)
    elif audio_fmt in (1, 0xFFFE) and bits == 16:
        x = np.frombuffer(pcm, "<i2").astype(np.float64) / 32768.0
    elif audio_fmt in (1, 0xFFFE) and bits == 32:
        x = np.frombuffer(pcm, "<i4").astype(np.float64) / 2147483648.0
    elif audio_fmt in (1, 0xFFFE) and bits == 24:
        raw = np.frombuffer(pcm, np.uint8).reshape(-1, 3)
        x = (raw[:, 0].astype(np.int32)
             | (raw[:, 1].astype(np.int32) << 8)
             | (raw[:, 2].astype(np.int32) << 16))
        x = (x << 8 >> 8).astype(np.float64) / 8388608.0
    else:
        raise ValueError(f"{path}: unsupported format {audio_fmt}/{bits}-bit")
    t = len(x) // n_ch
    return x[:t * n_ch].reshape(t, n_ch), fs


def write_wav(path: str, x: np.ndarray, fs: int) -> None:
    """Write float[T, C] (or [T]) in [-1, 1] as 16-bit WAV, rounding half to
    even and clipping; int16 input (the device-side pcm16 decode's output,
    ``parallel.to_pcm16``) is written as it is."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    if x.dtype == np.int16:
        pcm = x.astype("<i2")
    else:
        pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(x.shape[1])
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())
