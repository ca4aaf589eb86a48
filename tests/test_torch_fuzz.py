"""Corruption fuzz of the port's decode surfaces (tests/test_fuzz.py's
mutation families, on tac_torch): seeded bit flips, truncations and
length-prefix rewrites of valid streams of six families, the port's own
CPU encodes (no JAX call), through api.decode_array, api.decode_range and
StreamDecoder.push. Every case either raises a typed error
(CorruptStreamError or ValueError) or returns finite audio of the right
shape; any other exception fails the test.

Mutants per family and surface, as (bit flips, truncations, length
prefixes), in MUTANTS: tests/test_fuzz.py's 120 / 50 / 40 through
decode_array for the families without Huffman rows, fewer elsewhere, so
that the file runs in about half a minute on one CPU worker (a VBR decode
walks its Huffman rows by K4's plain version, line by line).
"""

import numpy as np
import pytest
import torch

from tac_torch import api as tapi
from tac_torch import bitstream as tbs
from tac_torch.bitstream import CorruptStreamError
from tac_torch.config import PRESETS as TPRESETS
from tac_torch.streaming import StreamDecoder

ALLOWED = (CorruptStreamError, ValueError)
# (bit flips, truncations, length prefixes) by surface: families without
# Huffman rows (raw, bs, ms), then those with them (vbr, combo, ms-combo)
MUTANTS = {"decode_array": ((120, 50, 40), (16, 6, 6)),
           "decode_range": ((30, 10, 10), (8, 3, 3)),
           "stream_decoder": ((30, 10, 10), (8, 3, 3))}

FAMILIES = {   # tests/test_fuzz.py's
    "raw": TPRESETS["mono16-64"],
    "vbr": TPRESETS["mono16-64"].replace(use_huffman=True, precision="fast",
                                         use_psy=True, alloc_mode="greedy"),
    "bs": TPRESETS["mono16-64"].replace(use_block_switch=True,
                                        n_mdct_lines_short=128,
                                        precision="fast"),
    "combo": TPRESETS["mono16-64"].replace(use_block_switch=True,
                                           use_huffman=True,
                                           n_mdct_lines_short=128,
                                           precision="fast"),
    "ms": TPRESETS["mono16-64"].replace(n_channels=2, stereo_mode="ms",
                                        precision="fast", use_psy=True,
                                        alloc_mode="greedy"),
    "ms-combo": TPRESETS["mono16-64"].replace(
        n_channels=2, stereo_mode="ms", use_block_switch=True,
        use_huffman=True, n_mdct_lines_short=128, precision="fast",
        use_psy=True, alloc_mode="greedy"),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def streams():
    """tests/test_fuzz.py's material, 0.35 s at 16 kHz with a ramp
    transient, encoded by the port on the CPU."""
    fs = 16000
    t = np.arange(int(fs * 0.35)) / fs
    sig = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
    sig[2000:2100] += np.linspace(0, 0.4, 100)
    stereo = np.stack([sig, np.roll(sig, 37) * 0.8], axis=1)
    out = {}
    for name, cfg in FAMILIES.items():
        data = tapi.encode_array(stereo if cfg.n_channels == 2 else sig, cfg,
                                 device="cpu")
        out[name] = (data, tbs.read_header(data)[1])
    return out


def mutations(data: bytes, off: int, rng, n_flip: int, n_trunc: int,
              n_prefix: int):
    """tests/test_fuzz.py:_mutations with its counts as arguments: 1-16
    bit flips in the payload, truncations inside it, and random u16 values
    written over a true length prefix."""
    n = len(data)
    for _ in range(n_flip):
        buf = bytearray(data)
        for b in rng.integers(off * 8, n * 8, rng.integers(1, 17)):
            buf[b // 8] ^= 1 << (b % 8)
        yield bytes(buf)
    for _ in range(n_trunc):
        yield data[:int(rng.integers(off, n))]
    prefixes, pos = [], off
    while pos + 2 <= n:
        prefixes.append(pos)
        pos += 2 + (data[pos] | (data[pos + 1] << 8))
    for _ in range(n_prefix):
        buf = bytearray(data)
        p = prefixes[int(rng.integers(0, len(prefixes)))]
        v = int(rng.integers(0, 1 << 16))
        buf[p], buf[p + 1] = v & 0xFF, v >> 8
        yield bytes(buf)


def _decode_array(mutant, rng):
    hdr = tbs.read_header(mutant)[0]
    x, _ = tapi.decode_array(mutant, precision="fast", device="cpu")
    assert x.shape == (hdr.num_samples, hdr.n_channels)
    return x


def _decode_range(mutant, rng):
    hdr = tbs.read_header(mutant)[0]
    s0, s1 = sorted(int(v) for v in
                    rng.integers(-100, hdr.num_samples + 100, 2))
    x, _ = tapi.decode_range(mutant, s0, s1, device="cpu")
    lo = min(max(s0, 0), hdr.num_samples)
    assert x.shape == (max(min(s1, hdr.num_samples), lo) - lo,
                       hdr.n_channels)
    return x


def _stream_decoder(mutant, rng):
    dec, pos = StreamDecoder.from_header(mutant, device="cpu")
    outs = [np.zeros((0, dec.cfg.n_channels), np.float32)]
    while pos < len(mutant):
        n = int(rng.integers(1, 900))
        outs.append(dec.push(mutant[pos:pos + n]))
        assert outs[-1].shape[1] == dec.cfg.n_channels
        pos += n
    x = np.concatenate(outs)
    assert x.shape[0] <= dec.num_samples
    return x


SURFACES = {"decode_array": _decode_array, "decode_range": _decode_range,
            "stream_decoder": _stream_decoder}


@pytest.mark.parametrize("surface", list(SURFACES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_fuzz(streams, family, surface):
    data, off = streams[family]
    rng = np.random.default_rng([list(FAMILIES).index(family),
                                 list(SURFACES).index(surface)])
    counts = MUTANTS[surface][FAMILIES[family].use_huffman]
    outcomes = {"typed_error": 0, "audio": 0}
    for mutant in mutations(data, off, rng, *counts):
        try:
            x = SURFACES[surface](mutant, rng)
        except ALLOWED:
            outcomes["typed_error"] += 1
            continue
        assert np.all(np.isfinite(x))
        outcomes["audio"] += 1
    assert sum(outcomes.values()) == sum(counts)
