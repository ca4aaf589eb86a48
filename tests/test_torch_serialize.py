"""The port's FrameCode host (de)serializers and entries (tac_torch/api.py
frames_to_payload[_vbr] / payload_to_frames[_vbr], blockswitch
payload_to_frames_bs, codec.encode_clip / decode_clip, blockswitch
encode_clip_bs / decode_clip_bs, parallel.encode_batch) against tac's:
the bytes of a FrameCode tac encoded, tac's parse of the same bytes, and
tests/test_fuzz.py's host-deserializer mutants, which may raise only
CorruptStreamError or ValueError. Streams are the port's own CPU encodes;
tac encodes three times (encode_clip, encode_clip_vbr, encode_clip_bs), in
parity."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tac import api as japi
from tac import blockswitch as jbs
from tac import codec as jc
from tac.config import PRESETS as JPRESETS
from tac_torch import api as tapi
from tac_torch import blockswitch as tb
from tac_torch import bitstream as tbs
from tac_torch import codec as tc
from tac_torch import parallel as tpar
from tac_torch.config import PRESETS as TPRESETS
from tac_torch.dsp.mdct import num_frames

ALLOWED = (tbs.CorruptStreamError, ValueError)
FS = 16000
# tests/test_fuzz.py's families; "vbr-sets" is the parity Huffman config of
# the tac-encoded FrameCode (uniform allocation: tableIds 0, 1 and 3)
FAMILIES = {
    "raw": dict(),
    "vbr": dict(use_huffman=True, precision="fast", use_psy=True,
                alloc_mode="greedy"),
    "bs": dict(use_block_switch=True, n_mdct_lines_short=128,
               precision="fast"),
    "combo": dict(use_block_switch=True, use_huffman=True,
                  n_mdct_lines_short=128, precision="fast"),
    "ms": dict(n_channels=2, stereo_mode="ms", precision="fast",
               use_psy=True, alloc_mode="greedy"),
    "ms-combo": dict(n_channels=2, stereo_mode="ms", use_block_switch=True,
                     use_huffman=True, n_mdct_lines_short=128,
                     precision="fast", use_psy=True, alloc_mode="greedy"),
}
VBR_SETS = dict(use_huffman=True, huffman_sets=3)


def _cfgs(change):
    return (TPRESETS["mono16-64"].replace(**change),
            JPRESETS["mono16-64"].replace(**change))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sig():
    """tests/test_fuzz.py's material: 0.35 s at 16 kHz with a ramp
    transient, and its stereo form."""
    t = np.arange(int(FS * 0.35)) / FS
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
    x[2000:2100] += np.linspace(0, 0.4, 100)
    return x, np.stack([x, np.roll(x, 37) * 0.8], axis=1)


@pytest.fixture(scope="module")
def streams(sig):
    out = {}
    for name, change in FAMILIES.items():
        tcfg, _ = _cfgs(change)
        data = tapi.encode_array(sig[tcfg.n_channels - 1], tcfg, device="cpu")
        out[name] = (data, tbs.read_header(data)[1])
    return out


def _leaves_np(code):
    return [np.asarray(v) for v in code]


@pytest.mark.parametrize("family", ["raw", "vbr"])
def test_frames_to_payload_equals_tac(sig, family):
    """A FrameCode tac encoded in parity (encode_clip; encode_clip_vbr with
    its tableIds) serializes to tac's bytes in the port, and those bytes
    are the payload of the port's own parity stream; the port's
    encode_clip gives tac's FrameCode (raw), and its decode_clip of that
    code the port's decode_array of the stream."""
    x = sig[0]
    tcfg, jcfg = _cfgs({} if family == "raw" else VBR_SETS)
    h = tcfg.n_mdct_lines
    if family == "raw":
        code = jc.encode_clip(jnp.asarray(x[None, :]), jcfg)
        want = japi.frames_to_payload(code, jcfg, h, None)
        got = tapi.frames_to_payload(code, tcfg, h)
    else:
        vbr = jc.encode_clip_vbr(jnp.asarray(x[None, :]), jcfg)
        assert set(np.unique(np.asarray(vbr.table_id))) == {0, 1, 3}
        want = japi.frames_to_payload_vbr(vbr, jcfg, h, None)
        code = vbr.code
        got = tapi.frames_to_payload_vbr(code, vbr.table_id, tcfg, h)
    assert got == want
    data = tapi.encode_array(x, tcfg, device="cpu")
    assert data.endswith(got) and len(data) - len(got) == \
        tbs.read_header(data)[1]
    if family == "raw":
        mine = tc.encode_clip(x[None, :], tcfg, device="cpu")
        for g, w in zip(mine, code):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        y = tc.decode_clip(mine, tcfg, len(x), device="cpu")
        np.testing.assert_array_equal(
            y.numpy().T.astype(np.float32),
            tapi.decode_array(data, device="cpu")[0])


@pytest.mark.parametrize("family", ["raw", "vbr", "bs", "ms"])
def test_payload_to_frames_equals_tac(streams, family):
    """The port's host parse of a stream gives tac's parse of the same
    bytes, leaf for leaf, and, decoded by the FrameCode entries, the
    stream's decode_array (fast: within 1e-6)."""
    data, off = streams[family]
    tcfg, jcfg = _cfgs(FAMILIES[family])
    hdr = tbs.read_header(data)[0]
    f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
    h = hdr.n_mdct_lines
    if tcfg.use_block_switch:
        got = tb.payload_to_frames_bs(data, off, f, tcfg, device="cpu")
        want = jbs.payload_to_frames_bs(data, off, f, jcfg)
        pairs = zip([got.state, *got.long, *got.short],
                    [want.state, *want.long, *want.short])
    elif tcfg.use_huffman:
        got = tapi.payload_to_frames_vbr(data, off, f, tcfg, h, device="cpu")
        want = japi.payload_to_frames_vbr(data, off, f, jcfg, h)
        pairs = zip(got, want)
    else:
        got = tapi.payload_to_frames(data, off, f, tcfg, h, device="cpu")
        want = japi.payload_to_frames(data, off, f, jcfg, h)
        pairs = zip(got, want)
    for g, w in pairs:
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if tcfg.stereo_mode == "ms":
        return          # the FrameCode entries are L/R, as tac's
    dcfg = tapi.header_config(hdr, "fast")
    dec = tb.decode_clip_bs if tcfg.use_block_switch else tc.decode_clip
    y = dec(got, dcfg, hdr.num_samples, device="cpu").numpy().T
    np.testing.assert_allclose(
        y, tapi.decode_array(data, "fast", device="cpu")[0], rtol=0,
        atol=1e-6)


def _burst(x):
    """x with a decaying noise burst added: SHORT frames."""
    x = x.copy()
    k = np.arange(400)
    x[3000:3400] += 0.6 * np.exp(-k / 60.0) * np.random.default_rng(
        9).standard_normal(400)
    return x


def test_encode_clip_bs_selected_code_is_the_streams(sig):
    """encode_clip_bs's state-selected encoding is what the block-switch
    stream carries (its host parse), with SHORT frames present (a noise
    burst added to the material)."""
    tcfg, _ = _cfgs(FAMILIES["bs"])
    x = _burst(sig[0])
    bc = tb.encode_clip_bs(x[None, :], tcfg, device="cpu")
    data = tapi.encode_array(x, tcfg, device="cpu")
    off = tbs.read_header(data)[1]
    parsed = tb.payload_to_frames_bs(data, off, bc.state.shape[-1], tcfg,
                                     device="cpu")
    assert (bc.state == tb.SHORT).any()
    assert torch.equal(bc.state, parsed.state)
    code, _ = tb.select_code_bs(bc, tb.make_bs_consts(tcfg, torch.device(
        "cpu")))
    for g, w in zip(code, parsed.long):
        assert torch.equal(g, w)


def test_encode_clip_bs_equals_tac(sig):
    """encode_clip_bs gives tac's BsFrameCode leaf for leaf in parity, both
    encodings of every frame (each allocated on its own, SHORT frames
    present), and decode_clip_bs of that code gives tac's decode_clip_bs
    (within 1e-12)."""
    tcfg, jcfg = _cfgs({**FAMILIES["bs"], "precision": "parity"})
    x = _burst(sig[0])
    bc = tb.encode_clip_bs(x[None, :], tcfg, device="cpu")
    want = jbs.encode_clip_bs(jnp.asarray(x[None, :]), jcfg)
    assert (bc.state == tb.SHORT).any()
    for g, w in zip([bc.state, *bc.long, *bc.short],
                    [want.state, *want.long, *want.short]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    y = tb.decode_clip_bs(bc, tcfg, len(x), device="cpu").numpy()
    np.testing.assert_allclose(
        y, np.asarray(jbs.decode_clip_bs(want, jcfg, len(x))), rtol=0,
        atol=1e-12)


def test_encode_batch_equals_solo(sig):
    """parallel.encode_batch [B, C, T] gives each clip its solo
    encode_clip FrameCode."""
    tcfg, _ = _cfgs({})
    a = sig[0][None, :4000]
    b = 0.5 * sig[0][None, ::-1][:, :4000].copy()
    batch = tpar.encode_batch(np.stack([a, b]), tcfg, device="cpu")
    for i, clip in enumerate((a, b)):
        for g, w in zip(batch, tc.encode_clip(clip, tcfg, device="cpu")):
            assert torch.equal(g[i], w)


def _mutations(data: bytes, off: int, rng):
    """tests/test_fuzz.py:_mutations: 120 payloads with 1-16 bit flips, 50
    truncations inside the payload, 40 random u16 values over a true
    length prefix."""
    n = len(data)
    for _ in range(120):
        buf = bytearray(data)
        for b in rng.integers(off * 8, n * 8, rng.integers(1, 17)):
            buf[b // 8] ^= 1 << (b % 8)
        yield bytes(buf)
    for _ in range(50):
        yield data[:int(rng.integers(off, n))]
    prefixes, pos = [], off
    while pos + 2 <= n:
        prefixes.append(pos)
        pos += 2 + (data[pos] | (data[pos + 1] << 8))
    for _ in range(40):
        buf = bytearray(data)
        p = prefixes[int(rng.integers(0, len(prefixes)))]
        v = int(rng.integers(0, 1 << 16))
        buf[p], buf[p + 1] = v & 0xFF, v >> 8
        yield bytes(buf)


def _parse(api, bsw, mutant, off, f, cfg, h, **kw):
    if cfg.use_block_switch:
        return bsw.payload_to_frames_bs(mutant, off, f, cfg, **kw)
    if cfg.use_huffman:
        return api.payload_to_frames_vbr(mutant, off, f, cfg, h, **kw)
    return api.payload_to_frames(mutant, off, f, cfg, h, **kw)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_host_deserializer_mutants(streams, family):
    """tests/test_fuzz.py::test_fuzz_host_deserializer on the port: every
    third mutant through the family's host parse (tac's dispatch) raises
    CorruptStreamError or ValueError, or parses; tac parses exactly the
    mutants the port parses, to the same integers."""
    data, off = streams[family]
    tcfg, jcfg = _cfgs(FAMILIES[family])
    hdr = tbs.read_header(data)[0]
    f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
    h = hdr.n_mdct_lines
    rng = np.random.default_rng(list(FAMILIES).index(family))
    parsed = 0
    for i, mutant in enumerate(_mutations(data, off, rng)):
        if i % 3:
            continue
        try:
            got = _parse(tapi, tb, mutant, off, f, tcfg, h, device="cpu")
        except ALLOWED:
            with pytest.raises(ALLOWED):
                _parse(japi, jbs, mutant, off, f, jcfg, h)
            continue
        want = _parse(japi, jbs, mutant, off, f, jcfg, h)
        flat = (lambda c: [c.state, *c.long]) if tcfg.use_block_switch \
            else list
        for g, w in zip(flat(got), flat(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        parsed += 1
    # tac's dispatch parses the Huffman combos by the plain block-switch
    # layout, which fails on them: only the other families parse mutants
    assert (parsed > 0) == (not (tcfg.use_block_switch and tcfg.use_huffman))
