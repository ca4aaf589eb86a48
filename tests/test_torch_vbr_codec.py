"""PyTorch port vs tac: the Huffman-VBR slice end to end (tac_torch/codec.py
VBR half, api.py) — the golden parity digest, the decision layers integer
for integer on tac's own lines and SMRs, the fast-mode round trip, and
cross-decoding for every huffman_sets setting."""

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
# tac's reservoir chain jitted, as its encoders run it (eager, each op
# around the scan dispatches and compiles on its own)
tac_chain = jax.jit(jc._reservoir_chain, static_argnums=(4, 5, 6))


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


def _tids(data: bytes) -> np.ndarray:
    """The tableId of every block of a VBR stream (SPEC.md §7: 2 bits after
    the 4-bit overall scale)."""
    hdr, off = tbs.read_header(data)
    f = jm.num_frames(hdr.num_samples, hdr.n_mdct_lines)
    offs, _ = tbs.split_blocks(data, off, f * hdr.n_channels)
    first = np.frombuffer(data, np.uint8)[np.asarray(offs)]
    return (first >> 2) & 3


def test_vbr_parity_digest_matches_golden(clip44):
    """Parity precision (f64, FFT MDCT, line psy, f64 reservoir chain): the
    port's config3 stream hashes to goldens/streams.json, and its parity
    decode equals tac's to 1e-7 (f64 FFTs of two libraries, as float32)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden

    cfg = TPRESETS["vbr-huffman"].replace(precision="parity")
    data = tapi.encode_array(clip44, cfg, device="cpu")
    with open(golden.GOLDEN_PATH) as f:
        want = json.load(f)["config3_vbr_huffman"]
    assert {"sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data)} == want
    assert tbs.read_header(data)[0].huffman
    y = tapi.decode_array(data, device="cpu")[0]
    np.testing.assert_allclose(y, japi.decode_array(data)[0], rtol=0, atol=1e-7)


def test_vbr_decision_layers_identical(clip44):
    """SPEC §10.1: fed tac's own MDCT lines and SMRs (vbr-huffman, fast),
    the port's band costs, reservoir chain (K3's plain version), quantizer,
    Huffman field build and packer (K2's plain version) give tac's integers
    and payload words exactly."""
    jcfg, tcfg = JPRESETS["vbr-huffman"], TPRESETS["vbr-huffman"]
    jcons, tcons = jc.make_consts(jcfg), tc.make_consts(tcfg, CPU)
    frames = jm.frame_signal(jnp.asarray(clip44.T, jcons.dtype),
                             jcfg.n_mdct_lines)           # [C, F, N]
    lanes, f = frames.shape[:2]
    lines, smr = jax.jit(jax.vmap(lambda fr: jc.analyze_frame(fr, jcfg, jcons)))(
        frames.reshape(lanes * f, -1))
    lt, st = torch.tensor(np.asarray(lines)), torch.tensor(np.asarray(smr))

    want_bh = jax.jit(lambda l_: jc._vbr_band_costs(l_, jcfg, jcons))(lines)
    got_bh = tc._vbr_band_costs(lt, tcfg, tcons)
    assert got_bh.dtype == torch.int32 and got_bh.shape == (lanes * f, 25, 14)
    np.testing.assert_array_equal(got_bh.numpy(), np.asarray(want_bh))

    def to_fl(x):
        return x.reshape(lanes, f, *x.shape[1:]).swapaxes(0, 1)

    cap_res = jcfg.reservoir_factor * jcons.budget
    want = tac_chain(to_fl(smr), to_fl(want_bh), jcons.n_lines,
                     jnp.zeros(lanes, jnp.int32), jcons.budget,
                     cap_res, jcfg)
    got = tc._reservoir_chain(
        to_fl(st).contiguous(), to_fl(got_bh).contiguous(), tcons.n_lines,
        torch.zeros(lanes, dtype=torch.int32), tcons.budget, cap_res, tcfg)
    for g, w, what in zip(got, want, ["alloc", "tid", "used", "res"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    assert (got[1] > 0).any(), "no Huffman-coded frame in the material"

    alloc_rows = np.asarray(want[0]).swapaxes(0, 1).reshape(lanes * f, -1)
    tid_rows = np.asarray(want[1]).swapaxes(0, 1).reshape(lanes * f)
    cap = jc.payload_capacity_bits(jcfg, jcons)
    code = jax.jit(jax.vmap(lambda l_, a_: jc.quantize_given_alloc(
        l_, a_, jcfg, jcons)))(lines, jnp.asarray(alloc_rows))
    want_w, want_n = jax.jit(lambda code, tid: jbp.pack_rows(
        *jc.payload_fields_vbr(code, tid, jcfg, jcons), cap))(
        code, jnp.asarray(tid_rows))
    tcode = tc.quantize_given_alloc(lt, torch.tensor(alloc_rows), tcfg, tcons)
    got_w, got_n = tbp.pack_rows(
        *tc.payload_fields_vbr(tcode, torch.tensor(tid_rows), tcfg, tcons), cap)
    got_w = got_w.numpy().view(np.uint32)
    np.testing.assert_array_equal(got_w, np.asarray(want_w))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert tbp.rows_to_stream(got_w, got_n.numpy()) == jbp.rows_to_stream(
        np.asarray(want_w), np.asarray(want_n))


@pytest.mark.parametrize("n_sets", [1, 2, 3])
def test_vbr_fast_round_trip_and_cross_decode(clip44, n_sets):
    """vbr-huffman fast vs tac fast for huffman_sets 1..3: round-trip SNR
    within 0.1 dB (SPEC §10); each package decodes the other's stream to
    what the stream's own package decodes (f32 IMDCT: within 1e-5); tableIds
    stay inside what the setting allows."""
    x = clip44
    d_tac = japi.encode_array(x, JPRESETS["vbr-huffman"].replace(
        huffman_sets=n_sets))
    d_port = tapi.encode_array(x, TPRESETS["vbr-huffman"].replace(
        huffman_sets=n_sets), device="cpu")
    assert tbs.read_header(d_port)[0].huffman
    y_tt = japi.decode_array(d_tac, precision="fast")[0]
    y_pp = tapi.decode_array(d_port, precision="fast", device="cpu")[0]
    assert y_pp.shape == x.shape and y_pp.dtype == np.float32
    assert abs(_snr(x, y_tt) - _snr(x, y_pp)) < 0.1
    tids = _tids(d_port)
    assert tids.max() <= n_sets and (tids > 0).any()
    y_pt = tapi.decode_array(d_tac, precision="fast", device="cpu")[0]
    y_tp = japi.decode_array(d_port, precision="fast")[0]
    np.testing.assert_allclose(y_pt, y_tt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(y_tp, y_pp, rtol=0, atol=1e-5)


def test_vbr_batch_lanes_equal_solo_encodes(clip44):
    """Every channel of every clip is its own reservoir lane starting at
    fill 0, and rows cross chunk boundaries unchanged: a batched encode
    gives each clip the words of its solo encode, at any chunk size."""
    cfg = TPRESETS["vbr-huffman"]
    a = clip44.T[:, :8192]
    b = 0.5 * clip44.T[::-1, 4096:12288]
    batch_w, batch_n = tc.encode_clip_vbr_packed(np.stack([a, b]), cfg,
                                                 device="cpu")
    assert batch_w.dtype == torch.int32 and batch_w.shape[:3] == (2, 2, 9)
    chunk = tc.ENC_CHUNK
    try:
        tc.ENC_CHUNK = 7                          # 18 rows a clip: 3 chunks
        for i, clip in enumerate((a, b)):
            w, n = tc.encode_clip_vbr_packed(clip, cfg, device="cpu")
            assert torch.equal(w, batch_w[i]) and torch.equal(n, batch_n[i])
    finally:
        tc.ENC_CHUNK = chunk


def test_vbr_entry_points_need_a_card_unless_told(monkeypatch):
    """Without a card the VBR entry points raise unless the caller passes
    device="cpu", mid/side VBR as well."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2048, 2))
    cfg = TPRESETS["vbr-huffman"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.encode_array(x, cfg)
    data = tapi.encode_array(x, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.decode_array(data)
    with pytest.raises(RuntimeError):
        tc.encode_clip_vbr_packed(x.T, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.encode_clip_vbr_packed(x.T, TPRESETS["vbr-ms"])
    w, n = tc.encode_clip_vbr_packed(x.T, TPRESETS["vbr-ms"], device="cpu")
    assert w.shape[:2] == n.shape[:2] == (2, 3)
    y, fs = tapi.decode_array(data, "fast", device="cpu")
    assert y.shape == x.shape and fs == 44100 and not y.any()
