"""PyTorch port vs tac: the Huffman × block-switching combo for L/R streams
(tac_torch/blockswitch.py, SPEC.md §7–§9) — the golden parity digest, the
three encode phases integer for integer on tac's own analysis (band costs
under both band maps, the reservoir chain with per-frame band widths,
fields and words), the fast round trip, and cross-decoding at H = 256 /
Hs = 64 mono and at the full width of PRESETS["vbr-bs"] for one second."""

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
from tac import blockswitch as jbs
from tac import codec as jc
from tac.config import PRESETS as JPRESETS
from tac.dsp import mdct as jm
from tac.ops import bitpack as jbp
from tac_torch import api as tapi
from tac_torch import bitstream as tbs
from tac_torch import blockswitch as tb
from tac_torch import codec as tc
from tac_torch.config import PRESETS as TPRESETS
from tac_torch.ops import bitpack as tbp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# tac's reservoir chain jitted, as its encoders run it (eager, each op
# around the scan dispatches and compiles on its own)
tac_chain = jax.jit(jc._reservoir_chain, static_argnums=(4, 5, 6))
tac_flags = jax.jit(jbs.transient_flags, static_argnums=1)
tac_states = jax.jit(jbs.window_states, static_argnums=1)
FS = 44100
SMALL = dict(n_mdct_lines=256, n_mdct_lines_short=64, n_channels=1)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _transient_clip():
    """The golden suite's 0.5 s mono tone with one burst (transient44)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden

    return golden.clips()["transient44"][0]


def _strike_clip(seconds: float, channels: int, seed: int = 4):
    """Harmonic tones plus noise with decaying 3 kHz bursts every ~0.2 s."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    t = np.arange(n) / FS
    x = np.stack([0.3 * np.sin(2 * np.pi * 330 * (c + 1) * t)
                  + 0.1 * np.sin(2 * np.pi * 1320 * t)
                  + 0.01 * rng.standard_normal(n) for c in range(channels)], 1)
    k = np.arange(800)
    burst = 0.5 * np.exp(-k / 100.0) * np.sin(2 * np.pi * 3000 * k / FS)
    for pos in range(FS // 7, n - 900, FS // 5):
        x[pos:pos + 800] += burst[:, None]
    return x


def _snr(x, y):
    return 10 * np.log10(np.mean(x ** 2) / max(np.mean((x - y) ** 2), 1e-30))


def _states_and_tids(data: bytes):
    """(window state, tableId) of every block of a combo stream (SPEC.md §7:
    2 state bits, the 4-bit overall scale, 2 tableId bits)."""
    hdr, off = tbs.read_header(data)
    f = jm.num_frames(hdr.num_samples, hdr.n_mdct_lines)
    offs, _ = tbs.split_blocks(data, off, f * hdr.n_channels)
    first = np.frombuffer(data, np.uint8)[np.asarray(offs)]
    return first >> 6, first & 3


def test_bs_vbr_parity_digest_matches_golden():
    """Parity precision: the port's config6 stream hashes to
    goldens/streams.json, and its parity decode equals tac's to 1e-7."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden

    cfg = TPRESETS["vbr-bs"].replace(precision="parity", **SMALL)
    data = tapi.encode_array(_transient_clip(), cfg, device="cpu")
    with open(golden.GOLDEN_PATH) as f:
        want = json.load(f)["config6_vbr_blockswitch"]
    assert {"sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data)} == want
    hdr = tbs.read_header(data)[0]
    assert hdr.blockswitch and hdr.huffman and hdr.n_mdct_lines_short == 64
    states, tids = _states_and_tids(data)
    assert set(states.tolist()) == {0, 1, 2, 3} and (tids > 0).any()
    y = tapi.decode_array(data, device="cpu")[0]
    np.testing.assert_allclose(y, japi.decode_array(data)[0], rtol=0, atol=1e-7)


def test_bs_vbr_decision_layers_identical():
    """SPEC §10.1: fed tac's own lines, SMRs and states (vbr-bs at H = 256,
    fast), the port's band costs under the long and the grouped-short band
    map, the reservoir chain with per-frame band widths (K3's plain
    version), both quantizers, the Huffman field build and the packer give
    tac's alloc / tid / res and payload words exactly."""
    jcfg = JPRESETS["vbr-bs"].replace(**SMALL)
    tcfg = TPRESETS["vbr-bs"].replace(**SMALL)
    jcons, c = jbs.make_bs_consts(jcfg), tb.make_bs_consts(tcfg, CPU)
    x = _strike_clip(0.6, 2, seed=9).T                       # two lanes
    xj = jnp.asarray(x, jcons.cl.dtype)
    frames = jm.frame_signal(xj, jcfg.n_mdct_lines)           # [L, F, N]
    lanes, f = frames.shape[:2]
    states = tac_states(tac_flags(xj, jcfg), f)
    rows, st_rows = frames.reshape(lanes * f, -1), states.reshape(-1)

    @jax.jit
    def tac_phase1(fr, st):
        ll, sl, ls, ss = jax.vmap(
            lambda f_, s_: jbs.analyze_frame_bs(f_, s_, jcfg, jcons))(fr, st)
        return (ll, sl, ls, ss, jc._vbr_band_costs(ll, jcfg, jcons.cl),
                jc._vbr_band_costs(ls, jcfg, jcons.cg))

    ll, sl, ls, ss, bh_l, bh_s = tac_phase1(rows, st_rows)
    st = torch.tensor(np.asarray(st_rows))
    assert {0, 1, 2, 3} <= set(st.tolist())
    t_ll, t_sl, t_ls, t_ss = (torch.tensor(np.asarray(a))
                              for a in (ll, sl, ls, ss))
    got_bh_l = tc._vbr_band_costs(t_ll, tcfg, c.cl)
    got_bh_s = tc._vbr_band_costs(t_ls, tcfg, c.cg)
    np.testing.assert_array_equal(got_bh_l.numpy(), np.asarray(bh_l))
    np.testing.assert_array_equal(got_bh_s.numpy(), np.asarray(bh_s))

    shrt = st_rows == jbs.SHORT
    smr = jnp.where(shrt[:, None], ss, sl)
    bh = jnp.where(shrt[:, None, None], bh_s, bh_l)
    nl = jnp.where(shrt[:, None], jcons.cg.n_lines, jcons.cl.n_lines)

    def to_fl(a):
        return a.reshape(lanes, f, *a.shape[1:]).swapaxes(0, 1)

    cap_res = jcfg.reservoir_factor * jcons.cl.budget
    want = tac_chain(to_fl(smr), to_fl(bh), to_fl(nl),
                     jnp.zeros(lanes, jnp.int32), jcons.cl.budget,
                     cap_res, jcfg)
    t_nl = tb.state_n_lines(st.reshape(lanes, f).transpose(0, 1), c)
    np.testing.assert_array_equal(t_nl.numpy(), np.asarray(to_fl(nl)))
    got = tc._reservoir_chain(
        to_fl(tb.select_by_state(st, t_sl, t_ss)).contiguous(),
        to_fl(tb.select_by_state(st, got_bh_l, got_bh_s)).contiguous(), t_nl,
        torch.zeros(lanes, dtype=torch.int32), c.cl.budget, cap_res, tcfg)
    for g, w, what in zip(got, want, ["alloc", "tid", "used", "res"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    assert (got[1] > 0).any(), "no Huffman-coded frame in the material"

    al_rows = np.asarray(want[0]).swapaxes(0, 1).reshape(lanes * f, -1)
    tid_rows = np.asarray(want[1]).swapaxes(0, 1).reshape(lanes * f)

    @jax.jit
    def tac_words(ll, ls, al, st, td):
        quant = jax.vmap(lambda l_, a_, cc: jc.quantize_given_alloc(
            l_, a_, jcfg, cc), in_axes=(0, 0, None))
        bc = jbs.BsFrameCode(state=st, long=quant(ll, al, jcons.cl),
                             short=quant(ls, al, jcons.cg))
        return jbp.pack_rows(*jbs.payload_fields_bs_vbr(bc, td, jcfg, jcons),
                             jbs.capacity_bits_bs_vbr(jcfg))

    want_w, want_n = tac_words(ll, ls, jnp.asarray(al_rows), st_rows,
                               jnp.asarray(tid_rows))
    bc = tb.quantize_both(t_ll, t_ls, torch.tensor(al_rows), st, tcfg, c)
    vals, wids = tb.payload_fields_bs_vbr(bc, torch.tensor(tid_rows), tcfg, c)
    assert vals.shape[-1] == 3 + 2 * 25 + 2 * jcfg.n_mdct_lines
    got_w, got_n = tbp.pack_rows(vals, wids, tb.capacity_bits_bs_vbr(tcfg))
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(want_w))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert tb.capacity_bits_bs_vbr(tcfg) == jbs.capacity_bits_bs_vbr(jcfg)
    # and back: the port's unpack (K4's plain version behind the per-row
    # band map) returns the selected code
    back = tb._unpack_bs_vbr_fields(
        torch.tensor(np.asarray(want_w).view(np.int32)), tcfg, c)
    code, _ = tb.select_code_bs(bc, c)
    assert torch.equal(back.state, st.to(torch.int32))
    for g, w in zip(back.long, code):
        assert torch.equal(g, w)


@pytest.mark.parametrize("size", ["small", "full_width"])
def test_bs_vbr_fast_round_trip_and_cross_decode(size):
    """The combo in fast precision vs tac's — H = 256 / Hs = 64 mono on the
    golden transient, and PRESETS["vbr-bs"] as it stands (stereo, H = 1024,
    Hs = 128, K = 8) on one second with strikes: equal window states,
    round-trip SNR within 0.1 dB of tac's fast one and (small) of the
    port's own parity round trip, and each package decodes the other's
    stream to what the stream's own package decodes (within 1e-5)."""
    if size == "small":
        x, change = _transient_clip(), SMALL
    else:
        x, change = _strike_clip(1.0, 2), {}
    tcfg = TPRESETS["vbr-bs"].replace(**change)
    d_tac = japi.encode_array(x, JPRESETS["vbr-bs"].replace(**change))
    d_port = tapi.encode_array(x, tcfg, device="cpu")
    hdr = tbs.read_header(d_port)[0]
    assert hdr.blockswitch and hdr.huffman
    assert hdr.n_mdct_lines_short == tcfg.n_mdct_lines_short
    st_p, tid_p = _states_and_tids(d_port)
    np.testing.assert_array_equal(st_p, _states_and_tids(d_tac)[0])
    assert set(st_p.tolist()) == {0, 1, 2, 3} and (tid_p > 0).any()
    y_tt = japi.decode_array(d_tac, precision="fast")[0]
    y_pp = tapi.decode_array(d_port, precision="fast", device="cpu")[0]
    assert y_pp.shape == x.shape and y_pp.dtype == np.float32
    assert abs(_snr(x, y_tt) - _snr(x, y_pp)) < 0.1
    if size == "small":
        pcfg = tcfg.replace(precision="parity")
        y_par = tapi.decode_array(tapi.encode_array(x, pcfg, device="cpu"),
                                  device="cpu")[0]
        assert abs(_snr(x, y_par) - _snr(x, y_pp)) < 0.1
    y_pt = tapi.decode_array(d_tac, precision="fast", device="cpu")[0]
    y_tp = japi.decode_array(d_port, precision="fast")[0]
    np.testing.assert_allclose(y_pt, y_tt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(y_tp, y_pp, rtol=0, atol=1e-5)


def test_bs_vbr_batch_lanes_equal_solo_encodes():
    """Every channel of every clip is its own reservoir lane from fill 0: a
    batched combo encode gives each clip the words of its solo encode at
    any chunk size, and the batched decode the solo decode's audio."""
    cfg = TPRESETS["vbr-bs"].replace(n_mdct_lines=256, n_mdct_lines_short=64)
    a = _strike_clip(0.3, 2, seed=1).T
    b = 0.5 * _strike_clip(0.3, 2, seed=2).T[::-1].copy()
    batch_w, batch_n = tb.encode_clip_bs_vbr_packed(np.stack([a, b]), cfg,
                                                    device="cpu")
    f = jm.num_frames(a.shape[1], 256)
    assert batch_w.dtype == torch.int32 and batch_w.shape[:3] == (2, 2, f)
    chunk = tc.ENC_CHUNK
    try:
        tc.ENC_CHUNK = 17
        for i, clip in enumerate((a, b)):
            w, n = tb.encode_clip_bs_vbr_packed(clip, cfg, device="cpu")
            assert torch.equal(w, batch_w[i]) and torch.equal(n, batch_n[i])
    finally:
        tc.ENC_CHUNK = chunk
    t = a.shape[1]
    y = tb.decode_clip_bs_vbr_packed(batch_w, cfg, t, device="cpu")
    y1 = tb.decode_clip_bs_vbr_packed(batch_w[1], cfg, t, device="cpu")
    assert y.shape == (2, 2, t) and torch.equal(y[1], y1)


def test_bs_vbr_entry_points_need_a_card_unless_told(monkeypatch):
    """Without a card the combo entry points raise unless the caller passes
    device="cpu", the mid/side combo as well."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((4096, 2))
    cfg = TPRESETS["vbr-bs"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.encode_array(x, cfg)
    data = tapi.encode_array(x, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.decode_array(data)
    with pytest.raises(RuntimeError):
        tb.encode_clip_bs_vbr_packed(x.T, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.encode_clip_bs_vbr_packed(x.T, TPRESETS["vbr-ms-bs"])
    w, n = tb.encode_clip_bs_vbr_packed(x.T, TPRESETS["vbr-ms-bs"],
                                        device="cpu")
    assert w.shape[:2] == n.shape[:2] == (2, 5)
    y, fs = tapi.decode_array(data, "fast", device="cpu")
    assert y.shape == x.shape and fs == 44100 and not y.any()
