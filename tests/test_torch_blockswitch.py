"""PyTorch port vs tac: block switching for fixed-rate L/R streams
(tac_torch/blockswitch.py, SPEC.md §9) — windows and constants leaf for
leaf, transient flags and window states, the golden parity digest, the
decision layers integer for integer on tac's own lines, SMRs and states,
the fast round trip and cross-decoding, at H = 256 / Hs = 64 mono."""

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
from tac.dsp import window as jw
from tac.ops import bitpack as jbp
from tac_torch import api as tapi
from tac_torch import bitstream as tbs
from tac_torch import blockswitch as tb
from tac_torch import codec as tc
from tac_torch import family as tf
from tac_torch.config import PRESETS as TPRESETS
from tac_torch.dsp import window as tw
from tac_torch.ops import bitpack as tbp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# tac's flag and state layers jitted, as its encoders run them (eager, each
# op dispatches and compiles on its own)
tac_flags = jax.jit(jbs.transient_flags, static_argnums=1)
tac_states = jax.jit(jbs.window_states, static_argnums=1)
FS = 44100


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _burst(n, tau, fs=FS):
    k = np.arange(n)
    return np.exp(-k / tau) * np.sin(2 * np.pi * 3000 * k / fs)


def _transient_clip():
    """The golden suite's 0.5 s mono tone with one burst (transient44)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden

    return golden.clips()["transient44"][0]


def _all_short_clip():
    """Dense bursts: mostly SHORT frames (tests/test_blockswitch.py)."""
    x = np.zeros(FS // 4)
    for pos in range(0, len(x) - 600, 700):
        x[pos:pos + 600] += _burst(600, 60.0)
    return x[:, None]


CLIPS = {"transient": _transient_clip, "all_short": _all_short_clip}


def _snr(x, y):
    return 10 * np.log10(np.mean(x ** 2) / max(np.mean((x - y) ** 2), 1e-30))


def _states(data: bytes) -> np.ndarray:
    """The window state of every block of a block-switch stream (SPEC.md §9:
    the first two bits of a payload)."""
    hdr, off = tbs.read_header(data)
    f = jm.num_frames(hdr.num_samples, hdr.n_mdct_lines)
    offs, _ = tbs.split_blocks(data, off, f * hdr.n_channels)
    return np.frombuffer(data, np.uint8)[np.asarray(offs)] >> 6


@pytest.mark.parametrize("name,n_long,n_short", [("sine", 512, 128),
                                                 ("sine", 2048, 256),
                                                 ("kbd", 512, 128)])
def test_transition_windows_equal_tac(name, n_long, n_short):
    """f64 host tables: exact."""
    for got, want in zip(tw.transition_windows(n_long, n_short, name),
                         jw.transition_windows(n_long, n_short, name)):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def _tac_bs_arrays(jcons) -> dict:
    """tac's BsConsts as the numpy dict ``bs_consts_from_numpy`` takes."""
    def codec_arrays(cc):
        p = cc.psy
        return {"window": cc.window, "fwd_basis": cc.fwd_basis,
                "inv_basis": cc.inv_basis, "band_of_line": cc.band_of_line,
                "n_lines": cc.n_lines,
                "psy": None if p is None else
                {k: getattr(p, k) for k in tb.consts.PSY_LEAVES},
                "huffman": None}

    ps = jcons.psy_short
    out = {k: np.asarray(getattr(jcons, k)) for k in tb.BS_LEAVES}
    out.update(sub_idx=np.asarray(jcons.sub_idx), cl=codec_arrays(jcons.cl),
               cg_band_of_line=np.asarray(jcons.cg.band_of_line),
               cg_n_lines=np.asarray(jcons.cg.n_lines),
               psy_short=None if ps is None else
               {k: getattr(ps, k) for k in tb.consts.PSY_LEAVES})
    return out


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_bs_consts_equal_tac(precision):
    """Every array of the port's BsConsts equals tac's, in the precision's
    float type, and the static fields agree."""
    jcfg = JPRESETS["streaming-ll"].replace(precision=precision)
    tcfg = TPRESETS["streaming-ll"].replace(precision=precision)
    want = _tac_bs_arrays(jbs.make_bs_consts(jcfg))
    got = tb.bs_host_arrays(tcfg)

    def same(g, w, path):
        if isinstance(w, dict):
            for k in w:
                same(g[k], w[k], f"{path}.{k}")
        elif w is None:
            assert g is None, path
        else:
            w = np.asarray(w)
            assert np.asarray(g).dtype == w.dtype, path
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=path)

    same({k: got[k] for k in want if k != "cl"},
         {k: want[k] for k in want if k != "cl"}, "bs")
    same({k: got["cl"][k] for k in want["cl"] if k != "huffman"},
         {k: want["cl"][k] for k in want["cl"] if k != "huffman"}, "cl")
    jcons, c = jbs.make_bs_consts(jcfg), tb.make_bs_consts(tcfg, CPU)
    assert (c.h3, c.k, c.cl.budget, c.cg.budget, c.cg.band_tile) == \
        (jcons.h3, jcons.k, jcons.cl.budget, jcons.cg.budget, jcons.cg.band_tile)
    assert c.cg.band_ranges == jcons.cg.band_ranges
    assert c.psy_short.mdct_gain == jcons.psy_short.mdct_gain
    assert not c.cl.psy.band_thresh and not c.psy_short.band_thresh
    # the hand-over: the port's constants built from tac's arrays
    c2 = tb.bs_consts_from_numpy(tcfg, want, CPU)
    for name in tb.BS_LEAVES + ("sub_idx",):
        assert torch.equal(getattr(c2, name), getattr(c, name)), name
    assert torch.equal(c2.cg.band_of_line, c.cg.band_of_line)
    assert torch.equal(c2.psy_short.zline, c.psy_short.zline)


@pytest.mark.parametrize("clip", ["transient", "all_short", "noise_steps"])
def test_flags_and_states_equal_tac(clip):
    """Transient flags (a float ratio test) and window states equal tac's in
    both precisions; every adjacent state pair meshes (TDAC)."""
    if clip == "noise_steps":
        rng = np.random.default_rng(5)
        x = rng.standard_normal((3, 9000)) * np.repeat(
            rng.choice([0.01, 0.3], (3, 30)), 300, axis=1)
    else:
        x = CLIPS[clip]().T
    legal = {(0, 0), (0, 1), (1, 2), (2, 2), (2, 3), (3, 0), (3, 1)}
    seen = set()
    for precision in ("parity", "fast"):
        jcfg = JPRESETS["streaming-ll"].replace(precision=precision)
        tcfg = TPRESETS["streaming-ll"].replace(precision=precision)
        dt = np.float64 if precision == "parity" else np.float32
        f = jm.num_frames(x.shape[-1], jcfg.n_mdct_lines)
        want_fl = np.asarray(tac_flags(jnp.asarray(x, dt), jcfg))
        got_fl = tb.transient_flags(torch.tensor(x.astype(dt)), tcfg)
        assert got_fl.dtype == torch.bool
        np.testing.assert_array_equal(got_fl.numpy(), want_fl)
        assert want_fl.any() and not want_fl.all()
        got_st = tb.window_states(got_fl, f)
        assert got_st.dtype == torch.int32 and got_st.shape == (x.shape[0], f)
        np.testing.assert_array_equal(
            got_st.numpy(), np.asarray(tac_states(jnp.asarray(want_fl), f)))
        for row in got_st.tolist():
            assert all(p in legal for p in zip(row[:-1], row[1:])), row
            seen.update(row)
    assert tb.SHORT in seen and tb.LONG in seen


def test_window_states_on_random_flags():
    """The neighbour logic alone, on random flag rows of several lengths
    (more frames than flags and fewer)."""
    rng = np.random.default_rng(2)
    for kb, f in ((15, 16), (20, 21), (7, 12), (9, 8)):
        flags = rng.random((6, kb)) < 0.3
        np.testing.assert_array_equal(
            tb.window_states(torch.tensor(flags), f).numpy(),
            np.asarray(tac_states(jnp.asarray(flags), f)))


def test_bs_parity_digest_matches_golden():
    """Parity precision: the port's config5 stream hashes to
    goldens/streams.json, and its parity decode equals tac's to 1e-7 (f64
    FFTs of two libraries, as float32)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden

    cfg = TPRESETS["streaming-ll"].replace(precision="parity")
    data = tapi.encode_array(_transient_clip(), cfg, device="cpu")
    with open(golden.GOLDEN_PATH) as f:
        want = json.load(f)["config5_blockswitch"]
    assert {"sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data)} == want
    hdr = tbs.read_header(data)[0]
    assert hdr.blockswitch and not hdr.huffman and hdr.n_mdct_lines_short == 64
    assert set(_states(data).tolist()) == {0, 1, 2, 3}
    y = tapi.decode_array(data, device="cpu")[0]
    np.testing.assert_allclose(y, japi.decode_array(data)[0], rtol=0, atol=1e-7)


def test_bs_decision_layers_identical():
    """SPEC §10.1: fed tac's own lines, SMRs and states (streaming-ll, fast),
    the port's state select, water-fill with per-row band widths (K1's plain
    version), both quantizers, field build and packer (K2's plain version)
    give tac's payload words exactly — though tac water-fills both
    encodings of every row and the port only the selected one."""
    jcfg, tcfg = JPRESETS["streaming-ll"], TPRESETS["streaming-ll"]
    jcons, c = jbs.make_bs_consts(jcfg), tb.make_bs_consts(tcfg, CPU)
    x = np.concatenate([_transient_clip()[:, 0], _all_short_clip()[:, 0]])
    xj = jnp.asarray(x[None], jcons.cl.dtype)
    frames = jm.frame_signal(xj, jcfg.n_mdct_lines)[0]       # [F, N]
    states = tac_states(tac_flags(xj, jcfg), frames.shape[0])[0]
    ll, sl, ls, ss = jax.jit(jax.vmap(
        lambda fr, st: jbs.analyze_frame_bs(fr, st, jcfg, jcons)))(frames, states)

    @jax.jit
    def tac_words(ll, sl, ls, ss, states):
        quant = jax.vmap(lambda l_, s_, cc: jc.quantize_lines(l_, s_, jcfg, cc),
                         in_axes=(0, 0, None))
        bc = jbs.BsFrameCode(state=states, long=quant(ll, sl, jcons.cl),
                             short=quant(ls, ss, jcons.cg))
        return jbp.pack_rows(*jbs.payload_fields_bs(bc, jcfg, jcons),
                             jbs.capacity_bits_bs(jcfg))

    want_w, want_n = tac_words(ll, sl, ls, ss, states)
    st = torch.tensor(np.asarray(states))
    t = [torch.tensor(np.asarray(a)) for a in (ll, sl, ls, ss)]
    assert {0, 1, 2, 3} <= set(st.tolist())
    nl = tb.state_n_lines(st, c)
    assert nl.shape == (len(st), 25) and nl.dtype == torch.int32
    alloc = tc.allocate_rows(tb.select_by_state(st, t[1], t[3]), tcfg, c.cl,
                             nl)
    bc = tb.quantize_both(t[0], t[2], alloc, st, tcfg, c)
    vals, wids = tb.payload_fields_bs(bc, tcfg, c)
    assert vals.shape[-1] == 2 + 2 * 25 + jcfg.n_mdct_lines
    got_w, got_n = tbp.pack_rows(vals, wids, tb.capacity_bits_bs(tcfg))
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(want_w))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert tb.capacity_bits_bs(tcfg) == jbs.capacity_bits_bs(jcfg)
    # and back: the port's unpack of tac's words returns the selected code
    back = tb._unpack_bs_fields(torch.tensor(np.asarray(want_w).view(np.int32)),
                                tcfg, c)
    code, _ = tb.select_code_bs(bc, c)
    assert torch.equal(back.state, st.to(torch.int32))
    for g, w in zip(back.long, code):
        assert torch.equal(g, w)


@pytest.mark.parametrize("clip", ["transient", "all_short"])
def test_bs_fast_round_trip_and_cross_decode(clip):
    """streaming-ll fast: the port's round-trip SNR is within 0.1 dB of its
    own parity round trip and of tac's fast one (SPEC §10); each package
    decodes the other's stream to what the stream's own package decodes
    (f32 IMDCT: within 1e-5); the all-SHORT clip is mostly SHORT frames."""
    x = CLIPS[clip]()
    tcfg = TPRESETS["streaming-ll"]
    d_tac = japi.encode_array(x, JPRESETS["streaming-ll"])
    d_port = tapi.encode_array(x, tcfg, device="cpu")
    hdr = tbs.read_header(d_port)[0]
    assert hdr.blockswitch and hdr.n_mdct_lines_short == 64
    np.testing.assert_array_equal(_states(d_port), _states(d_tac))
    if clip == "all_short":
        assert (_states(d_port) == tb.SHORT).mean() > 0.5
    y_tt = japi.decode_array(d_tac, precision="fast")[0]
    y_pp = tapi.decode_array(d_port, precision="fast", device="cpu")[0]
    assert y_pp.shape == x.shape and y_pp.dtype == np.float32
    assert abs(_snr(x, y_tt) - _snr(x, y_pp)) < 0.1
    pcfg = tcfg.replace(precision="parity")
    y_par = tapi.decode_array(tapi.encode_array(x, pcfg, device="cpu"),
                              device="cpu")[0]
    assert abs(_snr(x, y_par) - _snr(x, y_pp)) < 0.1
    y_pt = tapi.decode_array(d_tac, precision="fast", device="cpu")[0]
    y_tp = japi.decode_array(d_port, precision="fast")[0]
    np.testing.assert_allclose(y_pt, y_tt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(y_tp, y_pp, rtol=0, atol=1e-5)


def test_bs_unquantized_round_trip_reconstructs():
    """Window → MDCT → IMDCT → window → overlap-add through the port's
    constants reconstructs the signal for a legal state sequence: the
    hybrid windows and the sub-block placement preserve TDAC (f64)."""
    cfg = TPRESETS["streaming-ll"].replace(precision="parity", use_psy=False)
    c = tb.make_bs_consts(cfg, CPU)
    h, hs = cfg.n_mdct_lines, cfg.n_mdct_lines_short
    x = torch.tensor(np.random.default_rng(0).standard_normal(8 * h))
    frames = tc.fb.frame_signal(x, h)
    st = torch.zeros(frames.shape[0], dtype=torch.long)
    st[2], st[3], st[4], st[5] = 1, 2, 2, 3
    w = c.state_windows[st]
    y_long = tc.fb.imdct_fft(tc.fb.mdct_fft(frames * w, h), h) * w
    sub = frames[:, c.sub_idx]
    y_sub = tc.fb.imdct_fft(tc.fb.mdct_fft(sub * c.short_window, hs), hs) \
        * c.short_window
    y_short = torch.zeros_like(frames)
    y_short.index_add_(1, c.sub_idx.reshape(-1),
                       y_sub.reshape(frames.shape[0], -1))
    y = torch.where((st == 2)[:, None], y_short, y_long)
    out = tc.fb.overlap_add(y, h, len(x))
    assert float((out - x).abs().max()) < 1e-10


def test_bs_batch_equals_solo_encodes_at_any_chunk():
    """All leading axes flatten into rows and rows cross chunk boundaries
    unchanged: a batched encode gives each clip the words of its solo
    encode, and the batched decode the solo decode's audio."""
    cfg = TPRESETS["streaming-ll"].replace(n_channels=2)
    a = np.stack([_transient_clip()[:8000, 0], _all_short_clip()[:8000, 0]])
    b = 0.5 * a[::-1, ::-1].copy()
    batch_w, batch_n = tf.encode_clip_packed(np.stack([a, b]), cfg,
                                             device="cpu")
    assert batch_w.dtype == torch.int32 and batch_w.shape[:3] == (2, 2, 33)
    chunk = tc.ENC_CHUNK
    try:
        tc.ENC_CHUNK = 13                         # 66 rows a clip: 6 chunks
        for i, clip in enumerate((a, b)):
            w, n = tf.encode_clip_packed(clip, cfg, device="cpu")
            assert torch.equal(w, batch_w[i]) and torch.equal(n, batch_n[i])
    finally:
        tc.ENC_CHUNK = chunk
    y = tf.decode_clip_packed(batch_w, cfg, 8000, device="cpu")
    y0 = tf.decode_clip_packed(batch_w[0], cfg, 8000, device="cpu")
    assert y.shape == (2, 2, 8000) and torch.equal(y[0], y0)


def test_bs_entry_points_need_a_card_unless_told(monkeypatch):
    """Without a card the block-switch entry points raise unless the caller
    passes device="cpu", mid/side block switching as well."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2048, 1))
    cfg = TPRESETS["streaming-ll"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.encode_array(x, cfg)
    data = tapi.encode_array(x, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.decode_array(data)
    with pytest.raises(RuntimeError):
        tf.encode_clip_packed(x.T, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.encode_clip_packed(np.zeros((2, 2048)), TPRESETS["ms-bs"])
    w, n = tf.encode_clip_packed(np.zeros((2, 2048)), TPRESETS["ms-bs"],
                                 device="cpu")
    assert w.shape[:2] == n.shape[:2] == (2, 3)
    y, fs = tapi.decode_array(data, "fast", device="cpu")
    assert y.shape == x.shape and fs == 44100 and not y.any()
