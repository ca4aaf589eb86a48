"""PyTorch port vs tac: mid/side joint stereo (SPEC.md §11) in tac_torch —
the golden parity digests of the four M/S families (no JAX call), the
butterfly bit for bit, the joint allocation and the joint reservoir
integer for integer on the same inputs as tac's, a 4-channel pairwise
stream, batched encodes against solo ones, and the rate-distortion gain
that justifies the mode."""

import hashlib
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tac import codec as jc
from tac.config import PRESETS as JPRESETS
from tac_torch import api as tapi
from tac_torch import bands
from tac_torch import bitalloc as tba
from tac_torch import bitstream as tbs
from tac_torch import codec as tc
from tac_torch import family as tf
from tac_torch.config import PRESETS as TPRESETS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NL = bands.lines_per_band(44100, 1024)

# goldens/streams.json's M/S cases, as tools/golden.py:cases() builds them
GOLDEN_MS = {
    "config7_ms_stereo": ("stereo44-128-ms", {}, "stereo44"),
    "config8_ms_vbr": ("vbr-ms", {}, "stereo44"),
    "config9_ms_blockswitch": (
        "ms-bs", {"n_mdct_lines": 256, "n_mdct_lines_short": 64},
        "transient44_stereo"),
    "config10_ms_vbr_blockswitch": (
        "vbr-ms-bs", {"n_mdct_lines": 256, "n_mdct_lines_short": 64},
        "transient44_stereo"),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def material():
    """tools/golden.py's clips (numpy only)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden

    return golden.clips()


def _snr(x, y):
    return 10 * np.log10(np.mean(x ** 2) / max(np.mean((x - y) ** 2), 1e-30))


@pytest.mark.parametrize("name", list(GOLDEN_MS))
def test_ms_parity_digests_match_goldens(name, material):
    """Parity precision (f64, FFT MDCT, line psy, f64 joint allocation and
    reservoir): the port's M/S streams hash to goldens/streams.json, and
    the header carries the mid/side flag."""
    preset, change, clip = GOLDEN_MS[name]
    x, fs = material[clip]
    cfg = TPRESETS[preset].replace(precision="parity", sample_rate=fs,
                                   **change)
    data = tapi.encode_array(x, cfg, device="cpu")
    with open(os.path.join(REPO, "goldens", "streams.json")) as f:
        want = json.load(f)[name]
    assert {"sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data)} == want
    assert tbs.read_header(data)[0].ms


def test_butterfly_bit_identical():
    """ms_forward / ms_inverse against tac's on a seeded f64 [2, 4, T]
    array: the same op order, so the same bits."""
    x = np.random.default_rng(3).standard_normal((2, 4, 1001))
    fwd = tc.ms_forward(torch.tensor(x))
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(jc.ms_forward(
        jnp.asarray(x))))
    np.testing.assert_array_equal(
        tc.ms_inverse(fwd).numpy(),
        np.asarray(jc.ms_inverse(jnp.asarray(fwd.numpy()))))


@pytest.mark.parametrize("widths", ["shared", "per_row"])
def test_joint_allocation_equals_tac(widths):
    """The joint allocation over pair-adjacent rows (2B = 50 bands, 2·budget)
    — K1's plain version in fast precision and the f64 loop in parity —
    equals tac's _joint_alloc_pair_rows on the same snapped SMRs, integer
    for integer; per-row widths are the block-switch maps, one per pair."""
    rng = np.random.default_rng(21)
    m = 96
    smr = tba.snap_smr(torch.tensor(rng.normal(12, 22, (m, 25)))).numpy()
    nl = NL
    if widths == "per_row":
        short = 8 * bands.lines_per_band(44100, 128)
        pair_short = rng.random(m // 2) < 0.4
        nl = np.where(np.repeat(pair_short, 2)[:, None], short, NL)
    jcfg = JPRESETS["stereo44-128-ms"]
    want = np.asarray(jax.jit(jc._joint_alloc_pair_rows, static_argnums=(2, 3))(
        jnp.asarray(smr, jnp.float32), jnp.asarray(nl, jnp.int32), 1282, jcfg))
    nl_t = torch.tensor(nl, dtype=torch.int32)
    for prec, dt in (("fast", torch.float32), ("parity", torch.float64)):
        cfg = TPRESETS["stereo44-128-ms"].replace(precision=prec)
        got = tc.joint_alloc_pair_rows(torch.tensor(smr, dtype=dt), nl_t, 1282,
                                       cfg)
        assert got.dtype == torch.int32 and got.shape == (m, 25)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=prec)
    # the pair shares 2·budget; one row may hold more than one budget
    alloc_bits = (want * np.broadcast_to(nl, want.shape)).reshape(m // 2, -1)
    assert alloc_bits.sum(1).max() <= 2 * 1282
    assert (want * np.broadcast_to(nl, want.shape)).sum(1).max() > 1282


@pytest.mark.parametrize("widths", ["shared", "per_frame"])
def test_joint_reservoir_equals_tac(widths):
    """One reservoir lane per pair: per-row SMRs and band costs in (pair,
    frame, channel) order, pair-joined to [F, P, 2B] by the port's
    frame_major, chained with base 2·budget and cap 4·2·budget, equal tac's
    _reservoir_chain on its own pair join (alloc, tid, used, res); the
    per-row allocations and the pair's tableId, repeated into both rows,
    equal tac's row order."""
    rng = np.random.default_rng(22)
    p, f, nb, base = 3, 7, 25, 2 * 1280
    rows = p * f * 2
    smr = tba.snap_smr(torch.tensor(rng.normal(8, 22, (rows, nb)))).numpy()
    m = rng.integers(2, 9, (rows, nb, 14))
    bh = (m * NL[None, :, None] * rng.uniform(0.6, 1.3, m.shape)).astype(np.int32)
    nl_rows = np.broadcast_to(NL, (rows, nb))
    if widths == "per_frame":
        short = 8 * bands.lines_per_band(44100, 128)
        nl_rows = np.where(np.repeat(rng.random(p * f) < 0.4, 2)[:, None],
                           short, NL)
    to_fl = lambda a: jnp.asarray(a).reshape(p, f, 2 * nb, *a.shape[2:]) \
        .swapaxes(0, 1)
    nl_j = jnp.concatenate([jnp.asarray(NL)] * 2) if widths == "shared" \
        else to_fl(nl_rows)
    jcfg = JPRESETS["vbr-ms"]
    want = jax.jit(jc._reservoir_chain, static_argnums=(4, 5, 6))(
        to_fl(smr), to_fl(bh), nl_j, jnp.zeros(p, jnp.int32), base, 4 * base,
        jcfg)
    nl_t = (torch.tensor(np.concatenate([NL, NL]), dtype=torch.int32)
            if widths == "shared"
            else tc.frame_major(torch.tensor(nl_rows, dtype=torch.int32), p, f))
    got = tc._reservoir_chain(
        tc.frame_major(torch.tensor(smr, dtype=torch.float32), p, f),
        tc.frame_major(torch.tensor(bh), p, f), nl_t,
        torch.zeros(p, dtype=torch.int32), base, 4 * base,
        TPRESETS["vbr-ms"])
    for g, w, what in zip(got, want, ["alloc", "tid", "used", "res"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    assert (got[1] > 0).any() and (got[1] == 0).any()
    al_rows, tid_rows = tc.rows_of_chain(got[0], got[1], 2)
    np.testing.assert_array_equal(
        al_rows.numpy(), np.asarray(want[0]).swapaxes(0, 1).reshape(rows, nb))
    np.testing.assert_array_equal(
        tid_rows.numpy(), np.repeat(np.asarray(want[1]).swapaxes(0, 1), 2))


def _quad(material):
    """Four channels at 0.25 s: the golden stereo clip as pair 0 and a
    weaker correlated pair of its own as pair 1."""
    x = material["stereo44"][0][:11025]
    y = 0.5 * x[:, ::-1] + 0.01 * np.random.default_rng(8).standard_normal(
        x.shape)
    return np.concatenate([x, y], 1)


@pytest.mark.parametrize("preset", ["stereo44-128-ms", "vbr-ms", "ms-bs",
                                    "vbr-ms-bs"])
def test_quad_pairwise_stream(preset, material):
    """A 4-channel M/S stream in parity precision: each adjacent pair codes
    on its own, so pair 0's payload rows equal the stereo encode of the
    same two channels byte for byte (twice the bitrate for twice the
    channels gives each the same budget), and the stream round-trips, its
    pair 0 decoding to the stereo decode."""
    q = _quad(material)
    cfg = TPRESETS[preset].replace(precision="parity")
    cfg4 = cfg.replace(n_channels=4, bitrate_bps=2 * cfg.bitrate_bps)
    w4, n4 = tf.encode_clip_packed(q.T, cfg4, device="cpu")
    w2, n2 = tf.encode_clip_packed(q[:, :2].T, cfg, device="cpu")
    assert w4.shape[0] == 4 and w4.shape[1:] == w2.shape[1:]
    assert torch.equal(n4[:2], n2) and torch.equal(w4[:2], w2)
    y4 = tapi.decode_array(tapi.encode_array(q, cfg4, device="cpu"),
                           device="cpu")[0]
    y2 = tapi.decode_array(tapi.encode_array(q[:, :2], cfg, device="cpu"),
                           device="cpu")[0]
    assert y4.shape == q.shape
    np.testing.assert_array_equal(y4[:, :2], y2)
    assert _snr(q, y4) > 10.0


@pytest.mark.parametrize("preset", ["stereo44-128-ms", "vbr-ms", "ms-bs",
                                    "vbr-ms-bs"])
def test_ms_batch_equals_solo_encodes(preset, material):
    """Two clips in one batched fast encode give each clip the words of its
    solo encode, with an odd row chunk (the pair-joined paths round it up
    to an even size, so no pair splits); the batched decode of those words
    equals the solo decode."""
    x = material["stereo44"][0].T
    a, b = x[:, :6144], 0.5 * x[::-1, 4096:10240]
    cfg = TPRESETS[preset].replace(n_mdct_lines=256, n_mdct_lines_short=64)
    chunk = tc.ENC_CHUNK
    try:
        tc.ENC_CHUNK = 7
        batch_w, batch_n = tf.encode_clip_packed(np.stack([a, b]), cfg,
                                                 device="cpu")
        assert batch_w.shape[:3] == (2, 2, 25)
        for i, clip in enumerate((a, b)):
            w, n = tf.encode_clip_packed(clip, cfg, device="cpu")
            assert torch.equal(w, batch_w[i]) and torch.equal(n, batch_n[i])
    finally:
        tc.ENC_CHUNK = chunk
    y = tf.decode_clip_packed(batch_w, cfg, 6144, device="cpu")
    y1 = tf.decode_clip_packed(batch_w[1], cfg, 6144, device="cpu")
    assert torch.equal(y[1], y1)
    assert _snr(b, y[1].numpy()) > 10.0


def _correlated44():
    """tests/test_ms.py's material for the mode: a common program with a
    small side component, 0.5 s. (The golden stereo clip, [sig, 0.8·sig +
    noise], is not M/S-favourable: there M/S codes below L/R, in tac as
    in the port.)"""
    fs = 44100
    t = np.arange(fs // 2) / fs
    rng = np.random.default_rng(11)
    common = sum(a * np.sin(2 * np.pi * f * t) for a, f in
                 [(0.35, 440), (0.2, 660), (0.1, 1230), (0.05, 3500)])
    side = (0.05 * np.sin(2 * np.pi * 550 * t)
            + 0.01 * rng.standard_normal(len(t)))
    return np.stack([common + side, common - side], axis=1)


@pytest.mark.parametrize("lr,ms", [("stereo44-128", "stereo44-128-ms"),
                                   ("vbr-huffman", "vbr-ms")])
def test_ms_beats_lr(lr, ms):
    """The point of the mode, in the port alone (fast): on correlated stereo
    M/S gains at least 1 dB of SNR over L/R at a matched rate (its stream
    at most 1 % longer), as tests/test_ms.py holds for tac."""
    x = _correlated44()
    d_lr = tapi.encode_array(x, TPRESETS[lr], device="cpu")
    d_ms = tapi.encode_array(x, TPRESETS[ms], device="cpu")
    s_lr = _snr(x, tapi.decode_array(d_lr, "fast", device="cpu")[0])
    s_ms = _snr(x, tapi.decode_array(d_ms, "fast", device="cpu")[0])
    assert len(d_ms) <= len(d_lr) * 1.01
    assert s_ms >= s_lr + 1.0
