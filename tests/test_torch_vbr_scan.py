"""PyTorch port vs tac: the bit-reservoir chain (kernel K3's plain version,
tac_torch/ops/vbr_scan.py) against both of tac's forms on the same numpy
inputs — the lax.scan chain (codec._reservoir_chain) and the Pallas kernel
in interpret mode — on the cases of tests/test_pallas_vbr_scan.py plus three
table sets. alloc / tid / used / res are integers and must be equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tac import bands
from tac import bitalloc as jba
from tac import codec as jc
from tac.config import PRESETS as JPRESETS
from tac.huffman import MAX_M, MIN_M
from tac.ops.pallas_vbr_scan import vbr_reservoir_scan as pallas_scan
from tac_torch import bitalloc as tba
from tac_torch import codec as tc
from tac_torch.config import PRESETS as TPRESETS
from tac_torch.ops import alloc as tk1
from tac_torch.ops import vbr_scan as tk3

NL = bands.lines_per_band(44100, 1024)
# tac's reservoir chain jitted, as its encoders run it (eager, each op
# around the scan dispatches and compiles on its own)
tac_chain = jax.jit(jc._reservoir_chain, static_argnums=(4, 5, 6))
NL_S = 2 * bands.lines_per_band(44100, 512)
B = len(NL)
NAMES = ["alloc", "tid", "used", "res"]
RAW_COST = (np.arange(MIN_M, MAX_M + 1)[None, :] * NL[:, None]).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(rng, f, lanes, nl=NL, n_sets=1, per_frame_nl=False):
    nb = len(nl)
    smr = rng.normal(8, 22, (f, lanes, nb)).astype(np.float32)
    # plausible coded costs: raw cost at m with +-30% huffman spread
    m = rng.integers(MIN_M, MAX_M + 1, (f, lanes, nb, 7 * n_sets))
    bh = (m * nl[None, None, :, None]
          * rng.uniform(0.7, 1.3, m.shape)).astype(np.int32)
    if per_frame_nl:
        shrt = rng.random((f, lanes, 1)) < 0.4
        nl = np.where(shrt, NL_S[None, None, :], NL[None, None, :])
    return smr, bh, np.asarray(nl, np.int32)


def _tac_scan(smr, bh, nl, res0, base, cap):
    """The lax.scan path (CPU backend: tac's kernel gate is off)."""
    out = tac_chain(jnp.asarray(smr), jnp.asarray(bh),
                    jnp.asarray(nl), jnp.asarray(res0), base, cap,
                    JPRESETS["vbr-huffman"])
    return [np.asarray(x) for x in out]


def _tac_kernel(smr, bh, nl, res0, base, cap):
    """tac's Pallas kernel in interpret mode, with tac's loop-shape settings
    from the environment (TAC_WF_PREFIX etc.; see _case_env)."""
    out = pallas_scan(jba.snap_smr(jnp.asarray(smr, jnp.float32)),
                      jnp.asarray(bh), jnp.asarray(nl), jnp.asarray(res0),
                      base=base, cap=cap, max_mant=16, nb=smr.shape[-1],
                      interpret=True)
    return [np.asarray(x) for x in out]


def _port_plain(smr, bh, nl, res0, base, cap):
    out = tk3.vbr_reservoir_scan_plain(
        tba.snap_smr(torch.tensor(smr)), torch.tensor(bh), torch.tensor(nl),
        torch.tensor(res0), base=base, cap=cap)
    assert all(x.dtype == torch.int32 for x in out)
    return [x.numpy() for x in out]


def _case(name, rng):
    """(smr, bits_huf, n_lines, res0, base, cap) of one named case."""
    if name == "random_7x3":
        return (*_inputs(rng, 7, 3), np.zeros(3, np.int32), 700, 2800)
    if name == "per_frame_n_lines":
        return (*_inputs(rng, 6, 2, per_frame_nl=True),
                np.asarray([0, 137], np.int32), 650, 2600)
    if name == "joint_50_bands":
        return (*_inputs(rng, 6, 2, nl=np.concatenate([NL, NL])),
                np.zeros(2, np.int32), 1400, 5600)
    n_sets = {"two_sets_ties": 2, "three_sets": 3}[name]
    smr, bh, nl = _inputs(rng, 7, 3, n_sets=n_sets)
    bh[0, 0, :, :7] = RAW_COST                       # set 1 == raw
    bh[1, 1, :, 7:14] = bh[1, 1, :, :7]              # set 2 == set 1
    bh[2, 2, :, 7:14] = np.minimum(bh[2, 2, :, :7], RAW_COST) - 1  # set 2 wins
    if n_sets == 3:
        bh[3, 0, :, 14:] = bh[3, 0, :, 7:14]         # set 3 == set 2
        bh[4, 1, :, 14:] = np.minimum(np.minimum(
            bh[4, 1, :, :7], bh[4, 1, :, 7:14]), RAW_COST) - 1     # set 3 wins
    return smr, bh, nl, np.zeros(3, np.int32), 700, 2800


def _case_env(name, monkeypatch):
    """tac's kernel runs its defaults for random_7x3 (and the resume test on
    the same shape) and no straight-line loop prefix (TAC_WF_PREFIX=0) for
    the other cases. tac documents the prefix as decision-exact at any value
    (tac/ops/pallas_vbr_scan.py: post-fixpoint body applications are the
    identity); its 12 unrolled copies of the loop body are what makes an
    interpret-mode trace and compile cost about 4 s per shape here, so both
    loop shapes are compared and each further shape costs half as much."""
    if name != "random_7x3":
        monkeypatch.setenv("TAC_WF_PREFIX", "0")


@pytest.mark.parametrize("name", ["random_7x3", "per_frame_n_lines",
                                  "joint_50_bands", "two_sets_ties",
                                  "three_sets"])
def test_plain_k3_equals_tac_scan_and_kernel(name, rng, monkeypatch):
    _case_env(name, monkeypatch)
    args = _case(name, rng)
    got = _port_plain(*args)
    for ref in (_tac_scan(*args), _tac_kernel(*args)):
        for g, r, what in zip(got, ref, NAMES):
            np.testing.assert_array_equal(g, r, err_msg=f"{name}: {what}")
    tid = got[1]
    if name == "two_sets_ties":
        # raw wins its tie with set 1, set 1 its tie with set 2
        assert tid[0, 0] != 1 and tid[1, 1] != 2 and tid[2, 2] == 2
    if name == "three_sets":
        assert tid[3, 0] != 3 and tid[4, 1] == 3
    # the wrapper runs the plain version for CPU tensors, counting no launch
    before = tk3.vbr_reservoir_scan.launches
    smr, bh, nl, res0, base, cap = args
    wrapped = tk3.vbr_reservoir_scan(
        tba.snap_smr(torch.tensor(smr)), torch.tensor(bh), torch.tensor(nl),
        torch.tensor(res0), base=base, cap=cap)
    assert tk3.vbr_reservoir_scan.launches == before
    for g, w_ in zip(got, wrapped):
        np.testing.assert_array_equal(g, w_.numpy())


def test_plain_k3_resumes_mid_stream(rng):
    """A chain split at frame 4 with the carried fills equals the unsplit
    chain (the streaming resume contract), and the unsplit chain equals
    tac's two forms."""
    smr, bh, nl = _inputs(rng, 7, 3)
    res0 = np.zeros(3, np.int32)
    full = _port_plain(smr, bh, nl, res0, 700, 2800)
    head = _port_plain(smr[:4], bh[:4], nl, res0, 700, 2800)
    assert head[3][-1].any(), "the carried fills are all zero"
    tail = _port_plain(smr[4:], bh[4:], nl, head[3][-1], 700, 2800)
    for f_, h, t, what in zip(full, head, tail, NAMES):
        np.testing.assert_array_equal(f_, np.concatenate([h, t]), err_msg=what)
    for ref in (_tac_scan(smr, bh, nl, res0, 700, 2800),
                _tac_kernel(smr, bh, nl, res0, 700, 2800)):
        for f_, r, what in zip(full, ref, NAMES):
            np.testing.assert_array_equal(f_, r, err_msg=what)


def test_vbr_price_equals_tac(rng):
    """The pricing alone, on allocations of every class (0, codable, 9+)."""
    alloc = rng.choice([0, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16], (5, B)).astype(np.int32)
    _, bh, _ = _inputs(rng, 1, 5, n_sets=3)
    raw, hufs = jc._vbr_price(jnp.asarray(alloc), jnp.asarray(bh[0]),
                              jnp.asarray(NL))
    got_raw, got_hufs = tk3.vbr_price(torch.tensor(alloc), torch.tensor(bh[0]),
                                      torch.tensor(NL))
    np.testing.assert_array_equal(got_raw.numpy(), np.asarray(raw))
    np.testing.assert_array_equal(got_hufs.numpy(), np.asarray(hufs))


def test_reservoir_chain_parity_and_uniform(rng):
    """codec._reservoir_chain as the encoder calls it: parity precision
    keeps f64 SMRs through the plain loop, and alloc_mode="uniform" zeroes
    them, both as tac's chain does."""
    smr, bh, nl = _inputs(rng, 4, 2, n_sets=2)
    smr = smr.astype(np.float64) + rng.normal(0, 1e-9, smr.shape)
    res0 = np.zeros(2, np.int32)
    for change in ({"precision": "parity"}, {"alloc_mode": "uniform"}):
        out = tc._reservoir_chain(
            torch.tensor(smr), torch.tensor(bh), torch.tensor(nl),
            torch.tensor(res0), 700, 2800, TPRESETS["vbr-huffman"].replace(**change))
        ref = tac_chain(
            jnp.asarray(smr), jnp.asarray(bh), jnp.asarray(nl), jnp.asarray(res0),
            700, 2800, JPRESETS["vbr-huffman"].replace(**change))
        for g, r, what in zip(out, ref, NAMES):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f"{change}: {what}")


@pytest.mark.parametrize("rounds,n_bisect", [(2, 20), (0, 0)])
def test_plain_k3_warm_start_setting_is_decision_exact(rng, monkeypatch,
                                                       rounds, n_bisect):
    """The chain's integers are the same with K3's warm start (1 × 12, tac's
    K3 setting), 2 × 20 (tac's K1 setting) and a cold start, on the random,
    per-frame n_lines, joint 50-band and FMA-row chains: the kernel relies
    on tac's claim that the setting is decision-exact. The trip counter
    shows the setting really changed the walk."""
    fma = (np.array([[[22.924339294433594, 89.14434051513672]]], np.float32),
           np.zeros((1, 1, 2, 7), np.int32), np.array([1, 2], np.int32),
           np.zeros(1, np.int32), 24, 96)
    cases = [_case(n, rng) for n in ("random_7x3", "per_frame_n_lines",
                                     "joint_50_bands")] + [fma]
    trips = {}
    for setting in ((tk3.WARM_ROUNDS, tk3.WARM_BISECT), (rounds, n_bisect)):
        monkeypatch.setattr(tk3, "WARM_ROUNDS", setting[0])
        monkeypatch.setattr(tk3, "WARM_BISECT", setting[1])
        t0 = tk1.water_fill_rows_plain.trips
        trips[setting] = [_port_plain(*c) for c in cases]
        trips[setting].append(tk1.water_fill_rows_plain.trips - t0)
    (ref, ref_trips), (got, got_trips) = (
        (v[:-1], v[-1]) for v in trips.values())
    for i, (r, g) in enumerate(zip(ref, got)):
        for rr, gg, what in zip(r, g, NAMES):
            np.testing.assert_array_equal(gg, rr, err_msg=f"case {i}: {what}")
    np.testing.assert_array_equal(got[-1][0], [[[2, 11]]])
    assert got_trips != ref_trips
