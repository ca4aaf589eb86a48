"""PyTorch port vs tac: bit allocation (tac_torch/bitalloc.py) and the plain
version of kernel K1 (tac_torch/ops/alloc.py), on every case of
tests/test_pallas_alloc.py. tac's side runs as its own tests run it: the
XLA vmap(water_fill) loop and the Pallas kernel in interpret mode.
Allocations are integers: every comparison is exact."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tac import bands
from tac import bitalloc as jba
from tac.ops.pallas_alloc import water_fill_rows as jax_water_fill_rows
from tac_torch import bitalloc as tba
from tac_torch.ops import alloc as tk1

NL = bands.lines_per_band(44100, 1024)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port(smr_q, nl, budget, max_mant=16):
    r = smr_q.shape[0]
    return tk1.water_fill_rows(
        torch.tensor(smr_q, dtype=torch.float32),
        torch.as_tensor(nl, dtype=torch.int32),
        torch.full((r,), budget, dtype=torch.int32), max_mant=max_mant).numpy()


@functools.partial(jax.jit, static_argnames="max_mant")
def _tac_rows(smr_q, nl, budget, max_mant):
    return jax.vmap(lambda s: jba.water_fill(s, nl, budget, max_mant))(smr_q)


def _tac(smr_q, nl, budget, max_mant=16):
    """tac's vmap(water_fill), rows padded to 64 and the budget traced, so
    the cases share one XLA compile."""
    r = smr_q.shape[0]
    pad = np.zeros((max(64, r), smr_q.shape[1]), np.float32)
    pad[:r] = smr_q
    return np.asarray(_tac_rows(jnp.asarray(pad), jnp.asarray(nl, jnp.int32),
                                jnp.int32(budget), max_mant))[:r]


def _snap(smr):
    return np.asarray(jba.snap_smr(jnp.asarray(smr, jnp.float32)))


def test_snap_and_codes_match_tac(rng):
    """snap_smr rounds half to even like jnp.round; alloc code maps agree."""
    smr = np.concatenate([rng.normal(0, 40, 500),
                          (np.arange(-40, 40) + 0.5) / 16]).astype(np.float32)
    np.testing.assert_array_equal(
        tba.snap_smr(torch.from_numpy(smr)).numpy(), _snap(smr))
    a = np.array([0, 2, 3, 9, 16], np.int32)
    np.testing.assert_array_equal(
        tba.alloc_to_code(torch.from_numpy(a)).numpy(),
        np.asarray(jba.alloc_to_code(jnp.asarray(a))))
    c = np.arange(16, dtype=np.int32)
    np.testing.assert_array_equal(
        tba.code_to_alloc(torch.from_numpy(c)).numpy(),
        np.asarray(jba.code_to_alloc(jnp.asarray(c))))


def test_plain_k1_random(rng):
    smr_q = _snap(rng.normal(10, 25, (64, len(NL))))
    np.testing.assert_array_equal(_port(smr_q, NL, 1282), _tac(smr_q, NL, 1282))


@pytest.mark.parametrize("budget", [0, 5, 12, 600, 5000])
def test_plain_k1_budgets(rng, budget):
    smr_q = _snap(rng.normal(0, 30, (16, len(NL))))
    np.testing.assert_array_equal(_port(smr_q, NL, budget),
                                  _tac(smr_q, NL, budget))


def test_plain_k1_ties_and_extremes():
    rows = np.stack([
        np.zeros(len(NL), np.float32),               # all ties
        np.full(len(NL), 90.0, np.float32),          # everything wants bits
        np.full(len(NL), -90.0, np.float32),         # nothing does
        np.r_[np.full(5, 50.0), np.full(len(NL) - 5, -50.0)].astype(
            np.float32),                             # concentrated
    ])
    np.testing.assert_array_equal(_port(rows, NL, 1282), _tac(rows, NL, 1282))


def test_plain_k1_row_padding_inert(rng):
    """Row counts that fill no tile (3 rows) allocate identically, and the
    tac Pallas kernel (interpret mode, in-kernel warm start) agrees."""
    smr_q = _snap(rng.normal(10, 20, (3, len(NL))))
    got = _port(smr_q, NL, 1282)
    np.testing.assert_array_equal(got, _tac(smr_q, NL, 1282))
    pallas = jax_water_fill_rows(
        jnp.asarray(smr_q), jnp.asarray(NL), jnp.zeros(smr_q.shape, jnp.int32),
        jnp.full((3,), 1282, jnp.int32), max_mant=16, nb=len(NL),
        interpret=True, warm=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_plain_k1_equals_oracle(rng):
    """End to end vs the serial oracle allocator (the reference contract)."""
    from tac.oracle.bitalloc import BitAlloc

    smr_q = _snap(rng.normal(8, 22, (12, len(NL))))
    got = _port(smr_q, NL, 1282)
    for i in range(len(smr_q)):
        want = BitAlloc(1282, 16, len(NL), np.asarray(NL),
                        smr_q[i].astype(np.float64))
        np.testing.assert_array_equal(got[i], want, err_msg=str(i))


def test_plain_k1_joint_ms_bands(rng):
    """The M/S joint shape (SPEC.md §11): 2B = 50 bands over a doubled
    budget, vs tac's allocate chain."""
    nl2 = np.concatenate([NL, NL])
    smr = rng.normal(10, 25, (16, len(nl2))).astype(np.float32)
    want = np.asarray(jax.vmap(lambda s: jba.allocate(
        s, jnp.asarray(nl2), 2 * 1282, "greedy", 16))(jnp.asarray(smr)))
    np.testing.assert_array_equal(_port(_snap(smr), nl2, 2 * 1282), want)


def test_plain_k1_warm_start_matches_external(rng):
    """The in-kernel warm start (2 × 20 bisection) lands where tac's
    externally warm-started Pallas kernel (XLA 2 × 32 bisection, interpret
    mode) finishes: the warm start is exact at any converged level."""
    smr_q = _snap(rng.normal(10, 25, (32, len(NL))))
    a0, r0 = jax.vmap(lambda s: jba._warm_start(s, NL, 1282, 16))(
        jnp.asarray(smr_q))
    ext = jax_water_fill_rows(jnp.asarray(smr_q), jnp.asarray(NL), a0, r0,
                              max_mant=16, nb=len(NL), interpret=True)
    np.testing.assert_array_equal(_port(smr_q, NL, 1282), np.asarray(ext))


def test_plain_k1_per_row_n_lines_and_max_mant(rng):
    """Per-row n_lines (zeros = absent bands) and a lower max_mant."""
    nl = rng.integers(0, 60, (24, len(NL))).astype(np.int32)
    smr_q = _snap(rng.normal(10, 25, (24, len(NL))))
    budgets = torch.full((24,), 700, dtype=torch.int32)
    got = tk1.water_fill_rows(torch.from_numpy(smr_q), torch.from_numpy(nl),
                              budgets, max_mant=9).numpy()
    want = np.asarray(jax.vmap(lambda s, n: jba.water_fill(s, n, 700, 9))(
        jnp.asarray(smr_q), jnp.asarray(nl)))
    np.testing.assert_array_equal(got, want)


def test_plain_k1_fma_row():
    """A row where a fused multiply-add flips a decision: band 1 takes 11
    bits, then fl(s1 - DEC[11]) == s0 exactly (a tie that band 0 wins),
    while fl(s1 - 6.02f*11) with one rounding is an ulp above s0. The
    unfused chain (tac's) gives [2, 11]; a contracted one gives [0, 12]."""
    s = np.array([[22.924339294433594, 89.14434051513672]], np.float32)
    dec = jba.DEC_TABLE.astype(np.float32)
    assert np.float32(s[0, 1] - dec[11]) == s[0, 0]
    fused = np.float32(np.float64(s[0, 1]) - np.float64(np.float32(6.02)) * 11)
    assert fused > s[0, 0]
    got = _port(s, [1, 2], 24)
    np.testing.assert_array_equal(got, [[2, 11]])
    np.testing.assert_array_equal(got, _tac(s, [1, 2], 24))


@pytest.mark.parametrize("mode", ["greedy", "uniform", "const_snr"])
def test_allocate_f64_matches_tac(rng, mode):
    """bitalloc.allocate (the parity path, f64) equals tac's allocate."""
    smr = rng.normal(5, 30, (10, len(NL)))
    want = np.asarray(jax.vmap(lambda s: jba.allocate(
        s, jnp.asarray(NL), 1282, mode, 16))(jnp.asarray(smr)))
    got = tba.allocate(torch.from_numpy(smr), torch.from_numpy(NL), 1282,
                       mode).numpy()
    np.testing.assert_array_equal(got, want)


def test_k1_wrapper_rejects_bad_input():
    smr = torch.zeros((2, 129))
    with pytest.raises(ValueError):
        tk1.water_fill_rows(smr.to("meta"), torch.zeros(129, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32))
