"""PyTorch port vs tac: the Huffman tables and the encode-side field build
(tac_torch/huffman.py, codec.vbr_mantissa_pairs / payload_fields_vbr). All
integers, all exactly equal."""

import filecmp
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tac import codec as jc
from tac import huffman as jh
from tac.config import PRESETS as JPRESETS
from tac_torch import codec as tc
from tac_torch import consts as tconsts
from tac_torch import huffman as th
from tac_torch.config import PRESETS as TPRESETS

CPU = torch.device("cpu")
SETS = [1, 2, 3]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tac_tables(sid: int) -> dict:
    """tac's own arrays for one table set, in the port's HUFF_LEAVES form."""
    codes, lens, escaped = jh._enc_arrays(sid)
    return {"cost": jh.cost_table_np(sid), "enc_code": codes, "enc_len": lens,
            "enc_esc": escaped, "dec_pak": jc._packed_dec_luts(sid)[0]}


def _random_lines(seed, rows=6, h=1024):
    """Mantissas with every size class: m ∈ {0, 1}, [2, 8] and [9, 16]."""
    rng = np.random.default_rng(seed)
    m_line = rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16], (rows, h))
    mant = rng.integers(0, 1 << 16, (rows, h)) & ((1 << m_line) - 1)
    # small magnitudes too, so short codewords and escapes both occur
    small = rng.random((rows, h)) < 0.5
    mant = np.where(small, mant & 3, mant)
    return mant.astype(np.int32), m_line.astype(np.int32)


@pytest.mark.parametrize("sid", SETS)
def test_table_files_equal_tac(sid):
    assert th.n_sets() == jh.n_sets() == 3
    assert filecmp.cmp(th.SET_PATHS[sid], jh.SET_PATHS[sid], shallow=False)
    assert os.path.dirname(th.SET_PATHS[sid]) != os.path.dirname(jh.SET_PATHS[sid])


@pytest.mark.parametrize("sid", SETS)
def test_table_constants_equal_tac(sid):
    """cost table, encode arrays, packed decode LUT; the compact peek LUT
    against tac's per-m LUTs; and tac's arrays uploaded by device_tables
    equal the port's own, leaf by leaf."""
    want = tac_tables(sid)
    got = th.host_tables(sid)
    assert set(got) == set(th.HUFF_LEAVES)
    for k in th.HUFF_LEAVES:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert th._dec_luts(sid).keys() == jh._dec_luts(sid).keys()

    # the compact peek LUT: each table at its own width, tac's per-m LUTs
    lut, tab = th.compact_dec_lut(got["dec_pak"])
    for m, (sym_lut, len_lut, width, esc) in jh._dec_luts(sid).items():
        off = int(tab[m - 2]) >> 5
        assert int(tab[m - 2]) & 31 == width
        entries = lut[off:off + (1 << width)].astype(np.int64)
        np.testing.assert_array_equal(entries >> 9, len_lut)
        np.testing.assert_array_equal(entries & 511, sym_lut)
        assert esc == 1 << m

    own = tc.make_consts(TPRESETS["vbr-huffman"], CPU).huff[sid - 1]
    fed = th.device_tables(want, CPU)
    for k in own._fields:
        a, b = getattr(own, k), getattr(fed, k)
        if isinstance(a, int):
            assert a == b, k
        else:
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)


def test_consts_carry_every_set_only_for_huffman_configs():
    assert tc.make_consts(TPRESETS["stereo44-128"], CPU).huff is None
    arrays = tconsts.host_arrays(TPRESETS["vbr-huffman"])
    assert len(arrays["huffman"]) == 3
    with pytest.raises(ValueError, match="not constant"):
        bad = np.array(arrays["huffman"][0]["dec_pak"])
        bad[0, 0] = bad[0, -1]                     # splits a codeword's block
        th.compact_dec_lut(bad)


@pytest.mark.parametrize("sid", SETS)
def test_encode_fields_device_equals_tac(sid):
    mant, m_line = _random_lines(sid)
    want_v, want_w = jax.jit(lambda a, b: jh.encode_fields_device(a, b, sid))(
        jnp.asarray(mant), jnp.asarray(m_line))
    hc = tc.make_consts(TPRESETS["vbr-huffman"], CPU).huff[sid - 1]
    got_v, got_w = th.encode_fields_device(torch.tensor(mant),
                                           torch.tensor(m_line), hc)
    assert got_v.dtype == got_w.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    host_v, host_w = jh.encode_fields(mant, m_line, sid)   # numpy serializer
    np.testing.assert_array_equal(got_v.numpy(), host_v)
    np.testing.assert_array_equal(got_w.numpy(), host_w)
    # escape fields occur exactly where the set leaves symbols uncoded
    assert (got_w.numpy()[..., 1] > 0).any() == jh._enc_arrays(sid)[2].any()
    assert jh._enc_arrays(3)[2].any()


@pytest.mark.parametrize("n_sets", SETS)
def test_vbr_pairs_and_payload_fields_equal_tac(n_sets):
    """vbr_mantissa_pairs and payload_fields_vbr for huffman_sets 1..3, rows
    carrying every tid the setting allows."""
    rows = 6
    rng = np.random.default_rng(10 + n_sets)
    jcfg = JPRESETS["vbr-huffman"].replace(huffman_sets=n_sets)
    tcfg = TPRESETS["vbr-huffman"].replace(huffman_sets=n_sets)
    jcons, tcons = jc.make_consts(jcfg), tc.make_consts(tcfg, CPU)
    alloc = rng.choice([0, 2, 3, 5, 8, 9, 16], (rows, 25)).astype(np.int32)
    alloc[:, np.asarray(jcons.n_lines) == 0] = 0
    m_line = alloc[:, np.asarray(jcons.band_of_line)]
    mant = (rng.integers(0, 1 << 16, m_line.shape)
            & ((1 << m_line) - 1)).astype(np.int32)
    mant = np.where(rng.random(m_line.shape) < 0.5, mant & 3, mant)
    tid = (np.arange(rows) % (n_sets + 1)).astype(np.int32)
    code = {"ovs": rng.integers(0, 16, rows).astype(np.int32),
            "alloc_code": np.where(alloc > 0, alloc - 1, 0).astype(np.int32),
            "scale": np.where(alloc > 0, rng.integers(0, 16, alloc.shape),
                              0).astype(np.int32),
            "mant": mant}

    want = jax.jit(lambda a, b, t: jc.vbr_mantissa_pairs(a, b, t, n_sets))(
        jnp.asarray(mant), jnp.asarray(m_line), jnp.asarray(tid))
    got = tc.vbr_mantissa_pairs(torch.tensor(mant), torch.tensor(m_line),
                                torch.tensor(tid), tcons.huff, n_sets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    jcode = jc.FrameCode(**{k: jnp.asarray(v) for k, v in code.items()})
    tcode = tc.FrameCode(**{k: torch.tensor(v) for k, v in code.items()})
    want = jax.jit(lambda c_, t: jc.payload_fields_vbr(c_, t, jcfg, jcons))(
        jcode, jnp.asarray(tid))
    got = tc.payload_fields_vbr(tcode, torch.tensor(tid), tcfg, tcons)
    assert got[0].shape == (rows, 2 + 2 * 25 + 2 * 1024)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tc.payload_capacity_bits(tcfg, tcons) == \
        jc.payload_capacity_bits(jcfg, jcons) == 6638
