"""PyTorch port vs tac: the canonical-Huffman decode walk (kernel K4's plain
version, tac_torch/ops/huffdec.py) against tac's lax.scan LUT walk
(codec._huffman_decode_scan) and its Pallas kernel in interpret mode, on
the same payload words: the real streams of tests/test_pallas_huffdec.py
(sets 1 and 2), forced set-3 rows, random bits under every set, a table
with an uncovered peek (the ln == 0 stall) and walks that run past the
payload. Then the multi-set entry that a decode calls (each row with its
own tableId's set), the compact peek LUT the kernel holds in shared memory
(huffman.compact_dec_lut) and a NumPy emulation of the kernel's step (the
64-bit bit buffer, the one-load lookup and the branch-free line), against
the plain walk. Decoded mantissas are integers and must be equal."""

import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tac import codec as jc
from tac import huffman as jh
from tac.config import PRESETS as JPRESETS
from tac.ops.pallas_huffdec import huffman_decode_rows as pallas_decode
from tac_torch import codec as tc
from tac_torch import family as tf
from tac_torch import huffman as th
from tac_torch.config import PRESETS as TPRESETS
from tac_torch.ops import huffdec as tk4
from tac_torch.ops.bitpack import pack_rows

CPU = torch.device("cpu")
JCFG, TCFG = JPRESETS["vbr-huffman"], TPRESETS["vbr-huffman"]
# tac's lax.scan walk jitted, as its decoders run it (eager, each op around
# the scan dispatches and compiles on its own)
tac_scan = jax.jit(jc._huffman_decode_scan, static_argnames="set_id")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _walk_inputs(words_i32: np.ndarray, cfg):
    """(tid, mant_start, m_line) of VBR payload rows (the head layout of
    SPEC.md §7, read by the port)."""
    _, tid, _, _, m_line, mant_start = tc._vbr_head(
        torch.from_numpy(words_i32), cfg, tc.make_consts(cfg, CPU))
    return tid.numpy(), mant_start.numpy(), m_line.numpy()


def _three_ways(words_i32, mant_start, m_line, sid, hc=None):
    """(port plain, tac lax.scan walk, tac Pallas kernel interpreted)."""
    hc = hc or tc.make_consts(TCFG, CPU).huff[sid - 1]
    plain = tk4.huffman_decode_rows_plain(
        torch.from_numpy(words_i32), torch.from_numpy(mant_start),
        torch.from_numpy(m_line), hc)
    assert plain.dtype == torch.int32
    wj = jnp.asarray(words_i32.view(np.uint32))
    scan = tac_scan(wj, jnp.asarray(mant_start), jnp.asarray(m_line),
                    set_id=sid)
    kern = pallas_decode(wj, jnp.asarray(mant_start), jnp.asarray(m_line),
                         interpret=True, set_id=sid)
    return plain.numpy(), np.asarray(scan), np.asarray(kern)


def _to_longest_payload(words: np.ndarray, nbits) -> np.ndarray:
    """Rows [K, W32] cut after the words of their longest payload: only
    zero padding goes, so every walk inside its payload reads what it read
    before, and the three walks still get the same words (a smaller W32
    lowers the Pallas kernel faster in interpret mode)."""
    return np.ascontiguousarray(words[:, :-(-int(np.max(nbits)) // 32)])


@functools.lru_cache(maxsize=1)
def _castanet_rows():
    """Rows tac encoded from mono castanets: raw, set-1 and set-2 rows
    (words int32 [K, W32] up to the longest payload, the port's config)."""
    from tools.material import castanets

    x = castanets(JCFG.sample_rate, 0.6)[None, :]
    words, nbits = jc.encode_clip_vbr_packed(jnp.asarray(x, jnp.float32),
                                             JCFG.replace(n_channels=1))
    rows = np.array(words).reshape(-1, words.shape[-1]).view(np.int32)
    return _to_longest_payload(rows, nbits), TCFG.replace(n_channels=1)


def _sets_entry(w, mant_start, m_line, tid, tcfg):
    """The multi-set entry on the CPU (the plain version, no launch), with
    the raw reading the decode gives it."""
    c = tc.make_consts(tcfg, CPU)
    wt, ms = torch.from_numpy(w), torch.from_numpy(mant_start)
    ml = torch.from_numpy(m_line)
    raw = tc.read_raw_mantissas(wt, ms.long()[:, None], ml)
    before = tk4.huffman_decode_sets.launches
    got = tk4.huffman_decode_sets(wt, ms, ml, torch.from_numpy(tid),
                                  raw.clone(), c.huff)
    assert tk4.huffman_decode_sets.launches == before
    return got.numpy(), raw.numpy(), c.huff


@pytest.mark.parametrize("sid", [1, 2])
def test_plain_k4_on_tac_streams(sid):
    """Rows tac encoded from castanets, which carry set-1 and set-2 rows
    (and raw ones): the plain walk under set `sid` equals tac's scan on
    every row, and the Pallas kernel on the rows that carry the set (the
    others' walks are discarded garbage, which the Pallas kernel reads by
    another rule)."""
    w, tcfg = _castanet_rows()
    tid, mant_start, m_line = _walk_inputs(w, tcfg)
    here = tid == sid
    assert here.any(), f"the stream has no tid={sid} rows"
    plain, scan, kern = _three_ways(w, mant_start, m_line, sid)
    np.testing.assert_array_equal(plain, scan)
    np.testing.assert_array_equal(plain[here], kern[here])
    # the multi-set entry runs the plain version for CPU tensors, counting
    # no launch, and gives the set's rows this walk
    got, _, _ = _sets_entry(w, mant_start, m_line, tid, tcfg)
    np.testing.assert_array_equal(got[here], plain[here])


def test_plain_sets_entry_on_mixed_tac_rows():
    """tac's castanet rows carry tableIds 0, 1 and 2: the multi-set entry
    equals the per-set torch.where selection, tac's scan with each row's
    own set on the rows that carry it, and the raw reading on raw rows."""
    w, tcfg = _castanet_rows()
    tid, mant_start, m_line = _walk_inputs(w, tcfg)
    assert set(np.unique(tid)) == {0, 1, 2}
    got, raw, huff = _sets_entry(w, mant_start, m_line, tid, tcfg)
    want = torch.from_numpy(raw)
    for sid, hc in enumerate(huff, start=1):
        dec = tk4.huffman_decode_rows_plain(
            torch.from_numpy(w), torch.from_numpy(mant_start),
            torch.from_numpy(m_line), hc)
        want = torch.where(torch.from_numpy(tid == sid)[:, None], dec, want)
    np.testing.assert_array_equal(got, want.numpy())
    wj = jnp.asarray(w.view(np.uint32))
    for sid in (1, 2):
        here = tid == sid
        scan = tac_scan(wj, jnp.asarray(mant_start), jnp.asarray(m_line),
                        set_id=sid)
        np.testing.assert_array_equal(got[here], np.asarray(scan)[here])
    np.testing.assert_array_equal(got[tid == 0], raw[tid == 0])


def test_plain_k4_forced_set3_rows(rng):
    """Rows re-packed with tableId 3 on every frame: the walk gives back
    the mantissas that were packed, as tac's scan does."""
    fs = TCFG.sample_rate
    t = np.arange(int(fs * 0.2)) / fs
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t)
                  + 0.05 * rng.standard_normal(len(t)),
                  0.3 * np.sin(2 * np.pi * 3000 * t)])
    cfg = TCFG.replace(huffman_sets=3)
    c = tc.make_consts(cfg, CPU)
    words, _ = tf.encode_clip_packed(x, cfg, device="cpu")
    code = tc._unpack_vbr_fields(words.reshape(-1, words.shape[-1]), cfg, c)
    tid3 = torch.full(code.ovs.shape, 3, dtype=torch.int32)
    w3, nbits = pack_rows(*tc.payload_fields_vbr(code, tid3, cfg, c),
                          tc.payload_capacity_bits(cfg, c))
    assert int(nbits.max()) <= 32 * w3.shape[1]
    w3 = torch.from_numpy(_to_longest_payload(w3.numpy(), nbits.numpy()))
    tid, mant_start, m_line = _walk_inputs(w3.numpy(), cfg)
    assert (tid == 3).all()
    plain, scan, kern = _three_ways(w3.numpy(), mant_start, m_line, 3)
    np.testing.assert_array_equal(plain, code.mant.numpy())
    np.testing.assert_array_equal(plain, scan)
    np.testing.assert_array_equal(plain, kern)
    # and the whole unpack takes the set-3 walk
    back = tc._unpack_vbr_fields(w3, cfg, c)
    np.testing.assert_array_equal(back.mant.numpy(), code.mant.numpy())


def _random_rows(rng, k=48, h=128, w32=128):
    """Random payload bits and sizes of every class; a walk over h lines
    takes at most 29 bits a line, so it stays inside w32 = 128 words."""
    words = rng.integers(0, 1 << 32, (k, w32), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    m_line = rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 13, 16],
                        (k, h)).astype(np.int32)
    mant_start = rng.integers(0, 200, k).astype(np.int32)
    return words, mant_start, m_line


@pytest.mark.parametrize("sid", [1, 2, 3])
def test_plain_k4_random_bits(sid, rng):
    """Every table set on random bits: m outside [2, 8], escapes (set 3) and
    all code lengths, all three walks equal on every row."""
    words, mant_start, m_line = _random_rows(rng)
    plain, scan, kern = _three_ways(words, mant_start, m_line, sid)
    np.testing.assert_array_equal(plain, scan)
    np.testing.assert_array_equal(plain, kern)
    assert (plain[m_line == 0] == 0).all()


def test_plain_k4_stalls_on_uncovered_peek(rng, tmp_path, monkeypatch):
    """A table set whose m = 2 table lacks one codeword: a peek that no
    codeword covers gives length 0 and symbol 0, and the walk stalls in
    place, in the port as in tac's two walks."""
    with open(jh.SET_PATHS[1]) as f:
        raw = json.load(f)
    lens, codes = raw["2"]["lengths"], raw["2"]["codes"]
    # drop the highest of the longest codewords: the rest stay contiguous
    drop = max(range(len(lens)), key=lambda i: (lens[i], codes[i]))
    raw["2"]["lengths"][drop] = 0
    path = tmp_path / "incomplete.json"
    path.write_text(json.dumps(raw))
    monkeypatch.setitem(jh.SET_PATHS, 99, str(path))
    pak = jc._packed_dec_luts(99)[0]
    monkeypatch.delitem(jc._PACKED_DEC_LUTS_CACHE, 99)     # leave no trace
    assert (pak[0] == 0).any() and (pak[1:] != 0).all()
    codes, lens99, escaped = jh._enc_arrays(99)
    hc = th.device_tables({"cost": jh.cost_table_np(99), "enc_code": codes,
                           "enc_len": lens99, "enc_esc": escaped,
                           "dec_pak": pak}, CPU)

    words, mant_start, m_line = _random_rows(rng)
    plain, scan, kern = _three_ways(words, mant_start, m_line, 99, hc)
    np.testing.assert_array_equal(plain, scan)
    np.testing.assert_array_equal(plain, kern)
    # a row of m = 2 lines starting on the uncovered peek never moves
    lmax = pak.shape[1].bit_length() - 1
    peek = int(np.flatnonzero(pak[0] == 0)[0])
    row = np.full((1, 128), peek << (32 - lmax), np.uint32).view(np.int32)
    m2 = np.full((1, 128), 2, np.int32)
    stalled = tk4.huffman_decode_rows_plain(
        torch.from_numpy(row), torch.zeros(1, dtype=torch.int32),
        torch.from_numpy(m2), hc)
    assert (stalled == 0).all()
    m2[0, 5] = 9                                   # a raw field moves it on
    moved = tk4.huffman_decode_rows_plain(
        torch.from_numpy(row), torch.zeros(1, dtype=torch.int32),
        torch.from_numpy(m2), hc).numpy()
    assert (moved[0, :5] == 0).all() and moved[0, 5] == (peek << (32 - lmax)) >> 23


def test_plain_k4_past_the_payload_clips_like_tac(rng):
    """Walks that run off the row read words clipped to the last one, as
    tac's scan does (both word indices clip to W32 - 1)."""
    words, mant_start, m_line = _random_rows(rng, k=16, h=128, w32=6)
    mant_start[:4] = [150, 191, 192, 400]          # start near / past the end
    hc = tc.make_consts(TCFG, CPU).huff[0]
    plain = tk4.huffman_decode_rows_plain(
        torch.from_numpy(words), torch.from_numpy(mant_start),
        torch.from_numpy(m_line), hc).numpy()
    scan = tac_scan(jnp.asarray(words.view(np.uint32)),
                    jnp.asarray(mant_start), jnp.asarray(m_line))
    np.testing.assert_array_equal(plain, np.asarray(scan))


def _stall_pak():
    """Set 1's packed LUT with its m = 2 table's highest longest codeword
    dropped: its peeks are uncovered (length 0, symbol 0)."""
    pak = np.array(th.packed_dec_lut(1))
    lmax = pak.shape[1].bit_length() - 1
    pak[0, -(1 << (lmax - int((pak[0] >> 16).max()))):] = 0
    return pak


@pytest.mark.parametrize("which", ["set1", "set2", "set3", "stall"])
def test_compact_lut_gives_every_peek(which):
    """For every table and every lmax-bit peek p, the compact entry at
    off_t + (p >> (lmax - w_t)) holds the length and symbol of dec_pak[t][p];
    w_t is the table's own longest codeword."""
    pak = _stall_pak() if which == "stall" else th.packed_dec_lut(int(which[-1]))
    lut, tab = th.compact_dec_lut(pak)
    assert lut.dtype == np.int16 and lut.size % 8 == 0
    lmax = pak.shape[1].bit_length() - 1
    peek = np.arange(1 << lmax)
    for t in range(th.N_TAB):
        off, w = int(tab[t]) >> 5, int(tab[t]) & 31
        assert w == int((pak[t] >> 16).max())
        e = lut[off + (peek >> (lmax - w))].astype(np.int64)
        np.testing.assert_array_equal(e >> 9, pak[t] >> 16)
        np.testing.assert_array_equal(e & 511, pak[t] & 0xFFFF)
    if which == "stall":
        assert (lut[int(tab[0]) >> 5:][:1 << (int(tab[0]) & 31)] == 0).any()


def test_compact_lut_refuses_a_lut_that_is_not_block_constant():
    pak = np.array(th.packed_dec_lut(1))
    pak[0, 1] = pak[0, -1]             # inside the first codeword's block
    with pytest.raises(ValueError, match="not constant"):
        th.compact_dec_lut(pak)


def test_compact_luts_of_all_sets_fit_a_block():
    """The three trained sets' compact LUTs, which the kernel holds in one
    block's shared memory: 44 464 entries, under 89 KB."""
    sizes = [th.compact_dec_lut(th.packed_dec_lut(s))[0].nbytes
             for s in (1, 2, 3)]
    assert sum(sizes) <= 89_000
    widths = [[int(t) & 31 for t in th.compact_dec_lut(th.packed_dec_lut(s))[1]]
              for s in (1, 2, 3)]
    assert widths == [[4, 8, 9, 10, 11, 12, 13], [4, 7, 10, 10, 12, 12, 13],
                      [4, 8, 8, 10, 11, 11, 12]]


@pytest.mark.parametrize("case", ["mixed", "all_raw"])
def test_sets_entry_writes_into_the_raw_reading(case, rng):
    """The multi-set entry on the CPU keeps the kernel's contract: it
    writes each Huffman row's walk into mant_raw and returns that tensor;
    raw rows and rows whose tid names no loaded set keep their reading."""
    words, mant_start, m_line = _random_rows(rng, k=32, h=64)
    tid = (rng.choice([0, 1, 2, 3, 7], 32) if case == "mixed"
           else np.zeros(32)).astype(np.int32)
    huff = tuple(th.device_tables(th.host_tables(s), CPU) for s in (1, 2))
    raw = rng.integers(0, 1 << 16, m_line.shape).astype(np.int32)
    mant_raw = torch.from_numpy(raw.copy())
    args = [torch.from_numpy(a) for a in (words, mant_start, m_line)]
    got = tk4.huffman_decode_sets(*args, torch.from_numpy(tid), mant_raw, huff)
    assert got is mant_raw
    want = raw.copy()
    for sid, hc in enumerate(huff, start=1):
        here = tid == sid
        want[here] = tk4.huffman_decode_rows_plain(*args, hc).numpy()[here]
    np.testing.assert_array_equal(got.numpy(), want)
    keep = (tid < 1) | (tid > len(huff))
    np.testing.assert_array_equal(got.numpy()[keep], raw[keep])
