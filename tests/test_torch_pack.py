"""PyTorch port vs tac: bit packing and unpacking (tac_torch/ops/bitpack.py,
bitunpack.py) and the plain version of kernel K2 (tac_torch/ops/pack.py).
tac's side runs as its own tests run it: the XLA compare-reduce in
pack_rows and the Pallas kernel in interpret mode. Words and bytes are
integers: every comparison is exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tac import bitstream as jbs
from tac.ops import bitpack as jbp
from tac.ops import bitunpack as jbu
from tac.ops.pallas_pack import scatter_words_rows as jax_scatter_words_rows
from tac_torch import bitstream as tbs
from tac_torch.ops import bitpack as tbp
from tac_torch.ops import bitunpack as tbu
from tac_torch.ops import pack as tk2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fields(rng, r, nf, sparse=0.5):
    wids = rng.integers(0, 17, (r, nf))
    wids[rng.random((r, nf)) < sparse] = 0
    vals = rng.integers(0, 1 << 16, (r, nf)) & ((1 << np.maximum(wids, 1)) - 1)
    vals[wids == 0] = 0
    return vals.astype(np.int32), wids.astype(np.int32)


@pytest.mark.parametrize("shape,interpret", [((3, 7, 64), True),
                                          ((64, 1075, 1518), True),
                                          ((40, 300, 587), True),
                                          ((16, 40, 6638), False)])
def test_plain_k2_matches_tac(shape, interpret):
    """K2's plain version (through pack_rows) == tac's pack_rows reduce and
    tac's Pallas kernel (interpret mode), word for word, across the stream
    families' (NF, capacity) shapes — including a capacity smaller than the
    fields, where both drop the overflow. (At W32 = 208 the interpreted
    Pallas kernel alone takes ~40 s to trace; that shape is held against
    the reduce only.)"""
    r, nf, cap = shape
    rng = np.random.default_rng(r + nf)
    vals, wids = _fields(rng, r, nf)
    w32 = -(-cap // 32)
    want, want_n = jax.jit(jbp.pack_rows, static_argnums=2)(
        jnp.asarray(vals), jnp.asarray(wids), cap)
    got, got_n = tbp.pack_rows(torch.from_numpy(vals), torch.from_numpy(wids), cap)
    assert got.dtype == torch.int32 and got.shape == (r, w32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    if not interpret:
        return
    c0, c1, word0, _ = tbp.field_words(torch.from_numpy(vals),
                                       torch.from_numpy(wids))
    kernel = jax_scatter_words_rows(
        jnp.asarray(c0.numpy().view(np.uint32)),
        jnp.asarray(c1.numpy().view(np.uint32)), jnp.asarray(word0.numpy()),
        w32=w32, interpret=True)
    np.testing.assert_array_equal(
        tk2.scatter_words_rows(c0, c1, word0, w32=w32).numpy().view(np.uint32),
        np.asarray(kernel))


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_rows_matches_host_packer(seed):
    """Packed rows → bytes equal tac's host packer (tac.bitstream)."""
    rng = np.random.default_rng(seed)
    vals, wids = _fields(rng, 10, 200, sparse=0.0)
    words, nbits = tbp.pack_rows(torch.from_numpy(vals), torch.from_numpy(wids),
                                 int(wids.sum(1).max()) + 32)
    w = words.numpy().view(np.uint32)
    stream = tbp.rows_to_stream(w, nbits.numpy())
    assert stream == jbp.rows_to_stream(w, nbits.numpy())
    offs, lens = tbs.split_blocks(stream, 0, 10)
    for i in range(10):
        expect = jbs.pack_fields(vals[i].astype(np.uint64), wids[i])
        assert nbits[i] == wids[i].sum()
        assert stream[offs[i]:offs[i] + lens[i]] == expect.tobytes()


def test_read_fields_and_stream_rows_match_tac(rng):
    """read_fields (gathers) == tac's select-accumulate, including offsets
    past the row (read as 0); stream_to_rows / split_blocks equal tac's."""
    vals, wids = _fields(rng, 12, 300)
    cap = int(wids.sum(1).max()) + 32
    words, nbits = tbp.pack_rows(torch.from_numpy(vals), torch.from_numpy(wids), cap)
    w = words.numpy().view(np.uint32)
    stream = b"hdr" + tbp.rows_to_stream(w, nbits.numpy())
    offs, lens = tbs.split_blocks(stream, 3, 12)
    from tac import native
    j_offs, j_lens = native.split_blocks(stream, 3, 12)
    np.testing.assert_array_equal(offs, j_offs)
    np.testing.assert_array_equal(lens, j_lens)
    rows = tbp.stream_to_rows(stream, offs, lens, w.shape[1])
    np.testing.assert_array_equal(rows, jbp.stream_to_rows(stream, offs, lens,
                                                           w.shape[1]))
    end = np.cumsum(wids, 1)
    off = end - wids
    off[:, -5:] = 32 * w.shape[1] + np.arange(5)        # past the row
    got = tbu.read_fields(torch.from_numpy(rows.view(np.int32)),
                          torch.from_numpy(off), torch.from_numpy(wids)).numpy()
    want = np.asarray(jbu.read_fields(jnp.asarray(rows), jnp.asarray(off),
                                      jnp.asarray(wids)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :-5], vals[:, :-5])


def test_framing_errors_are_typed():
    with pytest.raises(tbs.CorruptStreamError):
        tbs.split_blocks(b"\x05\x00ab", 0, 1)           # payload past the end
    with pytest.raises(tbs.CorruptStreamError):
        tbp.stream_to_rows(b"\x00" * 400, np.array([2]), np.array([300]), 8)
    with pytest.raises(ValueError):
        tbp.rows_to_stream(np.zeros((1, 2), np.uint32), np.array([65]))


def test_k2_word_buffer_covers_every_preset():
    """K2 keeps a row's words in shared memory (MAX_WORDS of them): every
    preset's row capacity fits, the mid/side VBR rows (doubled budget with
    a full reservoir, W32 408) included, as do the 4-channel pairwise
    streams at twice the stereo bitrate."""
    from tac_torch import blockswitch as tb
    from tac_torch import codec as tc
    from tac_torch.config import PRESETS

    widest = 0
    for cfg in PRESETS.values():
        if cfg.use_block_switch:
            cap = (tb.capacity_bits_bs_vbr(cfg) if cfg.use_huffman
                   else tb.capacity_bits_bs(cfg))
        else:
            cap = tc.payload_capacity_bits(cfg)
        widest = max(widest, -(-cap // 32))
    assert widest == -(-tc.payload_capacity_bits(PRESETS["vbr-ms"]) // 32) == 408
    assert widest <= tk2.MAX_WORDS
