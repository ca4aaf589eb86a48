"""The stream family (tac_torch/family.py): each preset maps to the family
its flags name, and the single clip encoder packs it at that family's
payload width."""

import numpy as np
import pytest
import torch

from tac_torch import blockswitch as tb
from tac_torch import codec as tc
from tac_torch import family as tf
from tac_torch.config import PRESETS
from tac_torch.dsp.mdct import num_frames

# (use_block_switch, use_huffman) → the constants, frame decoder and
# capacity its family must use
CODERS = {
    (False, False): (tc.make_consts, tc.decode_frames_packed,
                     tc.payload_capacity_bits),
    (False, True): (tc.make_consts, tc.decode_frames_vbr,
                    tc.payload_capacity_bits),
    (True, False): (tb.make_bs_consts, tb.decode_frames_bs,
                    tb.capacity_bits_bs),
    (True, True): (tb.make_bs_consts, tb.decode_frames_bs_vbr,
                   tb.capacity_bits_bs_vbr),
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_encodes_at_its_family_width(preset):
    """A 0.25-s clip of every preset: the family's record is its flags',
    and the words of the single encoder are payload_words(cfg) wide, with
    every row's bits inside them."""
    cfg = PRESETS[preset]
    flags = (cfg.use_block_switch, cfg.use_huffman)
    fam = tf.of(cfg)
    assert (fam.make_consts, fam.decode_frames,
            fam.capacity_bits) == CODERS[flags]
    assert (fam.switching, fam.reservoir) == flags
    rng = np.random.default_rng(len(preset))
    x = 0.1 * rng.standard_normal((cfg.n_channels, cfg.sample_rate // 4))
    words, nbits = tf.encode_clip_packed(x, cfg, device="cpu")
    f = num_frames(x.shape[1], cfg.n_mdct_lines)
    assert words.dtype == torch.int32
    assert words.shape == (cfg.n_channels, f, tf.payload_words(cfg))
    assert nbits.shape == (cfg.n_channels, f)
    assert 0 < int(nbits.min()) and int(nbits.max()) <= 32 * words.shape[-1]
