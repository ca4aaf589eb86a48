"""The filterbank path: PCM → MDCT lines → PCM, with no codec in between
(counterpart of the path tools/bench_pallas_mdct.py times in the JAX
package, closed by the inverse transform).

Analysis is kernel K5 (framing and the window-fused MDCT product in one
pass over the signal); synthesis is the window-fused IMDCT product and the
overlap-add. Both use the fast path's f32 bases of the config; the round
trip reconstructs the signal to f32 rounding (TDAC).
"""

from __future__ import annotations

import torch

from tac_torch import codec
from tac_torch.config import CodecConfig, resolve_device
from tac_torch.dsp import mdct as fb
from tac_torch.ops.mdct_fused import mdct_frames_fused


def _fast_consts(cfg: CodecConfig, dev):
    # the bases alone: no psy or Huffman tables to build and upload
    return codec.make_consts(cfg.replace(precision="fast", use_psy=False,
                                         use_huffman=False), dev)


def mdct_analysis(x, cfg: CodecConfig, device=None) -> torch.Tensor:
    """x: float [..., T] PCM → f32 MDCT lines [..., F, H] under the config's
    window, on `device` (CUDA unless named)."""
    dev = resolve_device(device)
    c = _fast_consts(cfg, dev)
    xt = torch.as_tensor(x).to(dev).to(torch.float32)
    return mdct_frames_fused(xt, cfg.n_mdct_lines, c.fwd_basis)


def mdct_synthesis(lines, cfg: CodecConfig, t: int, device=None) -> torch.Tensor:
    """f32 MDCT lines [..., F, H] → [..., T] PCM: windowed IMDCT of every
    frame, then overlap-add."""
    dev = resolve_device(device)
    c = _fast_consts(cfg, dev)
    y = torch.as_tensor(lines).to(dev).to(torch.float32) @ c.inv_basis
    return fb.overlap_add(y, cfg.n_mdct_lines, t)
