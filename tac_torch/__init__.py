"""tac_torch — the tac perceptual audio codec in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``tac`` (which stays the reference): every
stream family of the PAC-T format — fixed-rate and Huffman VBR, with and
without block switching, L/R or mid/side — and the bare MDCT filterbank,
with hand-written CUDA kernels for the bit allocation (K1), the bit
packing (K2), the VBR bit-reservoir chain (K3), the Huffman decode walk
(K4) and the fused framing + MDCT (K5); streaming encode and decode with
serializable state, and sample-accurate random access. Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""

import torch

# Full float32 matmuls: with TF32 the psy DFT matmuls would keep about three
# digits and move SMRs across the 1/16-dB decision grid.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from tac_torch.api import decode_array, decode_range, encode_array  # noqa: E402
from tac_torch.config import PRESETS, CodecConfig  # noqa: E402
from tac_torch.streaming import (StreamDecoder, StreamEncoder,  # noqa: E402
                                 StreamState)

__all__ = ["CodecConfig", "PRESETS", "StreamDecoder", "StreamEncoder",
           "StreamState", "decode_array", "decode_range", "encode_array"]
