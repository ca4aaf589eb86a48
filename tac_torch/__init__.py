"""tac_torch — the tac perceptual audio codec in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``tac`` (which stays the reference): fixed-rate
L/R coding of the PAC-T format, with hand-written CUDA kernels for the
bit allocation (K1) and the bit packing (K2). Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""

import torch

# Full float32 matmuls: with TF32 the psy DFT matmuls would keep about three
# digits and move SMRs across the 1/16-dB decision grid.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from tac_torch.api import decode_array, encode_array  # noqa: E402
from tac_torch.config import PRESETS, CodecConfig  # noqa: E402

__all__ = ["CodecConfig", "PRESETS", "decode_array", "encode_array"]
