"""Codec configuration (counterpart of tac/config.py).

A frozen dataclass with the same fields, validation and presets as the
JAX package, plus the port's run-time policy: which configurations this
package codes (``check_supported``) and which device it runs on
(``resolve_device``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Static codec parameters (SPEC.md). Field names follow the spec."""

    sample_rate: int = 44100
    n_channels: int = 2
    bitrate_bps: int = 128_000          # total across channels

    # Filterbank
    n_mdct_lines: int = 1024            # H (long block); frame N = 2H
    window: str = "sine"                # sine | kbd | hann
    kbd_alpha: float = 4.0

    # Quantization
    n_scale_bits: int = 4               # S
    n_mant_size_bits: int = 4           # A (alloc-field width)
    max_mant_bits: int = 16

    # Psychoacoustics / allocation
    use_psy: bool = True
    alloc_mode: str = "greedy"          # greedy | uniform | const_snr | const_mnr
    psy_noise_maskers: bool = True
    max_maskers: int = 64
    delta_tonal_db: float = 16.0
    delta_noise_db: float = 6.0
    # "band" evaluates masking at the 2B band-edge Barks (SPEC §5) on the
    # fast fixed-rate L/R scope only; "line" is the reference model and is
    # what parity always uses; "band_all" forces the band model.
    psy_granularity: str = "band"

    # Entropy coding
    use_huffman: bool = False
    reservoir_factor: int = 4           # reservoir cap = factor * per-block budget
    huffman_sets: int = 2

    # Stereo coding (SPEC.md §11): "lr" independent channels, "ms" mid/side
    stereo_mode: str = "lr"

    # Block switching / streaming
    use_block_switch: bool = False
    n_mdct_lines_short: int = 128
    transient_ratio: float = 8.0
    transient_energy_min: float = 1e-6

    # Numerics: "parity" = f64 + FFT MDCT, "fast" = f32 matmul MDCT
    precision: str = "fast"

    def __post_init__(self):
        if self.n_mdct_lines & (self.n_mdct_lines - 1):
            raise ValueError("n_mdct_lines must be a power of two")
        if self.window not in ("sine", "kbd", "hann"):
            raise ValueError(f"unknown window {self.window!r}")
        if self.alloc_mode not in ("greedy", "uniform", "const_snr", "const_mnr"):
            raise ValueError(f"unknown alloc_mode {self.alloc_mode!r}")
        if self.precision not in ("parity", "fast"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.psy_granularity not in ("line", "band", "band_all"):
            raise ValueError(
                f"unknown psy_granularity {self.psy_granularity!r} "
                "(line | band [scoped default] | band_all [force])")
        if self.huffman_sets not in (1, 2, 3):
            raise ValueError("huffman_sets must be 1, 2 or 3 (2-bit "
                             "tableId: 0 = raw, 1/2/3 = trained sets)")
        if self.use_block_switch:
            if self.n_mdct_lines % self.n_mdct_lines_short:
                raise ValueError("short lines must divide long lines")
        if self.stereo_mode not in ("lr", "ms"):
            raise ValueError(f"unknown stereo_mode {self.stereo_mode!r}")
        if self.stereo_mode == "ms":
            if self.n_channels % 2:
                raise ValueError(
                    "stereo_mode='ms' requires an even n_channels "
                    "(adjacent channels butterfly pairwise, SPEC.md §11)")

    @property
    def frame_size(self) -> int:
        return 2 * self.n_mdct_lines

    def bits_per_block_channel(self, n_lines: Optional[int] = None) -> int:
        """Total payload bit budget per (block, channel). SPEC.md §6."""
        h = self.n_mdct_lines if n_lines is None else n_lines
        return (self.bitrate_bps * h) // (self.sample_rate * self.n_channels)

    def replace(self, **kw) -> "CodecConfig":
        return dataclasses.replace(self, **kw)


PRESETS = {
    "mono16-64": CodecConfig(
        sample_rate=16_000, n_channels=1, bitrate_bps=64_000,
        n_mdct_lines=512, use_psy=False, alloc_mode="uniform",
        precision="parity",
    ),
    "stereo44-128": CodecConfig(
        sample_rate=44_100, n_channels=2, bitrate_bps=128_000,
        n_mdct_lines=1024, use_psy=True, alloc_mode="greedy",
    ),
    "vbr-huffman": CodecConfig(
        sample_rate=44_100, n_channels=2, bitrate_bps=128_000,
        use_psy=True, use_huffman=True,
    ),
    "corpus": CodecConfig(
        sample_rate=44_100, n_channels=2, bitrate_bps=128_000,
        use_psy=True,
    ),
    "streaming-ll": CodecConfig(
        sample_rate=44_100, n_channels=1, bitrate_bps=96_000,
        n_mdct_lines=256, n_mdct_lines_short=64, use_block_switch=True,
        use_psy=True,
    ),
    "vbr-bs": CodecConfig(
        sample_rate=44_100, n_channels=2, bitrate_bps=128_000,
        use_psy=True, use_huffman=True, use_block_switch=True,
    ),
    "stereo44-128-ms": CodecConfig(
        sample_rate=44_100, n_channels=2, bitrate_bps=128_000,
        use_psy=True, alloc_mode="greedy", stereo_mode="ms",
    ),
    "vbr-ms": CodecConfig(
        sample_rate=44_100, n_channels=2, bitrate_bps=128_000,
        use_psy=True, use_huffman=True, stereo_mode="ms",
    ),
    "ms-bs": CodecConfig(
        sample_rate=44_100, n_channels=2, bitrate_bps=128_000,
        use_psy=True, use_block_switch=True, stereo_mode="ms",
    ),
    "vbr-ms-bs": CodecConfig(
        sample_rate=44_100, n_channels=2, bitrate_bps=128_000,
        use_psy=True, use_huffman=True, use_block_switch=True,
        stereo_mode="ms",
    ),
}


def check_supported(cfg: CodecConfig) -> None:
    """Raise for the stream families this package does not code yet
    (fixed-rate L/R without block switching is what it codes)."""
    missing = [name for name, on in (("use_huffman", cfg.use_huffman),
                                     ("use_block_switch", cfg.use_block_switch),
                                     ("stereo_mode='ms'",
                                      cfg.stereo_mode == "ms")) if on]
    if missing:
        raise NotImplementedError(
            f"tac_torch codes fixed-rate L/R streams only; {', '.join(missing)} "
            "is not ported yet (use the tac package)")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or implied) and absent, so a
    machine without a card never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tac_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
