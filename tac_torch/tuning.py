"""The corpus batch default (counterpart of tac/tuning.py's corpus batch).

tac's row-chunk auto-tuning is a TPU-runtime workaround; the port's row
chunk is the constant codec.ENC_CHUNK. There is no environment override.
"""

from __future__ import annotations

# Clips per device batch in CorpusTranscoder / CorpusDecoder, on the card
# and on the CPU alike (8 is tac's value off a TPU). On the card it is the
# knee of chip_smoke.py's batch ladder: the smallest batch whose corpus
# encode rate is within 10 % of the ladder's best. On an NVIDIA H100 80GB
# HBM3 at 700.00 W, 64 WAVs of 5-15 s, PRESETS["corpus"], audio-s per
# wall-s at batch 8 / 16 / 32 / 64 in five runs: 843 / 877 / 929 / 850
# (one pass), 761 / 713 / 750 / 820, 736 / 729 / 754 / 661,
# 754 / 787 / 774 / 773 and 664 / 741 / 821 / 774 (better of two passes).
# The job is host-bound (WAV reads, framing), so the rate is flat in the
# batch within the spread between runs: the knee is 8 in four runs and 16
# in the last (741 against 0.9 x 821). Give the card its own value only
# when ladders measure a different knee there consistently.
CORPUS_BATCH = 8
