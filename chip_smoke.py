#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tac_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:
  1. card: the GPU's name and power limit (nvidia-smi's line, alone), torch
     and CUDA versions;
  2. build: all eight CUDA kernels from tac_torch/csrc (one nvcc per
     source, all started together), with nvcc's register / shared-memory /
     spill lines;
 2a. K6 (row_gemm, the fast encoders' products: an FFMA chain per output)
     and K7 (segment_sum, block switching's transient prefix sums: a warp
     per row), the port's kernels with no TPU counterpart, on every product
     of one flagship encode, the transient sums of a switching clip and of
     a streaming-ll bulk batch, and at each product shape of the presets
     (2 048 rows, and 1 and 2 049): K6 within K * 2^-23 * sum|a||b| of its
     plain version, K7 equal to its plain version on the CPU (40 and 64
     segments too); the rows of each equal bit for bit across M in {1, 2,
     3, 2047, 2048, 2049, 20704}, a permutation and leading axes; times
     (events and the profiler's device time) against the library's calls
     (``phase_row_kernels``); then K8 (psy_smr, the fast psy model after
     its DFT in one launch) on the flagship's own calls and on streaming-ll's
     long and short rows: the same kept maskers as the plain model, SMRs
     within 0.001 dB, rows equal across M and a permutation, times against
     the plain model and its bound (``phase_psy_kernel``);
 2b. the batch-invariance diagnostic (``phase_batch_invariance``): the
     nine golden families in fast precision, a noisy and a pure-tone clip
     each, solo against inside batches of 2 / 8 / 16 and as a stream of
     one- and two-row chunks, stage by stage bit for bit (frames, MDCT
     lines, psy DFT, SMRs, snapped SMRs, allocations, words, stream
     bytes; transient flags on block
     switching), with the library's products and cumsums and the plain psy
     model (before K6, K7 and K8) and as the port runs; the first
     differing stage and row are printed both ways, and any difference
     with K6-K8 fails the run;
  3. kernel checks at the flagship's shapes: K1 (water-fill) and K2 (word
     scatter) equal their plain PyTorch versions exactly, on the card,
     including a constructed row where a fused multiply-add would change
     the water-fill's decision;
  4. main path: PRESETS["stereo44-128"] (fast) on 16 clips x 15 s stereo —
     the batched device encode (timed with CUDA events), then
     encode_array → bytes → decode_array per clip; the launch counters are
     zeroed just before and read just after, and every kernel must have
     launched (K1, K2, K6, K8); the card's SNR on clip 0 (first 2 s) must
     be within 0.1 dB of the port's own CPU run; then one encode under
     torch.profiler (device time by kernel, idle share);
  5. VBR kernel checks at the VBR run's shapes: K3 (reservoir chain, 32
     lanes x 647 frames) and K4 (Huffman decode walk, 20 704 rows, every
     row with its own tableId's set in one launch) equal their plain
     versions exactly, plus small cases (one and three sets, forced ties,
     per-frame n_lines, a resumed chain, 50 joint bands, the FMA row;
     random bits with tids of every kind under each set alone and all
     three, sizes outside [2, 8], escapes, walks past the payload, a
     stalling table); the plain K3 run counts the chain's greedy-loop
     trips per frame, the plain K1 run on the flagship rows per row;
  6. VBR path: PRESETS["vbr-huffman"] (fast) on the same clips — batched
     device encode and decode (CUDA events), then encode_array → bytes →
     decode_array per clip, counters zeroed before and read after (K2, K3
     and K4 must have launched), SNRs, card vs CPU on clip 0, the share of
     frames by tableId, one encode under torch.profiler;
  7. K5 (fused framing + MDCT, split-TF32 on the tensor cores) against its
     plain version within 5e-6 * max|ref| at 32 channels x 647 frames x
     (2048 -> 1024), at the block-switch transforms' sizes H = 256 and 128,
     at F = 5 mono, h = 64, h = 4 and T under one hop (err / tol printed);
     then the filterbank path: 16 x 15 s stereo -> mdct_analysis (K5) ->
     mdct_synthesis (IMDCT matmul, overlap-add), round-trip SNR over 110 dB
     (f32 sums of 2 048 terms);
  8. block switching on 16 x 15 s of switching material (the same clips
     plus a seeded strike train each; all four window states must occur,
     SHORT in at least 2 % of frames): K1 with per-row band widths and K2 at
     1 076 fields against their plain versions, then the fixed-rate
     block-switch path (PRESETS["vbr-bs"] without Huffman) batched and per
     clip, K1 and K2 counted;
  9. the Huffman x block-switch combo (PRESETS["vbr-bs"]): K3 with per-frame
     band widths, K2 at 2 101 fields and K4 behind the state-selected band
     map against their plain versions, then the path batched and per clip,
     K2, K3 and K4 counted. Both block-switch paths compare a batched decode
     with a solo decode of the same words and the card with the CPU run;
 10. mid/side joint stereo at full width, nothing cut: stereo44-128-ms and
     vbr-ms on the phase-4 clips, ms-bs and vbr-ms-bs on the switching
     clips. K1 on the real joint rows [10 352, 50] at 2·budget (shared
     widths; per-row state-selected widths for ms-bs), K3 with one lane
     per pair, [647, 16, 50], base 2·budget (shared widths; per-frame
     widths for vbr-ms-bs; the plain version once per family on all 16
     lanes), K2 at each family's capacity and K4 on the VBR families'
     words, each equal to its plain version; then each path batched and
     per clip with its counters, a batched decode against a solo decode,
     card vs CPU on clip 0, and the M/S vs L/R SNR at the rates the two
     presets run (printed, not gated);
 11. parity on the card: the nine golden streams of goldens/streams.json
     (config1/2/3/5/6 and the M/S config7-10) encoded in parity precision
     on the card must hash to their goldens; then DC and Nyquist (lines
     zero in exact arithmetic) under mono16-64 and vbr-huffman at 16 kHz
     mono, the card's bytes equal to the CPU's (``phase_zero_line_parity``);
 12. streaming and random access (``phase_stream``): the nine golden clips
     streamed in parity (one push; seeded random pushes with a mid-stream
     StreamState resume) against their goldens, and their StreamDecoders
     against decode_array exactly; the stream path at full width,
     streaming-ll (mono, H = 256, 2 584 pushes of one half-block) and
     vbr-bs (stereo, H = 1 024, 646 pushes) on 15 s, with push wall times
     against the hop, the stream byte-identical to the offline encode
     and K1 / K3 on inputs captured in mid-stream (K3 resumed from a
     carried fill) against their plain versions; the seek path,
     decode_range on 15 s vbr-huffman and vbr-ms-bs streams at
     tests/test_seek.py's ranges (fast within 2e-5; vbr-ms-bs in parity
     too, exact); and
     tests/test_fuzz.py's mutations of four families through every decode
     surface on the card, the context alive after each case;
 13. the corpus path (``phase_corpus``): the port's CLI, `corpus` and
     `corpus-decode` as a user calls them (default device and batch), on
     64 seeded WAVs of 5-15 s (56 stereo 44.1 kHz, 8 mono 16 kHz) plus one
     file that is not RIFF, for PRESETS["corpus"] and ["vbr-huffman"]:
     rates, the share of the wall in file I/O against the device batches,
     the launches in each window, a resume that encodes nothing, a planted
     truncated .pac that decodes as corrupt, no per-clip fallback, decoded
     WAVs within one LSB of decode_array, decode SNR within 0.1 dB of solo
     encodes, fast and parity corpus bytes equal to solo encodes; pure
     tones through the corpus byte-identical to solo encodes, their fast
     SNR within 0.1 dB of parity under the line psy model (printed under
     the band model, which differs by design); then the corpus family's
     encode rate at batch 8 / 16 / 32 / 64;
 14. the mesh (``phase_mesh``): two rank processes of this script
     (``--mesh-rank``) on the one card over gloo, 8 of the 16 x 15 s clips
     each: the sharded packed encode and decode of stereo44-128 and
     vbr-huffman (each rank's words equal this process's encode of the
     full batch for its clips, its decodes the decode of its words, SNRs
     within 0.1 dB
     of the full batch's, corpus_metrics_sharded's mean that of the
     gathered SNRs, K1-K4 launched on every rank, K1 / K3 inputs captured
     on rank 1 equal to their plain versions), the frame-sharded decode of
     the flagship FrameCode on a 1 x 2 mesh within 1e-6 of decode_clip,
     and the corpus cell of phase 13 through the mesh against the same
     jobs in one process; a 1-rank NCCL mesh in this process; with two
     cards or more, the sharded path on 2 NCCL ranks.
It prints "batch_invariance", "profile", "main_path", "profile_vbr", "vbr_path", "mdct_path",
"profile_bs", "bs_path", "profile_bs_vbr", "bs_vbr_path", one "ms_path" per
M/S family, two "ms_vs_lr", "parity_on_card", "zero_line_parity",
"stream_parity_on_card",
"stream_path", "seek_path", "fuzz_on_card", two "corpus_path",
"corpus_pure_tones", "corpus_ladder", two "mesh_corpus", "mesh_path" and
"kernels" JSON lines, and last {"ok": true, "device": {...}}. Without
CUDA, or without the tac_torch package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

from portbench.profiling import spans_over

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # CUDA cores, outside the tensor cores
TF32_OPS_PER_S = 495e12         # tensor cores, dense
FP64_OPS_PER_S = 34e12          # CUDA cores (K7's double adds)

CLIPS, SECONDS = 16, 15.0
# A row whose decision flips under a fused multiply-add: with n_lines
# [1, 2] and budget 24, band 1 takes 11 bits, then fl(s1 - DEC[11]) == s0
# exactly (a tie the lower band wins) while the fused fl(s1 - 6.02f*11)
# is one ulp above s0. Unfused: [2, 11]; fused: [0, 12].
FMA_ROW = ([22.924339294433594, 89.14434051513672], [1, 2], 24, [2, 11])


def make_clips(b: int, seconds: float, fs: int = 44100) -> np.ndarray:
    """The benchmark's material (bench.py:make_clips): harmonic stereo."""
    rng = np.random.default_rng(0)
    t = np.arange(int(fs * seconds)) / fs
    clips = []
    for i in range(b):
        f0 = 220.0 * (1 + i % 8)
        sig = sum(a * np.sin(2 * np.pi * f0 * k * t)
                  for k, a in [(1, 0.4), (2, 0.2), (3, 0.1), (7, 0.03)])
        ch2 = 0.8 * sig + 0.02 * rng.standard_normal(len(t))
        clips.append(np.stack([sig, ch2]))
    return np.stack(clips).astype(np.float32)       # [B, 2, T]


def strike_train(n: int, fs: int, rng) -> np.ndarray:
    """About eight sharp attacks a second with timing jitter, peak 1: each a
    wideband noise burst decaying in ~4 ms plus a 2.7 kHz ring (the castanet
    generator of tools/material.py, drawn from `rng`)."""
    x = np.zeros(n)
    t0 = int(0.03 * fs)
    dur = int(0.018 * fs)
    k = np.arange(dur)
    while t0 < n - int(0.02 * fs):
        burst = rng.standard_normal(dur) * np.exp(-k / (0.004 * fs))
        ring = 0.6 * np.sin(2 * np.pi * 2700 * k / fs + rng.uniform(0, 6.28))
        ring *= np.exp(-k / (0.006 * fs))
        x[t0:t0 + dur] += rng.uniform(0.5, 0.9) * (0.7 * burst + ring)
        t0 += int(fs * rng.uniform(0.10, 0.16))
    return x / max(np.max(np.abs(x)), 1e-9)


def make_switching_clips(b: int, seconds: float, fs: int = 44100) -> np.ndarray:
    """Material that switches blocks: the harmonic clips plus, per clip, a
    strike train of amplitude 0.3-0.5 from the clip's own seed (the second
    channel at 0.8, as its harmonics), scaled where needed to peak 0.99. The
    harmonic clips alone never leave the LONG state."""
    x = make_clips(b, seconds, fs).astype(np.float64)
    for i in range(b):
        rng = np.random.default_rng(0xCA57 + i)
        strikes = rng.uniform(0.3, 0.5) * strike_train(x.shape[-1], fs, rng)
        x[i] += np.stack([strikes, 0.8 * strikes])
        x[i] *= min(1.0, 0.99 / np.abs(x[i]).max())
    return x.astype(np.float32)                     # [B, 2, T]


def snr_db(x: np.ndarray, y: np.ndarray) -> float:
    return float(10 * np.log10(np.mean(x ** 2) / max(np.mean((x - y) ** 2), 1e-30)))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def timed(fn):
    """(fn(), its device time in ms): one call between two CUDA events."""
    import torch

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def profile_device(fn, top: int = 15) -> dict:
    """Device time by kernel over one call of fn (torch.profiler, CUPTI),
    the host wall of that call, and the share of the wall the card was
    idle. Device time counts kernel events only (not the host ops that
    launched them), so nothing is counted twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = []
    for e in p.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and "CUDA" in str(getattr(e, "device_type", "")):
            kern.append((e.key, us / 1e3, e.count))
    kern.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kern)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if kern else None,
            "kernels": len(kern), "launches": sum(k[2] for k in kern),
            "top": [[k[0][:80], k[1], k[2]] for k in kern[:top]]}


def device_kernel_launches(fn) -> dict:
    """Each codec kernel's launches on the card over one call of fn, by the
    profiler's kernel names (``tracing.DEVICE_KERNELS``), keyed as
    all_counters(): those of a replayed CUDA graph too, which no
    ``.launches`` counter sees. A lower bound: the profiler drops a few of
    these kernels' records in a window (PERF.md §6). The names are
    read from the profiler's raw results, without building its event
    tree (a stream's million kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tac_torch import tracing

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    raw = getattr(p.profiler, "kineto_results", None)
    names = ([e.name() for e in raw.events()
              if e.device_type() == DeviceType.CUDA] if raw is not None else
             [e.name for e in p.events()
              if "CUDA" in str(getattr(e, "device_type", ""))])
    return {k: sum(tracing.DEVICE_KERNELS[f.__name__] in n for n in names)
            for k, f in all_counters().items()}


def fused_water_fill(smr, nl, budget, mm=16):
    """Single-grant greedy with the FUSED need fl(s - 6.02f*a) (numpy): what
    a contracted kernel would compute, for the FMA row's demonstration."""
    f602 = np.float64(np.float32(6.02))
    alloc = np.zeros(len(smr), int)
    frozen = np.zeros(len(smr), bool)
    rem = budget
    while True:
        elig = ~frozen & (alloc < mm) & (nl > 0) & (nl <= rem)
        if elig.any():
            need = np.float32(np.float64(smr) - f602 * alloc)
            b = int(np.argmax(np.where(elig, need, -np.inf)))
            alloc[b] += 1
            rem -= nl[b]
            continue
        lone = np.nonzero((alloc == 1) & ~frozen)[0]
        if not len(lone):
            return alloc
        alloc[lone[-1]], frozen[lone[-1]] = 0, True
        rem += nl[lone[-1]]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    """The least time the card could take, in ms, and what sets it: the
    bytes at the memory rate or the operations at `ops_per_s`."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def worst_err(got, want) -> int:
    """Largest |got - want| over a pair of tensors or of tensor tuples."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max((int((g.long() - w.long()).abs().max().item()) if g.numel() else 0)
               for g, w in zip(got, want))


def decode_checks(x, decoded, what: str) -> list:
    """Per-clip SNRs of decoded [T, C] arrays against x [B, C, T]; fails on a
    wrong shape, a non-finite sample or an SNR of 10 dB or less."""
    snrs = []
    for i, y in enumerate(decoded):
        check(y.shape == x[i].T.shape and bool(np.isfinite(y).all()),
              f"{what} clip {i} decode shape/finite")
        snrs.append(snr_db(x[i].T.astype(np.float64), y.astype(np.float64)))
    check(min(snrs) > 10.0, f"{what} clip SNR too low: {min(snrs):.2f} dB")
    return snrs


def card_vs_cpu(x0, cfg, what: str):
    """Round-trip SNR of one short clip coded on the card and on the CPU by
    the same entry points; fails when they differ by 0.1 dB or more."""
    from tac_torch import api

    gpu = snr_db(x0, api.decode_array(api.encode_array(x0, cfg), "fast")[0])
    cpu = snr_db(x0, api.decode_array(
        api.encode_array(x0, cfg, device="cpu"), "fast", device="cpu")[0])
    print(f"{what} clip 0 ({len(x0) / cfg.sample_rate:.0f} s): card SNR "
          f"{gpu:.4f} dB, CPU SNR {cpu:.4f} dB")
    check(abs(gpu - cpu) < 0.1, f"{what}: card SNR differs from the CPU run")
    return gpu, cpu


def kernel_counters() -> dict:
    """The launch-counted wrapper of each codec kernel, by name."""
    from tac_torch.ops import alloc as k1
    from tac_torch.ops import huffdec as k4
    from tac_torch.ops import pack as k2
    from tac_torch.ops import psy_smr as k8
    from tac_torch.ops import row_gemm as k6
    from tac_torch.ops import segment_sum as k7
    from tac_torch.ops import vbr_scan as k3

    return {"water_fill": k1.water_fill_rows,
            "scatter_words": k2.scatter_words_rows,
            "vbr_scan": k3.vbr_reservoir_scan,
            "huffdec": k4.huffman_decode_sets,
            "row_gemm": k6.row_matmul,
            "segment_sum": k7.segment_sums,
            "psy_smr": k8.psy_smr_rows}


def all_counters() -> dict:
    """kernel_counters() and K5's wrapper (no codec path calls K5, so its
    count must stay at 0 on every codec path)."""
    from tac_torch.ops import mdct_fused as k5

    return {**kernel_counters(), "mdct_fused": k5.mdct_frames_fused}


def zero_counters(counters: dict) -> None:
    """Sets each count to 0 once the card has finished what was queued."""
    import torch

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0


def read_counters(counters: dict) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def per_chunk(fn, *ts, rows: int = 0):
    """A call of fn on every chunk of `rows` rows of the tensors ts (the
    codec's ENC_CHUNK by default), as an encode launches it."""
    from tac_torch import codec

    chunks = list(zip(*(t_.split(rows or codec.ENC_CHUNK) for t_ in ts)))
    return lambda: [fn(*c_) for c_ in chunks]


def drive_path(xs: np.ndarray, cfg, what: str, card: str):
    """One codec path on clips xs [B, C, T]: the batched device encode and
    decode of cfg's family (CUDA events), then encode_array -> bytes -> decode_array per
    clip; the launch counters are zeroed just before and read just after.
    Checks every decode (shape, finite, SNR), a batched decode against a
    solo decode of the same words (f32 IMDCT matmuls of two batch shapes,
    within 1e-5) and the card against the CPU on clip 0 (2 s). Returns
    (batched words, launches, the path's record with one profiled encode)."""
    import torch

    from tac_torch import api
    from tac_torch.family import decode_clip_packed as dec
    from tac_torch.family import encode_clip_packed as enc

    dev = torch.device("cuda")
    xsd = torch.as_tensor(xs, device=dev)
    clips, t = xs.shape[0], xs.shape[-1]
    audio_s = clips * t / cfg.sample_rate
    counters = kernel_counters()
    with torch.no_grad():
        enc(xsd, cfg, dev)                                  # warm
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        (words, nbits), enc_ms = timed(lambda: enc(xsd, cfg, dev))
        y_batch, dec_ms = timed(lambda: dec(words, cfg, t, dev))
        t0 = time.perf_counter()
        streams = [api.encode_array(xs[i].T, cfg) for i in range(clips)]
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = [api.decode_array(s_, "fast")[0] for s_ in streams]
        t_dec = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        print(f"{what} path launches: {launches}")
        snrs = decode_checks(xs, decoded, what)
        y0 = dec(words[0], cfg, t, dev)
        check(float((y0 - y_batch[0]).abs().max()) < 1e-5,
              f"batched {what} decode differs from the solo decode of the "
              "same words")
        snr_batch = decode_checks(xs, y_batch.cpu().numpy().swapaxes(1, 2),
                                  f"batched {what}")
        gpu_snr, cpu_snr = card_vs_cpu(xs[0].T[: 2 * cfg.sample_rate], cfg, what)
        prof = profile_device(lambda: enc(xsd, cfg, dev))
    return words, launches, {
        "clips": clips, "clip_seconds": t / cfg.sample_rate,
        "device_encode_ms": enc_ms, "device_decode_ms": dec_ms,
        "audio_s_per_s_device": audio_s / (enc_ms / 1e3),
        "audio_s_per_s_device_decode": audio_s / (dec_ms / 1e3),
        "audio_s_per_s_full_encode": audio_s / t_enc,
        "audio_s_per_s_full_decode": audio_s / t_dec,
        "launches": launches, "snr_db": snrs, "snr_db_batched": snr_batch,
        "clip0_2s_snr_card": gpu_snr, "clip0_2s_snr_cpu": cpu_snr,
        "stream_bytes": sum(len(s_) for s_ in streams), "profile": prof,
        "card": card}


def product_shapes() -> list:
    """(K, N) of every fast product the presets run (tac_torch.config.
    PRESETS): the window-fused MDCT and the psy DFT at 2H -> H, and on the
    block-switch presets the short MDCT and short DFT at 2Hs -> Hs."""
    from tac_torch.config import PRESETS

    hs = {cfg.n_mdct_lines for cfg in PRESETS.values()}
    hs |= {cfg.n_mdct_lines_short for cfg in PRESETS.values()
           if cfg.use_block_switch}
    return sorted(((2 * h, h) for h in hs), reverse=True)


@contextlib.contextmanager
def recording(module, name: str, log: list):
    """Every call of module.name inside the block is appended to log (its
    positional arguments) and passed on. The stand-in carries the launch
    count (the wrapper counts on the name it is bound to) and hands it
    back."""
    orig = getattr(module, name)

    def rec(*a):
        log.append(a)
        return orig(*a)

    rec.launches = orig.launches
    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)
        orig.launches = rec.launches


def k6_bound_ratio(a, b, got, want) -> tuple:
    """(max |got - want|, its largest share of K * 2^-23 * sum|a||b|): two
    f32 sums of the same K products, each within K * 2^-24 * sum|a||b| of
    the exact sum whatever its order."""
    import torch

    k = b.shape[0]
    scale = (a.abs().double() @ b.abs().double()) * (k * 2.0 ** -23)
    err = (got.double() - want.double()).abs()
    ratio = torch.where(err > 0, err / scale.clamp_min(1e-300),
                        torch.zeros_like(err))
    return float(err.max()), float(ratio.max())


def rows_invariant(fn, x) -> dict:
    """fn on x's first M rows for M in {1, 2, 3, 2047, 2048, 2049} and on
    all of x, and on x's rows permuted, against fn on x in 2 048-row
    chunks (the codec's own launches): {M or "permuted": equal bit for
    bit}."""
    import torch

    ref = torch.cat([fn(c_) for c_ in x.split(2048)])
    out = {str(m): bool(torch.equal(fn(x[:m]), ref[:m]))
           for m in (1, 2, 3, 2047, 2048, 2049, x.shape[0])}
    perm = torch.randperm(x.shape[0], device=x.device)
    out["permuted"] = bool(torch.equal(fn(x[perm]), ref[perm]))
    return out


def phase_row_kernels(frames, card: str) -> tuple:
    """K6 (row_gemm) and K7 (segment_sum), the kernels of this port with no
    TPU counterpart that make the fast encoders' floats row-invariant, on
    the flagship's own inputs (every product of one encode, recorded from
    analyze_frame on its 2 048-row chunks; K7 is recorded there too, and
    launches none: the psy's band sums are K8's), on block switching's
    transient prefix sums (a switching clip's, and a streaming-ll bulk
    batch's: 16 x 15 s mono) and on noisy rows at each product shape of
    the presets. K6 within K * 2^-23 * sum|a||b|
    of its plain version (one library call per row); K7 equal to its plain
    version on the CPU bit for bit (the CPU's cumsum adds in double, in
    index order, as the kernel does) and within L * 2^-23 * sum|x| of it on
    the card. Each kernel's rows equal, bit for bit, across M in {1, 2, 3,
    2047, 2048, 2049, 20704} and under a row permutation. Times: K6 on one
    encode's launches and per launch at each shape, K7 on the streaming-ll
    batch's prefix sums (events) against the library's calls and the plain
    version. Returns the two kernels' entries of the kernels line (launches
    are added by the path phases)."""
    import torch

    from tac_torch import blockswitch as bsw
    from tac_torch import codec
    from tac_torch.config import PRESETS
    from tac_torch.ops import row_gemm as k6
    from tac_torch.ops import segment_sum as k7

    dev = torch.device("cuda")
    cfg = PRESETS["stereo44-128"]
    c = codec.make_consts(cfg, dev)
    g6, g7_enc = [], []
    with torch.no_grad():
        with recording(k6, "row_matmul", g6), recording(k7, "segment_sums",
                                                         g7_enc):
            for fc in frames.split(codec.ENC_CHUNK):
                codec.analyze_frame(fc, cfg, c)
        # K6 against its plain version on every product of the encode
        worst6 = (0.0, 0.0)
        for a, b in g6:
            e = k6_bound_ratio(a, b, k6.row_matmul(a, b),
                               k6.row_matmul_plain(a, b))
            worst6 = max(worst6[0], e[0]), max(worst6[1], e[1])
        print(f"  K6 flagship products ({len(g6)} calls): max_abs_err "
              f"{worst6[0]:.3e}, {worst6[1]:.4f} of the bound")
        check(worst6[1] <= 1.0, "K6 differs from its plain version beyond "
              "K * 2^-23 * sum|a||b|")
        rng = np.random.default_rng(6)
        shapes = {}
        for k, n in product_shapes():
            t = np.arange(2048 * k).reshape(2048, k) / 44100.0
            a = torch.as_tensor(0.4 * np.sin(2 * np.pi * 440 * t)
                                + 0.05 * rng.standard_normal((2048, k)),
                                dtype=torch.float32, device=dev)
            b = torch.as_tensor(rng.standard_normal((k, n)) / np.sqrt(k),
                                dtype=torch.float32, device=dev)
            e = k6_bound_ratio(a, b, k6.row_matmul(a, b),
                               k6.row_matmul_plain(a, b))
            check(e[1] <= 1.0, f"K6 at {k} -> {n} differs from its plain "
                  "version beyond its bound")
            bm, bn = k6.tile(k, n)
            check(2048 % bm == 0 and (2048 // bm) * -(-n // bn) == 128,
                  f"K6's tile {bm} x {bn} at {k} -> {n} does not give a "
                  "2 048-row launch 128 blocks")
            worst6 = max(worst6[0], e[0]), max(worst6[1], e[1])
            tb, _ = bound(4 * (2048 * k + k * n + 2048 * n), 2 * 2048 * k * n)
            shapes[f"{k}x{n}"] = {
                "rows": 2048, "tile": [bm, bn],
                "ms": cuda_ms(lambda: k6.row_matmul(a, b), 20),
                "device_ms": profile_device(
                    lambda: k6.row_matmul(a, b))["device_busy_ms"],
                "library_ms": cuda_ms(lambda: a @ b, 20), "bound_ms": tb,
                "max_abs_err": e[0], "err_over_bound": e[1]}
            # one row and 2 049 rows (a row tile of its own) at this shape
            for m in (1, 2049):
                am = torch.cat([a, a[:1]])[:m]
                em = k6_bound_ratio(am, b, k6.row_matmul(am, b),
                                    k6.row_matmul_plain(am, b))
                check(em[1] <= 1.0, f"K6 at {k} -> {n}, {m} rows, differs "
                      "from its plain version beyond its bound")
                worst6 = max(worst6[0], em[0]), max(worst6[1], em[1])
        # invariance: the flagship MDCT over all 20 704 rows, and 3-D rows
        inv6 = rows_invariant(lambda a: k6.row_matmul(a, c.fwd_basis), frames)
        sub = frames[:2048, :2048].reshape(2048, 8, 256).contiguous()
        bs_ = torch.as_tensor(rng.standard_normal((256, 128)) / 16,
                              dtype=torch.float32, device=dev)
        inv6["leading_axes"] = bool(torch.equal(
            k6.row_matmul(sub, bs_).reshape(-1, 128),
            k6.row_matmul(sub.reshape(-1, 256), bs_)))
        print(f"  K6 rows equal across M / permuted / leading axes: {inv6}")
        check(all(inv6.values()), "K6 rows depend on M or on their place")
        del sub

        # K7: block switching's transient prefix sums, a switching clip's
        # (vbr-bs) and a streaming-ll bulk batch's (16 x 15 s mono)
        xsw = torch.as_tensor(make_switching_clips(2, 2.0), device=dev)
        xsl = torch.as_tensor(make_switching_clips(16, 15.0)[:, :1],
                              device=dev)
        g7, sll = [], []
        with recording(k7, "segment_sums", g7):
            bsw.transient_flags(xsw, PRESETS["vbr-bs"])
        with recording(k7, "segment_sums", sll):
            bsw.transient_flags(xsl, PRESETS["streaming-ll"])
        g7 += sll
        worst7, bitwise7 = 0.0, True
        for x, ranges in g7:
            got = k7.segment_sums(x, ranges)
            bitwise7 &= bool(torch.equal(got.cpu(),
                                         k7.segment_sums_plain(x.cpu(), ranges)))
            want = k7.segment_sums_plain(x, ranges)
            tol = (x.shape[-1] * 2.0 ** -23
                   * k7.segment_sums_plain(x.abs().double(), ranges))
            worst7 = max(worst7, float(((got.double() - want.double()).abs()
                                        / tol.clamp_min(1e-300)).max()))
        # more than 32 segments (a lane takes two), 40 and 64 of them
        xs7 = frames[:2048, :1024].contiguous()
        for nseg in (40, 64):
            cuts = np.sort(rng.integers(0, 1025, 2 * nseg)).reshape(nseg, 2)
            g7.append((xs7, tuple((int(a_), int(b_)) for a_, b_ in cuts)))
        for x, ranges in g7[-2:]:
            got = k7.segment_sums(x, ranges)
            bitwise7 &= bool(torch.equal(got.cpu(),
                                         k7.segment_sums_plain(x.cpu(), ranges)))
        g7 = g7[:-2]
        print(f"  K7 ({len(g7)} calls of transient prefixes, and 40 / 64 "
              f"segments): equal to the CPU plain version {bitwise7}, "
              f"{worst7:.4f} of the bound against the card's; "
              f"{len(g7_enc)} launches in one flagship encode")
        check(bitwise7 and worst7 <= 1.0, "K7 differs from its plain version")
        rr = sll[0][1]
        xr = torch.cat([x.reshape(-1, x.shape[-1]) for x, _ in sll])
        inv7 = rows_invariant(lambda x: k7.segment_sums(x, rr), xr)
        print(f"  K7 rows equal across M / permuted: {inv7}")
        check(all(inv7.values()), "K7 rows depend on M or on their place")

        # times of one flagship encode's launches (3 products per 2 048-row
        # chunk) and of the streaming-ll batch's prefix sums
        mdct = [(a, b) for a, b in g6 if b is c.fwd_basis]
        ms6 = cuda_ms(lambda: [k6.row_matmul(a, b) for a, b in g6], 5)
        lib6 = cuda_ms(lambda: [a @ b for a, b in g6], 5)
        ms6_mdct = cuda_ms(lambda: [k6.row_matmul(a, b) for a, b in mdct], 5)
        lib6_mdct = cuda_ms(lambda: [a @ b for a, b in mdct], 5)
        _, plain6 = timed(lambda: [k6.row_matmul_plain(a, b) for a, b in g6])
        dev6 = profile_device(lambda: [k6.row_matmul(a, b) for a, b in g6])
        ms7 = cuda_ms(lambda: [k7.segment_sums(x, r) for x, r in sll], 20)
        dev7 = profile_device(lambda: [k7.segment_sums(x, r) for x, r in sll])
        plain7 = cuda_ms(lambda: [k7.segment_sums_plain(x, r)
                                  for x, r in sll], 5)
        # the library's route for prefixes: one cumsum, read at the edges
        check(all(s_ == 0 for s_, _ in rr), "K7's timed segments are not "
              "prefixes")
        ends = torch.tensor([e for _, e in rr], device=dev)
        lib7 = cuda_ms(lambda: [torch.nn.functional.pad(
            x.cumsum(-1), (1, 0))[..., ends] for x, _ in sll], 5)

    def flops(calls):
        return sum(2 * a.numel() * b.shape[1] for a, b in calls)

    def nbytes(calls):
        return sum(4 * (a.numel() + b.numel() + a.numel() // b.shape[0]
                        * b.shape[1]) for a, b in calls)

    b6, b6_by = bound(nbytes(g6), flops(g6))
    b6m, _ = bound(nbytes(mdct), flops(mdct))
    n7 = sum(x.numel() for x, _ in sll)
    b7, b7_by = bound(4 * (n7 + sum(x.numel() // x.shape[-1] * len(r)
                                    for x, r in sll)), n7, FP64_OPS_PER_S)
    k6_entry = {
        "name": "row_gemm", "route": "cuda",
        "source": "tac_torch/csrc/row_gemm.cu",
        "replaces": "none: port-only, no TPU kernel (tac's products are "
                    "jnp.dot: tac/codec.py:153, tac/psy.py:293, "
                    "tac/blockswitch.py:165, :177)",
        "ok": True, "max_abs_err": worst6[0], "err_over_bound": worst6[1],
        "design": "register-blocked FFMA sgemm on the CUDA cores: tile "
                  "by N alone (128 x 128 from 1 024 columns, 128 x 64, "
                  "64 x 64, 64 x 32, 32 x 32 below; 128 blocks a 2 048-row "
                  "launch), 8 x 8 / 8 x 4 / 4 x 4 outputs a thread, k-slices "
                  "of 16 double-buffered in shared memory (B by cp.async, A "
                  "transposed through registers); each output one FFMA "
                  "chain in k order (no split-K)",
        "rows_invariant": inv6,
        "ms": ms6, "device_ms": dev6["device_busy_ms"],
        "launches_per_flagship_encode": len(g6),
        "plain_ms": plain6, "bound_ms": b6, "bound_by": b6_by,
        "library_ms": lib6, "ms_flagship_mdct": ms6_mdct,
        "library_ms_flagship_mdct": lib6_mdct, "bound_ms_flagship_mdct": b6m,
        "by_shape_2048_rows": shapes}
    k7_entry = {
        "name": "segment_sum", "route": "cuda",
        "source": "tac_torch/csrc/segment_sum.cu",
        "replaces": "none: port-only, no TPU kernel (tac's band segment "
                    "sums and transient cumsum are jnp ops: tac/psy.py, "
                    "tac/blockswitch.py)",
        "ok": True, "max_abs_err": 0, "equal_to_cpu_plain": bitwise7,
        "err_over_bound_vs_card_plain": worst7,
        "design": "warp per row, 8 rows a block; the row staged in shared "
                  "memory by coalesced 16-byte loads, 1 024 floats at a "
                  "time; lane i adds segments i and i + 32 in index order "
                  "into doubles (nested prefixes too, a lane each); "
                  "segment table by value",
        "rows_invariant": inv7,
        "timed": "the transient prefix sums of a streaming-ll bulk batch "
                 "(16 x 15 s mono)",
        "rows_timed": xr.shape[0], "calls_timed": len(sll),
        "ms": ms7, "device_ms": dev7["device_busy_ms"],
        "launches_per_flagship_encode": len(g7_enc),
        "plain_ms": plain7, "bound_ms": b7, "bound_by": b7_by,
        "library_ms": lib7}
    del g6, g7, g7_enc, sll, mdct, xr, xs7, xsl
    return k6_entry, k7_entry


# the SFUs' peak: 16 MUFU operations a clock on each of 132 SMs at 1.98 GHz
SFU_OPS_PER_S = 16 * 132 * 1.98e9


def k8_plain(re, im, lines, c, gain=None, maskers=False):
    """The plain psy model on K8's inputs, in K8's signature: smr, and
    with ``maskers`` the kept maskers' indices (-1 past the valid ones)."""
    import torch

    from tac_torch import psy

    ii = c.fft_gain * (re * re + im * im)
    smr = psy.smrs_from_intensity(ii, lines, c, gain)
    if not maskers:
        return smr
    _, _, top_idx, _, _, valid, _ = psy._tonal_maskers(ii, c)
    return smr, torch.where(valid, top_idx, -1).to(torch.int32)


def phase_psy_kernel(frames, card: str) -> dict:
    """K8 (psy_smr, the fast psy model after its DFT in one launch) at the
    paths' shapes: the flagship's own calls (band model, H = 1 024, every
    2 048-row chunk of one encode, recorded from analyze_frame) and noisy
    streaming-ll rows, 2 048 long rows (line model, H = 256, a per-row gain)
    and 8 192 short ones (H = 64, every line a candidate). Against the
    plain model on the card: the same kept maskers, SMRs within 0.001 dB; rows
    equal bit for bit across M in {1, 2, 3, 2047, 2048, 2049, all} and a
    permutation. Times (events, the profiler's device time) against the
    plain model and the bound: the rows' bytes at the memory rate or one
    MUFU operation per spread exponential (each valid masker and noise band
    at each point) at the SFUs' peak. Returns K8's kernels entry."""
    import torch

    from tac_torch import blockswitch as bsw
    from tac_torch import codec
    from tac_torch.config import PRESETS
    from tac_torch.ops import psy_smr as k8
    from tac_torch.ops import row_gemm as k6

    dev = torch.device("cuda")
    cfg = PRESETS["stereo44-128"]
    c = codec.make_consts(cfg, dev)
    g8 = []
    with torch.no_grad():
        with recording(k8, "psy_smr_rows", g8):
            for fc in frames.split(codec.ENC_CHUNK):
                codec.analyze_frame(fc, cfg, c)
        rng = np.random.default_rng(8)
        bc = bsw.make_bs_consts(PRESETS["streaming-ll"], dev)
        cases = {"flagship_band_1024": g8}
        for name, cp, rows, gain in (("sll_long_256", bc.cl.psy, 2048, True),
                                     ("sll_short_64", bc.psy_short, 8192,
                                      False)):
            h = cp.freqs.shape[0]
            t = np.arange(rows * 2 * h).reshape(rows, 2 * h) / 44100.0
            fr = torch.as_tensor(0.4 * np.sin(2 * np.pi * 440 * t)
                                 + 0.05 * rng.standard_normal((rows, 2 * h)),
                                 dtype=torch.float32, device=dev)
            lines = k6.row_matmul(fr, bc.fwd_short if h == 64 else bc.fwd_long)
            g = (torch.as_tensor(rng.uniform(0.9, 1.6, rows),
                                 dtype=torch.float32, device=dev)
                 if gain else None)
            cases[name] = [(k6.row_matmul(fr, cp.fft_cos),
                            k6.row_matmul(fr, cp.fft_sin), lines, cp, g)]
        entry = {"name": "psy_smr", "route": "cuda",
                 "source": "tac_torch/csrc/psy_smr.cu",
                 "replaces": "none: port-only, no TPU kernel (tac's psy model "
                             "after its DFT is jnp ops fused by XLA: "
                             "tac/psy.py)",
                 "ok": True,
                 "design": "T = min(H, 256) threads a row, 256 / T rows a "
                           "block; the row's intensity in shared memory, "
                           "candidates as 64-bit (value, index) keys in a "
                           "bitonic sort; masker intensities added in rank "
                           "order per point (line model) or from a (masker, "
                           "band) table (band model); noise bands in index "
                           "order in double; -fmad=false, precise powf",
                 "max_abs_err": 0.0, "by_shape": {}}
        for name, calls in cases.items():
            worst, same, exps, nbytes = 0.0, True, 0, 0
            for re, im, lines, cp, g in calls:
                got, idx = k8.psy_smr_rows(re, im, lines, cp, g, maskers=True)
                want, widx = k8_plain(re, im, lines, cp, g, maskers=True)
                same &= bool(torch.equal(idx, widx))
                worst = max(worst, float((got - want).abs().max()))
                h = cp.freqs.shape[0]
                points = 2 * len(cp.band_ranges) if cp.band_thresh else h
                noise = len(cp.band_ranges) if cp.noise_maskers else 0
                exps += int(((idx >= 0).sum(-1) + noise).sum()) * points
                nbytes += 4 * (3 * re.numel() + got.numel()
                               + (0 if g is None else g.numel()))
            print(f"  K8 {name} ({len(calls)} calls): maskers equal {same}, "
                  f"max |smr - plain| {worst:.3e} dB")
            check(same and worst <= 1e-3, f"K8 {name} differs from the plain "
                  "model")
            re, im, lines, cp, g = calls[0]
            inv = rows_invariant(lambda x: k8.psy_smr_rows(
                x[:, 0], x[:, 1], x[:, 2], cp, None if g is None
                else x[:, 3, 0].contiguous()),
                torch.stack([re, im, lines] + ([] if g is None else [
                    g[:, None].expand_as(re)]), 1))
            check(all(inv.values()), f"K8 {name}: rows depend on M or on "
                  "their place")

            def run(fn=k8.psy_smr_rows):
                return [fn(*a) for a in calls]

            b, by = bound(nbytes, exps, SFU_OPS_PER_S)
            entry["max_abs_err"] = max(entry["max_abs_err"], worst)
            entry["by_shape"][name] = {
                "calls": len(calls), "rows": sum(a[0].shape[0] for a in calls),
                "maskers_equal": same, "max_abs_err_db": worst,
                "rows_invariant": inv, "ms": cuda_ms(run, 10),
                "device_ms": profile_device(run)["device_busy_ms"],
                "plain_ms": cuda_ms(lambda: run(k8_plain), 2, 1),
                "bound_ms": b, "bound_by": by, "spread_exponentials": exps,
                "bytes": nbytes}
            print(f"  K8 {name}: {json.dumps(entry['by_shape'][name])}")
    del g8, cases
    return entry


# the fast encode's stages, in pipeline order (those a family has)
STAGES = ("transient_flags", "frames", "mdct_lines", "long_lines",
          "short_lines", "dft_re", "dft_im", "smr", "smr_long", "smr_short",
          "smr_q", "alloc")


def inv_batch(x: np.ndarray, n: int, pos: int, fs: int, seed: int):
    """n clips shaped like x [C, T], x at index pos, the others harmonic
    tones of other pitches with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(x.shape[-1]) / fs
    out = []
    for i in range(n):
        if i == pos:
            out.append(x)
            continue
        f0 = 110.0 * (2 + i)
        sig = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.1 * np.sin(2 * np.pi * 2.5 * f0 * t)
               + 0.01 * rng.standard_normal(len(t)))
        out.append(np.stack([sig * 0.9 ** ch for ch in range(len(x))]))
    return np.stack(out).astype(np.float32)


def inv_stages(xb: np.ndarray, cfg, sizes) -> dict:
    """The fast encode's stages of clips xb [B, C, T] on the card, the
    frame rows cut into chunks of the sizes `sizes` yields (the transient
    flags of a stream's pushes: the signal in pieces of as many half-blocks)
    → {stage: tensor [B, C, F, ...]} ([B, C, Kb] for the flags)."""
    import torch

    from tac_torch import bitalloc, codec, family
    from tac_torch import blockswitch as bsw
    from tac_torch.ops import row_gemm as k6

    dev = torch.device("cuda")
    h = cfg.n_mdct_lines
    bs = cfg.use_block_switch
    fam = family.of(cfg)
    c = fam.make_consts(cfg, dev)
    cl = c.cl if bs else c
    frames, states = fam.frame(xb, cfg, c, dev)
    cp = cl.psy
    lead = frames.shape[:-1]
    rows = frames.reshape(-1, frames.shape[-1])
    out = {s: [] for s in STAGES}
    if bs:
        xt = codec.input_signal(xb, cfg, cl.dtype, dev)
        cuts = [0]
        while cuts[-1] < xt.shape[-1]:
            cuts.append(min(cuts[-1] + h * next(sizes), xt.shape[-1]))
        out["transient_flags"] = [torch.cat(
            [bsw.transient_flags(xt[..., a:b_], cfg)
             for a, b_ in zip(cuts[:-1], cuts[1:])], -1)]
    i = 0
    while i < rows.shape[0]:
        n = next(sizes)
        fc = rows[i:i + n]
        out["frames"].append(fc)
        if bs:
            st = states.reshape(-1)[i:i + n]
            ll, sl, ls, ss = bsw.analyze_frame_bs(fc, st, cfg, c)
            sel = bsw.select_by_state(st, sl, ss)
            out["long_lines"].append(ll)
            out["short_lines"].append(ls)
            out["smr_long"].append(sl)
            out["smr_short"].append(ss)
            nl = bsw.state_n_lines(st, c)
        else:
            lines, sel = codec.analyze_frame(fc, cfg, cl)
            out["mdct_lines"].append(lines)
            out["smr"].append(sel)
            nl = cl.n_lines
        out["smr_q"].append(bitalloc.snap_smr(sel))
        if not cfg.use_huffman and cfg.stereo_mode == "lr":
            out["alloc"].append(codec.water_fill_alloc(sel, nl, cl.budget,
                                                       cfg))
        # the psy's DFT (K6); the model after it is K8's, inside the SMRs
        if cp is not None:
            out["dft_re"].append(k6.row_matmul(fc, cp.fft_cos))
            out["dft_im"].append(k6.row_matmul(fc, cp.fft_sin))
        i += n
    res = {}
    for s in STAGES:
        if out[s]:
            t = torch.cat(out[s])
            res[s] = t if s == "transient_flags" else t.reshape(
                *lead, *t.shape[1:])
    return res


def first_diff(a: dict, b: dict, ia: int, ib: int):
    """The first stage (pipeline order) and row (channel-major frame row of
    the clip) where clip ia of stages a and clip ib of stages b differ bit
    for bit, or None."""
    import torch

    for s in STAGES:
        if s not in a:
            continue
        x, y = a[s][ia], b[s][ib]
        if x.dtype == torch.float32:
            x, y = x.contiguous().view(torch.int32), y.contiguous().view(
                torch.int32)
        if not torch.equal(x, y):
            bad = (x != y).reshape(-1, x.shape[-1]).any(-1)
            return [s, int(bad.nonzero()[0, 0])]
    return None


INV_SETTINGS = (("batch2_first", 2, 0), ("batch8_middle", 8, 3),
                ("batch16_last", 16, 15))


def diagnose(cfg, clip: np.ndarray, seed: int) -> dict:
    """Clip [C, T] solo against inside batches of 2, 8 and 16 (first, in
    the middle, last) and as a stream of one- and two-row chunks: per
    setting the first stage and row that differ from the solo encode's
    (None when every stage is equal bit for bit), then the batched words
    against the solo words and the stream's bytes (pushes of one or two
    hops) against encode_array's."""
    import torch

    from tac_torch import api, codec
    from tac_torch.family import encode_clip_packed as enc
    from tac_torch.streaming import StreamEncoder

    dev = torch.device("cuda")
    fs, h = cfg.sample_rate, cfg.n_mdct_lines
    rng = np.random.default_rng(seed)

    def chunks(n):
        while True:
            yield n

    def one_or_two():
        while True:
            yield int(rng.integers(1, 3))

    solo = inv_stages(clip[None], cfg, chunks(codec.ENC_CHUNK))
    w_solo, nb_solo = enc(clip[None], cfg, dev)
    res = {}
    for name, n, pos in INV_SETTINGS:
        xb = inv_batch(clip, n, pos, fs, seed + n)
        d = first_diff(inv_stages(xb, cfg, chunks(codec.ENC_CHUNK)), solo,
                       pos, 0)
        w, nb = enc(xb, cfg, dev)
        if d is None and not (torch.equal(w[pos], w_solo[0])
                              and torch.equal(nb[pos], nb_solo[0])):
            d = ["words", int((w[pos] != w_solo[0]).reshape(
                -1, w.shape[-1]).any(-1).nonzero()[0, 0])]
        res[name] = d
    d = first_diff(inv_stages(clip[None], cfg, one_or_two()), solo, 0, 0)
    x = clip.T.astype(np.float64)
    s_enc = StreamEncoder(cfg, n_channels=x.shape[1], device=dev)
    parts, i = [s_enc.header(len(x))], 0
    while i < len(x):
        step = h * int(rng.integers(1, 3))
        parts.append(s_enc.push(x[i:i + step]))
        i += step
    stream = b"".join(parts) + s_enc.flush()
    offline = api.encode_array(x, cfg)
    if d is None and stream != offline:
        d = ["stream_bytes", differing_frames(stream, offline)[1]]
    res["stream_1_2_rows"] = d
    return res


def phase_batch_invariance(card: str) -> None:
    """The batch-invariance diagnostic: for each of the nine golden stream
    families in fast precision, one noisy clip and one pure-tone clip of
    0.5 s, solo against inside batches of 2 / 8 / 16 at three places and
    as a stream of one- and two-row chunks, compared stage by stage bit for
    bit (the framed rows, the MDCT lines, the psy DFT's re / im, the SMRs
    and snapped SMRs, the allocations, the words; the transient flags on the
    block-switch families), first with the library's products and cumsums
    and the plain psy model in place of K6, K7 and K8 (the route before
    them), then as the port runs.
    Prints the first differing stage and row per family, clip and setting,
    both ways; fails if any differs with K6, K7 and K8."""
    import os

    import torch

    from tac_torch.config import PRESETS
    from tac_torch.ops import psy_smr as k8
    from tac_torch.ops import row_gemm as k6
    from tac_torch.ops import segment_sum as k7

    t_phase = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import golden

    clips = golden.clips()
    report = {}
    with torch.no_grad():
        for tag, (preset, change, clip_name) in GOLDEN_CASES.items():
            x, fs = clips[clip_name]
            cfg = PRESETS[preset].replace(precision="fast", sample_rate=fs,
                                          **change)
            x = x.T                                          # [C, T]
            rng = np.random.default_rng(len(tag))
            t = np.arange(x.shape[-1]) / fs
            tone = sum(a * np.sin(2 * np.pi * 440.0 * k * t)
                       for k, a in [(1, 0.4), (2, 0.2), (3, 0.1), (7, 0.03)])
            material = {
                "noisy": (x + 0.005 * rng.standard_normal(x.shape)).astype(
                    np.float32),
                "tone": np.stack([tone * 0.8 ** ch for ch in range(len(x))]
                                 ).astype(np.float32)}
            rec = {}
            for when in ("before", "after"):
                orig = (k6.row_matmul, k7.segment_sums, k8.psy_smr_rows)
                if when == "before":       # the library's products and sums
                    k6.row_matmul = lambda a, b: a @ b
                    k7.segment_sums = k7.segment_sums_plain
                    k8.psy_smr_rows = k8_plain
                try:
                    rec[when] = {kind: diagnose(cfg, clip, len(tag))
                                 for kind, clip in material.items()}
                finally:
                    k6.row_matmul, k7.segment_sums, k8.psy_smr_rows = orig
            report[tag] = rec
            print(f"  batch invariance {tag}: before "
                  f"{json.dumps(rec['before'])}; after "
                  f"{json.dumps(rec['after'])}")
    differ_before = sum(d is not None for r in report.values()
                        for k_ in r["before"].values() for d in k_.values())
    differ_after = sum(d is not None for r in report.values()
                       for k_ in r["after"].values() for d in k_.values())
    print(json.dumps({"batch_invariance": {
        "families": report, "settings": [s[0] for s in INV_SETTINGS]
        + ["stream_1_2_rows"], "stages": list(STAGES),
        "cases_differing_before": differ_before,
        "cases_differing_after": differ_after,
        "seconds": time.perf_counter() - t_phase, "card": card}}))
    check(differ_after == 0, f"batch invariance: {differ_after} cases still "
          "differ from the solo encode with K6, K7 and K8")


def phase_k5(x: np.ndarray, card: str) -> dict:
    """Phase 7: K5 against its plain version, its times, and the filterbank
    path. x [B, 2, T] float32. Returns K5's entry of the kernels line."""
    import torch

    from tac_torch import codec, filterbank
    from tac_torch.config import PRESETS
    from tac_torch.dsp import mdct as fb
    from tac_torch.dsp.window import sine_window
    from tac_torch.ops import mdct_fused as k5

    dev = torch.device("cuda")
    cfg = PRESETS["stereo44-128"]
    h = cfg.n_mdct_lines
    xd = torch.as_tensor(x, device=dev)
    basis = codec.make_consts(cfg, dev).fwd_basis
    rng = np.random.default_rng(5)
    ratios = []                                   # err / tol of every case

    def k5_case(name, sig, h_, basis_):
        got = k5.mdct_frames_fused(sig, h_, basis_)
        torch.cuda.synchronize()
        want = k5.mdct_frames_plain(sig, h_, basis_)
        check(got.shape == want.shape, f"K5 {name} shape {tuple(got.shape)}")
        err = float((got - want).abs().max())
        tol = 5e-6 * float(want.abs().max())
        print(f"  K5 {name}: {tuple(sig.shape)} -> {tuple(got.shape)} "
              f"max_abs_err {err:.3e} (tolerance {tol:.3e}, "
              f"err / tol {err / tol:.4f})")
        check(err <= tol, f"K5 {name} differs from its plain version")
        ratios.append(err / tol)
        return err, tol

    def sine_basis(h_):
        return torch.as_tensor(fb.mdct_basis(h_, sine_window(2 * h_)), device=dev)

    with torch.no_grad():
        err, tol = k5_case("path shape, H = 1024", xd, h, basis)
        times = {}
        for h_ in (256, 128):                     # the block-switch transforms
            b_ = sine_basis(h_)
            k5_case(f"H = {h_}", xd, h_, b_)
            times[h_] = cuda_ms(lambda: k5.mdct_frames_fused(xd, h_, b_), 10)
        noise = torch.as_tensor(rng.standard_normal((2, 256 * 24 + 123)),
                                dtype=torch.float32, device=dev)
        for case in (("T off the hop", noise, 256),
                     ("F = 5 mono", noise[:1, :256 * 3 + 1].contiguous(), 256),
                     ("h = 64 under the tile", noise, 64),
                     ("h = 4, under the 32-sample step", noise, 4),
                     ("T under one hop", noise[:, :100].contiguous(), 256)):
            k5_case(*case, sine_basis(case[2]))

        ms = cuda_ms(lambda: k5.mdct_frames_fused(xd, h, basis), 10)
        plain_ms = cuda_ms(lambda: k5.mdct_frames_plain(xd, h, basis), 10)
        frames_ms = cuda_ms(lambda: fb.frame_signal(xd, h) @ basis, 10)
        frames = fb.frame_signal(xd, h)
        gemm_ms = cuda_ms(lambda: frames @ basis, 10)
        n_fr = frames.shape[-2]
        del frames

        # ---- the filterbank path: counter zeroed just before, read just after
        t = x.shape[-1]
        filterbank.mdct_synthesis(filterbank.mdct_analysis(xd, cfg), cfg, t)
        torch.cuda.synchronize()
        k5.mdct_frames_fused.launches = 0
        lines, ana_ms = timed(lambda: filterbank.mdct_analysis(xd, cfg))
        y, syn_ms = timed(lambda: filterbank.mdct_synthesis(lines, cfg, t))
        launches = k5.mdct_frames_fused.launches
    print(f"filterbank path launches: {{'mdct_fused': {launches}}}")
    check(launches > 0, "K5 was never launched on the filterbank path")
    check(tuple(lines.shape) == (*x.shape[:2], n_fr, h)
          and tuple(y.shape) == x.shape and bool(torch.isfinite(y).all()),
          "filterbank path shapes / finite")
    y = y.cpu().numpy()
    snrs = [snr_db(x[i].astype(np.float64), y[i].astype(np.float64))
            for i in range(len(x))]
    # two f32 products with sums of 2h and h terms taken in sequence: the
    # relative error grows to about eps * sqrt(2h), -111 dB at h = 1024
    check(min(snrs) > 110.0, f"filterbank round trip {min(snrs):.1f} dB")
    audio_s = x.shape[0] * x.shape[-1] / cfg.sample_rate
    print(json.dumps({"mdct_path": {
        "config": "stereo44-128 filterbank (sine window, H = 1024)",
        "clips": x.shape[0], "channels": x.shape[0] * x.shape[1], "frames": n_fr,
        "analysis_ms": ana_ms, "synthesis_ms": syn_ms,
        "audio_s_per_s_device": audio_s / ((ana_ms + syn_ms) / 1e3),
        "round_trip_snr_db_min": min(snrs), "round_trip_snr_db_max": max(snrs),
        "launches": {"mdct_fused": launches}, "card": card}}))

    rows = x.shape[0] * x.shape[1] * n_fr
    flops = 2 * rows * 2 * h * h
    # the route's bound: three TF32 products of the split operands at the
    # tensor cores' TF32 peak (a full-f32 design's would be the f32 peak)
    b5, b5_by = bound(4 * (xd.numel() + basis.numel() + rows * h), 3 * flops,
                      TF32_OPS_PER_S)
    b5_f32, _ = bound(4 * (xd.numel() + basis.numel() + rows * h), flops)
    # library_ms: the one PyTorch call of the same function, the plain
    # version's matmul on the unfolded view (PyTorch copies the overlapping
    # rows, then cuBLAS sgemm); library_frames_ms builds the frame matrix
    # with frame_signal first; library_gemm_ms is the sgemm alone on frames
    # that already exist
    return {"name": "mdct_fused", "route": "cuda",
            "source": "tac_torch/csrc/mdct_fused.cu",
            "replaces": "tac/ops/pallas_mdct.py:70", "launches": launches,
            "ok": True,
            "design": "split-TF32 wgmma (3 products), TMA ring, f32 promotion "
                      "per 32 samples",
            "max_abs_err": err, "tolerance": tol, "err_over_tol": err / tol,
            "err_over_tol_worst_case": max(ratios), "ms": ms,
            "tflops": flops / (ms * 1e-3) / 1e12,
            "ms_h256": times[256], "ms_h128": times[128], "plain_ms": plain_ms,
            "bound_ms": b5, "bound_by": b5_by, "bound_ms_f32_cuda_cores": b5_f32,
            "library_ms": plain_ms, "library_frames_ms": frames_ms,
            "library_gemm_ms": gemm_ms,
            "filterbank_snr_db_min": min(snrs)}


def phase_block_switch(xs: np.ndarray, card: str) -> dict:
    """Phases 8 and 9: the block-switch kernel checks and both block-switch
    paths on the switching material xs [B, 2, T]. Returns per kernel the
    launches of each path, the worst error and the times at these shapes."""
    import torch

    from tac_torch import bitalloc, codec
    from tac_torch import blockswitch as bsw
    from tac_torch.config import PRESETS
    from tac_torch.ops import alloc as k1
    from tac_torch.ops import bitpack
    from tac_torch.ops import huffdec as k4
    from tac_torch.ops import pack as k2
    from tac_torch.ops import vbr_scan as k3

    dev = torch.device("cuda")
    cfg_c = PRESETS["vbr-bs"]
    cfg_b = cfg_c.replace(use_huffman=False)
    clips = xs.shape[0]
    xsd = torch.as_tensor(xs, device=dev)
    ch = codec.ENC_CHUNK

    # ---- 8. material, window states, K1 / K2 at the block-switch shapes
    cb = bsw.make_bs_consts(cfg_b, dev)
    with torch.no_grad():
        frames, states = bsw._frames_and_states(xsd, cfg_b, cb, dev)
        n_fr = frames.shape[-2]
        rows = states.numel()
        state_share = (torch.bincount(states.reshape(-1).long(), minlength=4)
                       .float() / rows).tolist()
        clips_switching = int((states == bsw.SHORT).reshape(clips, -1).any(-1)
                              .sum().item())
        print(f"window states (LONG, START, SHORT, STOP) over {rows} frames: "
              f"{[round(v, 4) for v in state_share]}; {clips_switching} of "
              f"{clips} clips hold a SHORT frame")
        check(min(state_share) > 0, "a window state never occurs in the material")
        check(state_share[bsw.SHORT] >= 0.02,
              f"SHORT share {state_share[bsw.SHORT]:.4f} under 2 %")

        smr_q, nl_rows, fields = [], [], []
        for fr, st in zip(frames.reshape(rows, -1).split(ch),
                          states.reshape(-1).split(ch)):
            ll, sl, ls, ss = bsw.analyze_frame_bs(fr, st, cfg_b, cb)
            smr = bsw.select_by_state(st, sl, ss)
            nl = bsw.state_n_lines(st, cb)
            alloc = codec.allocate_rows(smr, cfg_b, cb.cl, nl)
            bc = bsw.quantize_both(ll, ls, alloc, st, cfg_b, cb)
            smr_q.append(bitalloc.snap_smr(smr).float())
            nl_rows.append(nl)
            fields.append(bitpack.field_words(
                *bsw.payload_fields_bs(bc, cfg_b, cb))[:3])
        del frames, ll, sl, ls, ss, bc
        smr_q = torch.cat(smr_q).contiguous()
        nl_rows = torch.cat(nl_rows).contiguous()
        c0, c1, word0 = (torch.cat(f_).contiguous() for f_ in zip(*fields))
        del fields
        budgets = torch.full((rows,), cb.cl.budget, dtype=torch.int32, device=dev)
        w32_b = -(-bsw.capacity_bits_bs(cfg_b) // 32)
        print(f"bs: {rows} rows x {smr_q.shape[1]} bands (per-row widths), "
              f"{c0.shape[1]} fields, W32 = {w32_b}, budget {cb.cl.budget}")
        k1_err = worst_err(k1.water_fill_rows(smr_q, nl_rows, budgets),
                           k1.water_fill_rows_plain(smr_q, nl_rows, budgets))
        print(f"  K1 bs smr, per-row n_lines {tuple(nl_rows.shape)}: "
              f"max_abs_err {k1_err}")
        check(k1_err == 0, "K1 differs from its plain version at bs shapes")
        k2_err = worst_err(k2.scatter_words_rows(c0, c1, word0, w32=w32_b),
                           k2.scatter_words_rows_plain(c0, c1, word0, w32=w32_b))
        print(f"  K2 bs fields: {tuple(c0.shape)} -> W32 {w32_b} "
              f"max_abs_err {k2_err}")
        check(k2_err == 0, "K2 differs from its plain version at bs shapes")
        k1_bs_ms = cuda_ms(per_chunk(lambda s_, n_, b_: k1.water_fill_rows(s_, n_, b_),
                                     smr_q, nl_rows, budgets), 50)
        k1_bs_one_ms = cuda_ms(lambda: k1.water_fill_rows(smr_q, nl_rows, budgets),
                               50)
        k2_bs_ms = cuda_ms(per_chunk(
            lambda a, b, w: k2.scatter_words_rows(a, b, w, w32=w32_b),
            c0, c1, word0), 50)
        del c0, c1, word0, smr_q, nl_rows

        _, launches_b, path_b = drive_path(xs, cfg_b, "bs", card)
        prof_b = path_b.pop("profile")
    check(all(launches_b[k_] > 0 for k_ in ("water_fill", "scatter_words",
                                            "row_gemm", "segment_sum",
                                            "psy_smr")),
          "a kernel of the bs path was never launched")
    print(json.dumps({"profile_bs": {"what": "one batched bs device encode",
                                     **prof_b}}))
    print(json.dumps({"bs_path": {"config": "vbr-bs without Huffman, fast",
                                  "rows": rows, "state_share": state_share,
                                  "clips_switching": clips_switching,
                                  **path_b}}))

    # ---- 9. the combo: K3 with per-frame n_lines, K2 at 2 101 fields, K4
    cc = bsw.make_bs_consts(cfg_c, dev)
    lanes = rows // n_fr
    base, cap_res = cc.cl.budget, cfg_c.reservoir_factor * cc.cl.budget
    w32_c = -(-bsw.capacity_bits_bs_vbr(cfg_c) // 32)
    with torch.no_grad():
        frames, states = bsw._frames_and_states(xsd, cfg_c, cc, dev)
        st_lanes = states.reshape(lanes, n_fr)
        ll, ls, smr_fl, bh_fl = bsw._bs_vbr_phase1(
            frames.reshape(lanes, n_fr, 1, -1), st_lanes, cfg_c, cc)
        del frames
        smr_fl = bitalloc.snap_smr(smr_fl).float().contiguous()
        nl_fl = bsw.state_n_lines(st_lanes.transpose(0, 1), cc)
        res0 = torch.zeros(lanes, dtype=torch.int32, device=dev)
        print(f"bs x vbr: {lanes} lanes x {n_fr} frames x {smr_fl.shape[2]} "
              f"bands, n_lines {tuple(nl_fl.shape)}, base {base}, cap "
              f"{cap_res}, W32 = {w32_c}")
        k3_got = k3.vbr_reservoir_scan(smr_fl, bh_fl, nl_fl, res0, base=base,
                                       cap=cap_res)
        k1.water_fill_rows_plain.trips = 0
        k3_want, k3_plain_ms = timed(lambda: k3.vbr_reservoir_scan_plain(
            smr_fl, bh_fl, nl_fl, res0, base=base, cap=cap_res))
        k3_trips = k1.water_fill_rows_plain.trips / (lanes * n_fr)
        k3_err = worst_err(k3_got, k3_want)
        print(f"  K3 bs x vbr run, per-frame n_lines: max_abs_err {k3_err}")
        check(k3_err == 0, "K3 differs from its plain version at combo shapes")
        k3_ms = cuda_ms(lambda: k3.vbr_reservoir_scan(
            smr_fl, bh_fl, nl_fl, res0, base=base, cap=cap_res), 5, warmup=1)
        bc = bsw.quantize_both(
            ll[:ch], ls[:ch], k3_got[0].transpose(0, 1).reshape(rows, -1)[:ch],
            st_lanes.reshape(-1)[:ch], cfg_c, cc)
        c0, c1, word0 = bitpack.field_words(*bsw.payload_fields_bs_vbr(
            bc, k3_got[1].transpose(0, 1).reshape(rows)[:ch], cfg_c, cc))[:3]
        k2c_err = worst_err(k2.scatter_words_rows(c0, c1, word0, w32=w32_c),
                            k2.scatter_words_rows_plain(c0, c1, word0, w32=w32_c))
        print(f"  K2 bs x vbr chunk fields: {tuple(c0.shape)} -> W32 {w32_c} "
              f"max_abs_err {k2c_err}")
        check(k2c_err == 0, "K2 differs from its plain version at combo shapes")
        del ll, ls, smr_fl, bh_fl, nl_fl, bc, c0, c1, word0, k3_got, k3_want

        words, launches_c, path_c = drive_path(xs, cfg_c, "bs x vbr", card)
        prof_c = path_c.pop("profile")
        check(all(launches_c[k_] > 0
                  for k_ in ("scatter_words", "vbr_scan", "huffdec",
                             "row_gemm", "segment_sum", "psy_smr")),
              "a kernel of the bs x vbr path was never launched")

        # K4 on the combo encode's words, m_line from the state-selected map
        wf = words.reshape(-1, w32_c).contiguous()
        _, _, tid, _, _, m_line, mant_start = bsw._bs_vbr_head(wf, cfg_c, cc)
        tid_share = (torch.bincount(tid.long(), minlength=4).float()
                     / tid.numel()).tolist()
        sets_present = [sid for sid in range(1, len(cc.cl.huff) + 1)
                        if tid_share[sid] > 0]
        check(bool(sets_present), "no Huffman-coded frame in the bs x vbr run")
        raw = codec.read_raw_mantissas(wf, mant_start[:, None].long(), m_line)
        k4_err = worst_err(
            k4.huffman_decode_sets(wf, mant_start, m_line, tid, raw.clone(),
                                   cc.cl.huff),
            k4.huffman_decode_sets_plain(wf, mant_start, m_line, tid,
                                         raw.clone(), cc.cl.huff))
        print(f"  K4 bs x vbr run: words {tuple(wf.shape)} sets "
              f"{sets_present} max_abs_err {k4_err}")
        check(k4_err == 0, "K4 differs from its plain version at combo shapes")
        k4_ms = cuda_ms(lambda: k4.huffman_decode_sets(
            wf, mant_start, m_line, tid, raw, cc.cl.huff), 20)
    print(json.dumps({"profile_bs_vbr": {
        "what": "one batched bs x vbr device encode", **prof_c}}))
    print(json.dumps({"bs_vbr_path": {
        "config": "vbr-bs fast", "lanes": lanes, "frames": n_fr,
        "rows": rows, "state_share": state_share,
        "clips_switching": clips_switching, "tid_share": tid_share,
        "sets_walked": sets_present, **path_c}}))
    return {
        "water_fill": {"launches_bs_path": launches_b["water_fill"],
                       "max_abs_err": k1_err, "ms_bs_path": k1_bs_ms,
                       "ms_bs_one_launch": k1_bs_one_ms},
        "scatter_words": {"launches_bs_path": launches_b["scatter_words"],
                          "launches_bs_vbr_path": launches_c["scatter_words"],
                          "max_abs_err": max(k2_err, k2c_err),
                          "ms_bs_path": k2_bs_ms},
        "vbr_scan": {"launches_bs_vbr_path": launches_c["vbr_scan"],
                     "max_abs_err": k3_err, "ms_bs_vbr_path": k3_ms,
                     "us_per_frame_bs_vbr_path": k3_ms * 1e3 / n_fr,
                     "trips_per_frame_bs_vbr_path": k3_trips,
                     "plain_ms_bs_vbr_path": k3_plain_ms},
        "huffdec": {"launches_bs_vbr_path": launches_c["huffdec"],
                    "max_abs_err": k4_err, "ms_bs_vbr_path": k4_ms,
                    "sets_walked_bs_vbr_path": sets_present},
        **{k_: {"launches_bs_path": launches_b[k_],
                "launches_bs_vbr_path": launches_c[k_]}
           for k_ in ("row_gemm", "segment_sum", "psy_smr")},
    }


def phase_ms(x: np.ndarray, xs: np.ndarray, lr_ref: dict, card: str) -> dict:
    """Phase 10: mid/side joint stereo at full width, nothing cut. The
    fixed-rate and VBR presets code the correlated clips x [B, 2, T], the
    two block-switch presets the switching clips xs. Per family: its
    kernels against their plain versions at its own shapes (K1 on the
    joint [R/2, 50] rows, K3 with one lane per pair over 50 bands, K2 at
    its capacity, K4 on its words), then the path (``drive_path``). lr_ref
    maps an L/R preset to (per-clip SNRs, stream bytes) of its path on x.
    Returns per kernel what this phase measured."""
    import torch

    from tac_torch import bitalloc, codec, family
    from tac_torch import blockswitch as bsw
    from tac_torch.config import PRESETS
    from tac_torch.ops import alloc as k1
    from tac_torch.ops import bitpack
    from tac_torch.ops import huffdec as k4
    from tac_torch.ops import pack as k2
    from tac_torch.ops import vbr_scan as k3

    dev = torch.device("cuda")
    ch = codec.ENC_CHUNK
    out = {"water_fill": {}, "scatter_words": {}, "vbr_scan": {}, "huffdec": {},
           "row_gemm": {}, "segment_sum": {}, "psy_smr": {}}
    err = dict.fromkeys(out, 0)

    def k2_case(fam, vals_wids, cap_bits):
        """K2 on the first chunk's fields of family `fam` at its capacity."""
        c0, c1, w0 = bitpack.field_words(*vals_wids)[:3]
        w32 = -(-cap_bits // 32)
        e = worst_err(k2.scatter_words_rows(c0, c1, w0, w32=w32),
                      k2.scatter_words_rows_plain(c0, c1, w0, w32=w32))
        print(f"  K2 {fam} chunk fields: {tuple(c0.shape)} -> W32 {w32} "
              f"max_abs_err {e}")
        check(e == 0, f"K2 differs from its plain version at {fam} shapes")
        err["scatter_words"] = max(err["scatter_words"], e)
        out["scatter_words"][f"w32_{fam}"] = w32
        out["scatter_words"][f"ms_{fam}_chunk_launch"] = cuda_ms(
            lambda: k2.scatter_words_rows(c0, c1, w0, w32=w32), 50)

    def k1_case(fam, smr_q, nl, budget):
        """K1 on an M/S family's joint rows [R/2, 50], one launch."""
        bud = torch.full((smr_q.shape[0],), budget, dtype=torch.int32,
                         device=dev)
        got = k1.water_fill_rows(smr_q, nl, bud)
        k1.water_fill_rows_plain.trips = 0
        want, plain_ms = timed(lambda: k1.water_fill_rows_plain(smr_q, nl, bud))
        trips = k1.water_fill_rows_plain.trips / smr_q.shape[0]
        e = worst_err(got, want)
        print(f"  K1 {fam} joint rows {tuple(smr_q.shape)}, n_lines "
              f"{tuple(nl.shape)}, budget {budget}: max_abs_err {e}")
        check(e == 0, f"K1 differs from its plain version at {fam} shapes")
        err["water_fill"] = max(err["water_fill"], e)
        one_ms = cuda_ms(lambda: k1.water_fill_rows(smr_q, nl, bud), 50)
        nbytes = (2 * smr_q.numel() + smr_q.shape[0] + nl.numel()) * 4
        nops = int(got.sum().item()) * (1 + 2 * int(np.ceil(np.log2(
            smr_q.shape[1]))))
        b, b_by = bound(nbytes, nops)
        out["water_fill"].update({
            f"ms_{fam}_one_launch": one_ms, f"plain_ms_{fam}": plain_ms,
            f"trips_per_row_{fam}": trips, f"bound_ms_{fam}_one_launch": b,
            f"bound_by_{fam}": b_by, f"rows_{fam}": smr_q.shape[0]})
        return bud

    def k3_case(fam, smr, bh, nl, base, cap):
        """K3 with one lane per pair over 50 bands, whole clips; the plain
        run (once per family, all lanes) counts the chain's trips."""
        smr_q = bitalloc.snap_smr(smr).float().contiguous()
        res0 = torch.zeros(smr.shape[1], dtype=torch.int32, device=dev)
        got = k3.vbr_reservoir_scan(smr_q, bh, nl, res0, base=base, cap=cap)
        k1.water_fill_rows_plain.trips = 0
        want, plain_ms = timed(lambda: k3.vbr_reservoir_scan_plain(
            smr_q, bh, nl, res0, base=base, cap=cap))
        f_, lanes_ = smr.shape[:2]
        trips = k1.water_fill_rows_plain.trips / (f_ * lanes_)
        e = worst_err(got, want)
        print(f"  K3 {fam} run: {tuple(smr_q.shape)} x {bh.shape[3]} columns, "
              f"n_lines {tuple(nl.shape)}, base {base}, cap {cap}: "
              f"max_abs_err {e} (plain version on all {lanes_} lanes)")
        check(e == 0, f"K3 differs from its plain version at {fam} shapes")
        err["vbr_scan"] = max(err["vbr_scan"], e)
        k3_ms = cuda_ms(lambda: k3.vbr_reservoir_scan(
            smr_q, bh, nl, res0, base=base, cap=cap), 5, warmup=1)
        nbytes = (smr_q.numel() + bh.numel() + got[0].numel()
                  + 3 * f_ * lanes_ + nl.numel() + lanes_) * 4
        nops = (int(got[0].sum().item()) * (1 + 2 * int(np.ceil(np.log2(
            smr.shape[2])))) + smr.numel() * (1 + bh.shape[3] // 7))
        b, b_by = bound(nbytes, nops)
        out["vbr_scan"].update({
            f"ms_{fam}": k3_ms, f"us_per_frame_{fam}": k3_ms * 1e3 / f_,
            f"trips_per_frame_{fam}": trips,
            f"us_per_trip_{fam}": k3_ms * 1e3 / (f_ * trips),
            f"plain_ms_{fam}": plain_ms, f"bound_ms_{fam}": b,
            f"bound_by_{fam}": b_by, f"lanes_{fam}": lanes_})
        return got

    def k4_case(fam, words, head, huff):
        """K4 on the batched encode's words [B, 2, F, W32] and their head
        (tids, m_line, mant_start); both rows of a pair carry the pair's
        tableId."""
        tids, m_line, mant_start = head
        tp = tids.reshape(-1, 2, words.shape[-2])
        check(bool((tp[:, 0] == tp[:, 1]).all()),
              f"{fam}: a pair's rows carry different tableIds")
        wf = words.reshape(-1, words.shape[-1]).contiguous()
        raw = codec.read_raw_mantissas(wf, mant_start[:, None].long(), m_line)
        e = worst_err(
            k4.huffman_decode_sets(wf, mant_start, m_line, tids, raw.clone(), huff),
            k4.huffman_decode_sets_plain(wf, mant_start, m_line, tids,
                                         raw.clone(), huff))
        share = (torch.bincount(tids.long(), minlength=4).float()
                 / tids.numel()).tolist()
        print(f"  K4 {fam} run: words {tuple(wf.shape)} tid shares "
              f"{[round(v, 4) for v in share]} max_abs_err {e}")
        check(e == 0, f"K4 differs from its plain version at {fam} shapes")
        check(sum(share[1:]) > 0, f"no Huffman-coded frame in the {fam} run")
        err["huffdec"] = max(err["huffdec"], e)
        out["huffdec"][f"ms_{fam}"] = cuda_ms(lambda: k4.huffman_decode_sets(
            wf, mant_start, m_line, tids, raw, huff), 20)
        return share

    def path(fam, xs_, cfg, need, extra):
        """Drive the family's path and print its ms_path line."""
        _, launches, rec = drive_path(xs_, cfg, fam, card)
        # K7 sums the transient detector's energies (block switching)
        need = (*need, "row_gemm", "psy_smr") + (
            ("segment_sum",) if cfg.use_block_switch else ())
        check(all(launches[k_] > 0 for k_ in need),
              f"a kernel of the {fam} path was never launched")
        for k_ in need:
            out[k_][f"launches_{fam.replace('-', '_')}_path"] = launches[k_]
        print(json.dumps({"ms_path": {"family": fam, **extra, **rec}}))
        return rec

    def vs_lr(rec, lr):
        """M/S against L/R on the same clips at the rates the two run."""
        snr_lr, bytes_lr = lr_ref[lr]
        gain = np.mean(rec["snr_db"]) - np.mean(snr_lr)
        print(f"{lr} vs its M/S preset: mean SNR L/R {np.mean(snr_lr):.4f} dB, "
              f"M/S {np.mean(rec['snr_db']):.4f} dB ({gain:+.4f} dB), bytes "
              f"M/S / L/R {rec['stream_bytes'] / bytes_lr:.4f}")
        return {"lr_preset": lr, "snr_db_mean_lr": float(np.mean(snr_lr)),
                "snr_db_mean_ms": float(np.mean(rec["snr_db"])),
                "gain_db": float(gain),
                "bytes_ms_over_lr": rec["stream_bytes"] / bytes_lr}

    xd = torch.as_tensor(x, device=dev)
    xsd = torch.as_tensor(xs, device=dev)

    # ---- stereo44-128-ms: K1 at [R/2, 50], K2 at the doubled capacity
    cfg = PRESETS["stereo44-128-ms"]
    c = codec.make_consts(cfg, dev)
    with torch.no_grad():
        fr = codec.fb.frame_signal(codec.input_signal(xd, cfg, c.dtype, dev),
                                   cfg.n_mdct_lines).transpose(-3, -2)
        smr_j, fields0 = [], None
        for fc in fr.reshape(-1, fr.shape[-1]).split(ch):
            lines, smr = codec.analyze_frame(fc, cfg, c)
            smr_j.append(bitalloc.snap_smr(smr).float().reshape(-1, 50))
            if fields0 is None:
                code = codec.quantize_given_alloc(
                    lines, codec.allocate_rows(smr, cfg, c), cfg, c)
                fields0 = codec.payload_fields(code, cfg, c)
        del fr, lines, smr
        smr_j = torch.cat(smr_j).contiguous()
        nl2 = torch.cat([c.n_lines, c.n_lines]).contiguous()
        bud = k1_case("ms", smr_j, nl2, 2 * c.budget)
        # the path's launch shape: one call per chunk of ENC_CHUNK / 2 pairs
        out["water_fill"]["ms_ms_path"] = cuda_ms(per_chunk(
            lambda s_, b_: k1.water_fill_rows(s_, nl2, b_), smr_j, bud,
            rows=ch // 2), 50)
        k2_case("ms", fields0, codec.payload_capacity_bits(cfg, c))
        del smr_j, fields0, code
    rec = path("ms", x, cfg, ("water_fill", "scatter_words"),
               {"config": "stereo44-128-ms fast"})
    print(json.dumps({"ms_vs_lr": {"family": "ms", **vs_lr(rec, "stereo44-128")}}))

    # ---- vbr-ms: K3 with 16 pair lanes x 50 bands, K2, K4
    cfg = PRESETS["vbr-ms"]
    c = codec.make_consts(cfg, dev)
    base = 2 * c.budget
    with torch.no_grad():
        frames = codec.fb.frame_signal(codec.input_signal(xd, cfg, c.dtype, dev),
                                       cfg.n_mdct_lines)
        lines, smr, bh = codec._vbr_phase1_lanes(codec.to_lanes(frames, cfg),
                                                 cfg, c)
        del frames
        got = k3_case("vbr_ms", smr, bh, torch.cat([c.n_lines, c.n_lines]),
                      base, cfg.reservoir_factor * base)
        al_rows, tid_rows = codec.rows_of_chain(got[0], got[1], 2)
        code = codec.quantize_given_alloc(lines[:ch], al_rows[:ch], cfg, c)
        k2_case("vbr_ms", codec.payload_fields_vbr(code, tid_rows[:ch], cfg, c),
                codec.payload_capacity_bits(cfg, c))
        del lines, smr, bh, got, al_rows, tid_rows, code
    rec = path("vbr-ms", x, cfg, ("scatter_words", "vbr_scan", "huffdec"),
               {"config": "vbr-ms fast", "lanes": x.shape[0]})
    with torch.no_grad():
        words = family.encode_clip_packed(xd, cfg, dev)[0]
        _, tids, _, _, m_line, mant_start = codec._vbr_head(
            words.reshape(-1, words.shape[-1]).contiguous(), cfg, c)
        share = k4_case("vbr_ms", words, (tids, m_line, mant_start), c.huff)
        del words, tids, m_line, mant_start
    print(json.dumps({"ms_vs_lr": {"family": "vbr-ms", "tid_share": share,
                                   **vs_lr(rec, "vbr-huffman")}}))

    # ---- ms-bs: shared states, K1 with per-row widths [R/2, 50], K2
    cfg = PRESETS["ms-bs"]
    cb = bsw.make_bs_consts(cfg, dev)
    with torch.no_grad():
        frames, states = bsw._frames_and_states(xsd, cfg, cb, dev)
        sp = states.reshape(-1, 2, states.shape[-1])
        check(bool((sp[:, 0] == sp[:, 1]).all()),
              "ms-bs: a pair's channels carry different window states")
        state_share = (torch.bincount(states.reshape(-1).long(), minlength=4)
                       .float() / states.numel()).tolist()
        print(f"ms-bs window states (LONG, START, SHORT, STOP) of the M/S "
              f"signal: {[round(v, 4) for v in state_share]}")
        fr = frames.transpose(-3, -2).reshape(-1, frames.shape[-1])
        st = states.transpose(-2, -1).reshape(-1)
        del frames
        smr_j, nl_j, fields0 = [], [], None
        for fc, sc in zip(fr.split(ch), st.split(ch)):
            ll, sl, ls, ss = bsw.analyze_frame_bs(fc, sc, cfg, cb)
            smr = bsw.select_by_state(sc, sl, ss)
            nl = bsw.state_n_lines(sc, cb)
            smr_j.append(bitalloc.snap_smr(smr).float().reshape(-1, 50))
            nl_j.append(nl.reshape(-1, 50))
            if fields0 is None:
                bc = bsw.quantize_both(ll, ls, codec.allocate_rows(
                    smr, cfg, cb.cl, nl), sc, cfg, cb)
                fields0 = bsw.payload_fields_bs(bc, cfg, cb)
        del fr, st, ll, sl, ls, ss, smr
        smr_j, nl_j = torch.cat(smr_j).contiguous(), torch.cat(nl_j).contiguous()
        k1_case("ms_bs", smr_j, nl_j, 2 * cb.cl.budget)
        k2_case("ms_bs", fields0, bsw.capacity_bits_bs(cfg))
        del smr_j, nl_j, fields0, bc
    path("ms-bs", xs, cfg, ("water_fill", "scatter_words"),
         {"config": "ms-bs fast", "state_share": state_share})

    # ---- vbr-ms-bs: K3 with per-frame widths [F, P, 50], K2, K4
    cfg = PRESETS["vbr-ms-bs"]
    cc = bsw.make_bs_consts(cfg, dev)
    base = 2 * cc.cl.budget
    with torch.no_grad():
        frames, states = bsw._frames_and_states(xsd, cfg, cc, dev)
        lane_states = bsw.lane_states(states, cfg)
        ll, ls, smr, bh = bsw._bs_vbr_phase1(codec.to_lanes(frames, cfg),
                                             lane_states, cfg, cc)
        del frames
        nl = bsw.state_n_lines(lane_states.transpose(0, 1), cc).repeat(1, 1, 2)
        got = k3_case("vbr_ms_bs", smr, bh, nl.contiguous(), base,
                      cfg.reservoir_factor * base)
        al_rows, tid_rows = codec.rows_of_chain(got[0], got[1], 2)
        st_rows = lane_states.repeat_interleave(2)
        bc = bsw.quantize_both(ll[:ch], ls[:ch], al_rows[:ch], st_rows[:ch],
                               cfg, cc)
        k2_case("vbr_ms_bs", bsw.payload_fields_bs_vbr(bc, tid_rows[:ch], cfg, cc),
                bsw.capacity_bits_bs_vbr(cfg))
        del ll, ls, smr, bh, nl, got, al_rows, tid_rows, st_rows, bc
    path("vbr-ms-bs", xs, cfg, ("scatter_words", "vbr_scan", "huffdec"),
         {"config": "vbr-ms-bs fast", "lanes": xs.shape[0]})
    with torch.no_grad():
        words = family.encode_clip_packed(xsd, cfg, dev)[0]
        _, _, tids, _, _, m_line, mant_start = bsw._bs_vbr_head(
            words.reshape(-1, words.shape[-1]).contiguous(), cfg, cc)
        k4_case("vbr_ms_bs", words, (tids, m_line, mant_start), cc.cl.huff)
        del words, tids, m_line, mant_start
    for k_, e in err.items():
        out[k_]["max_abs_err"] = e
    return out


# goldens/streams.json's cases (tools/golden.py:cases()) on the port's presets
GOLDEN_CASES = {
    "config1_mono16_64": ("mono16-64", {}, "mono16"),
    "config2_stereo44_128": ("stereo44-128", {}, "stereo44"),
    "config3_vbr_huffman": ("vbr-huffman", {}, "stereo44"),
    "config5_blockswitch": ("streaming-ll", {}, "transient44"),
    "config6_vbr_blockswitch": ("vbr-bs", {"n_mdct_lines": 256,
                                           "n_mdct_lines_short": 64,
                                           "n_channels": 1}, "transient44"),
    "config7_ms_stereo": ("stereo44-128-ms", {}, "stereo44"),
    "config8_ms_vbr": ("vbr-ms", {}, "stereo44"),
    "config9_ms_blockswitch": ("ms-bs", {"n_mdct_lines": 256,
                                         "n_mdct_lines_short": 64},
                               "transient44_stereo"),
    "config10_ms_vbr_blockswitch": ("vbr-ms-bs", {"n_mdct_lines": 256,
                                                  "n_mdct_lines_short": 64},
                                    "transient44_stereo"),
}


def phase_zero_line_parity(card: str) -> dict:
    """Phase 11a: parity on lines that are zero in exact arithmetic (tac's
    tests/test_edge_cases.py material: 0.25 DC and 0.25 cos(pi n)), under
    mono16-64 (4 096 samples) and vbr-huffman at 16 kHz mono (8 192): the
    card's stream equals the port's CPU stream byte for byte (the forward
    FFT is numpy's on both; tests/test_torch_edge.py holds the CPU stream
    to tac's)."""
    from tac_torch import api
    from tac_torch.config import PRESETS

    cases = {}
    for preset, n, change in (("mono16-64", 4096, {}),
                              ("vbr-huffman", 8192,
                               {"sample_rate": 16000, "n_channels": 1})):
        cfg = PRESETS[preset].replace(precision="parity", **change)
        for material in ("dc", "nyquist"):
            x = (np.full((n, 1), 0.25) if material == "dc"
                 else (0.25 * np.cos(np.pi * np.arange(n)))[:, None])
            card_bytes = api.encode_array(x, cfg)
            cpu_bytes = api.encode_array(x, cfg, device="cpu")
            cases[f"{preset}/{material}"] = {
                "bytes": len(card_bytes), "equal": card_bytes == cpu_bytes}
    print(json.dumps({"zero_line_parity": {"cases": cases, "card": card}}))
    check(all(v["equal"] for v in cases.values()),
          "parity streams of DC / Nyquist differ between the card and the CPU")
    return cases


def phase_parity_on_card(card: str) -> dict:
    """Phase 11: every golden stream encoded in parity precision on the card
    (the MDCT's forward FFT on the host in numpy, its inverse on cuFFT, f64
    cuBLAS psy, the f64 allocation loops on CUDA tensors)
    against goldens/streams.json. A mismatch is also encoded on the CPU,
    and the first block that differs is printed."""
    import hashlib
    import os

    from tac_torch import api
    from tac_torch import bitstream as bst
    from tac_torch.config import PRESETS
    from tac_torch.dsp.mdct import num_frames

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tools"))
    import golden

    with open(golden.GOLDEN_PATH) as f:
        want = json.load(f)
    material = golden.clips()
    matched, mismatched = [], {}
    for name, (preset, change, clip) in GOLDEN_CASES.items():
        x, fs = material[clip]
        cfg = PRESETS[preset].replace(precision="parity", sample_rate=fs,
                                      **change)
        data = api.encode_array(x, cfg)
        if hashlib.sha256(data).hexdigest() == want[name]["sha256"]:
            matched.append(name)
            continue
        ref = api.encode_array(x, cfg, device="cpu")
        hdr, off = bst.read_header(data)
        f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
        blocks = [bst.split_blocks(d_, off, f * hdr.n_channels)
                  for d_ in (data, ref)]
        first = next((i for i, (o1, l1, o2, l2) in enumerate(zip(
            blocks[0][0], blocks[0][1], blocks[1][0], blocks[1][1]))
            if data[o1:o1 + l1] != ref[o2:o2 + l2]), None)
        mismatched[name] = {
            "bytes": len(data), "cpu_matches_golden":
                hashlib.sha256(ref).hexdigest() == want[name]["sha256"],
            "first_differing_block": first,
            "frame_channel": (None if first is None
                              else divmod(first, hdr.n_channels))}
    print(json.dumps({"parity_on_card": {
        "goldens": len(GOLDEN_CASES), "matched": matched,
        "mismatched": mismatched, "card": card}}))
    check(not mismatched, f"parity streams on the card differ from the goldens: "
          f"{sorted(mismatched)}")
    return {"matched": len(matched)}


@contextlib.contextmanager
def captured_kernel_inputs(log: dict):
    """While active, records the arguments of every K1 and K3 call the codec
    makes (``codec.water_fill_rows`` / ``codec.vbr_reservoir_scan``) under
    log["water_fill"] / log["vbr_scan"], and calls through."""
    from tac_torch import codec

    saved = {"water_fill": codec.water_fill_rows,
             "vbr_scan": codec.vbr_reservoir_scan}

    def recorder(name):
        def call(*args, **kw):
            log.setdefault(name, []).append((args, kw))
            return saved[name](*args, **kw)
        return call

    codec.water_fill_rows = recorder("water_fill")
    codec.vbr_reservoir_scan = recorder("vbr_scan")
    try:
        yield log
    finally:
        codec.water_fill_rows = saved["water_fill"]
        codec.vbr_reservoir_scan = saved["vbr_scan"]


def wall_stats(ms: list, hop_ms: float) -> dict:
    """p50 / p99 / max of per-call wall times (ms) and the share of calls
    slower than the hop."""
    a = np.asarray(ms)
    return {"calls": len(a), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "max_ms": float(a.max()),
            "share_slower_than_hop": float(np.mean(a > hop_ms)),
            "hop_ms": hop_ms}


def seek_ranges(n: int, h: int, seed: int = 7) -> list:
    """tests/test_seek.py's kinds of ranges over n samples at hop h: the
    whole clip, the first and the last sample, aligned, interior, and four
    seeded random ones."""
    rng = np.random.default_rng(seed)
    out = [(0, n), (0, 1), (n - 1, n), (h, 3 * h), (h - 1, h + 1),
           (5 * h + 17, 7 * h - 3)]
    return out + [tuple(int(v) for v in sorted(rng.integers(0, n, 2)))
                  for _ in range(4)]


def fuzz_mutants(data: bytes, off: int, rng, n_flip: int, n_trunc: int,
                 n_prefix: int):
    """tests/test_fuzz.py's mutation families: 1-16 payload bit flips,
    truncations inside the payload, random u16 values over a true length
    prefix."""
    n = len(data)
    for _ in range(n_flip):
        buf = bytearray(data)
        for b in rng.integers(off * 8, n * 8, rng.integers(1, 17)):
            buf[b // 8] ^= 1 << (b % 8)
        yield bytes(buf)
    for _ in range(n_trunc):
        yield data[:int(rng.integers(off, n))]
    prefixes, pos = [], off
    while pos + 2 <= n:
        prefixes.append(pos)
        pos += 2 + (data[pos] | (data[pos + 1] << 8))
    for _ in range(n_prefix):
        buf = bytearray(data)
        p = prefixes[int(rng.integers(0, len(prefixes)))]
        v = int(rng.integers(0, 1 << 16))
        buf[p], buf[p + 1] = v & 0xFF, v >> 8
        yield bytes(buf)


def differing_frames(a: bytes, b: bytes) -> tuple:
    """Two streams of one header: (frames whose blocks differ, the first of
    them or None, frames)."""
    from tac_torch.bitstream import read_header, split_blocks
    from tac_torch.dsp.mdct import num_frames

    hdr, off = read_header(a)
    c = hdr.n_channels
    f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
    (oa, la), (ob, lb) = (split_blocks(d_, read_header(d_)[1], f * c)
                          for d_ in (a, b))
    diff = sorted({i // c for i in range(f * c)
                   if a[oa[i]:oa[i] + la[i]] != b[ob[i]:ob[i] + lb[i]]})
    return len(diff), (diff[0] if diff else None), f


def phase_stream(card: str) -> dict:
    """Phase 12: streaming and random access on the card.

    stream_parity_on_card: the nine golden clips streamed in parity, all in
    one push and in seeded random pushes of 1-699 samples with one
    mid-stream resume from a StreamState blob, each hashing to its golden;
    each stream's StreamDecoder, fed seeded random byte pieces, equals
    decode_array of the same bytes exactly.
    stream_path: PRESETS["streaming-ll"] (mono, H = 256) on 15 s, one
    half-block a push, and PRESETS["vbr-bs"] (stereo, H = 1024) on 15 s in
    1 024-sample pushes, nothing cut; each stream's StreamDecoder fed one
    frame's bytes at a time. Push wall times against the hop, audio-s per
    wall-s, launches per push (a graphed coder's counted on the card by
    the profiler, over the same pushes again); the stream byte-identical
    to the offline encode of the same clip (tac's own contract is bytes
    within 0.1 % and a decode >= 40 dB; K6 and K7 make every push's floats
    the batch's); K1 / K3 on inputs captured from pushes in mid-stream (K3
    from a carried fill above 0) against their plain versions, exactly.
    seek_path: decode_range on a vbr-huffman and a vbr-ms-bs stream of 15 s
    stereo at tests/test_seek.py's ranges, fast within 2e-5 of the full
    decode, and the vbr-ms-bs one in parity exact.
    fuzz_on_card: tests/test_fuzz.py's mutations of raw, VBR, combo and
    ms-combo streams through decode_array, decode_range and
    StreamDecoder.push; a typed error or finite audio of the right shape,
    and the context alive (a synchronize) after every case.
    Returns per kernel its launches on the stream and seek paths and its
    worst error here."""
    import hashlib
    import os

    import torch

    from tac_torch import api, streaming
    from tac_torch.bitstream import CorruptStreamError, read_header
    from tac_torch.config import PRESETS
    from tac_torch.ops import alloc as k1
    from tac_torch.ops import vbr_scan as k3
    from tac_torch.streaming import StreamDecoder, StreamEncoder, StreamState

    dev = torch.device("cuda")
    counters = all_counters()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tools"))
    import golden

    def zero():
        zero_counters(counters)

    def read():
        return read_counters(counters)

    def carried_on(enc, cfg, c):
        """A fresh encoder carrying on from enc's state: its first push
        runs eagerly, so that the kernels are called from Python (a graphed
        encoder replays its later pushes)."""
        fresh = StreamEncoder(cfg, n_channels=c, device=dev)
        fresh.state = StreamState.from_bytes(enc.state.to_bytes())
        return fresh

    def on_card(cfg, x, hop, c, marks, block=128):
        """The timed pass's pushes again (fresh coders, its resumes and
        flush), `block` pushes at a time under the profiler → (encoder's,
        decoder's) launches on the card of each codec kernel."""
        n_push = -(-len(x) // hop)
        enc = StreamEncoder(cfg, n_channels=c, device=dev)
        frames, got = [], [dict.fromkeys(counters, 0) for _ in range(2)]

        def encode(a, b):
            nonlocal enc
            for i in range(a, b):
                if i in marks:
                    enc = carried_on(enc, cfg, c)
                frames.append(enc.push(x[i * hop:(i + 1) * hop]))
            if b == n_push:
                frames.append(enc.flush())

        for a in range(0, n_push, block):
            for k_, v in device_kernel_launches(
                    lambda: encode(a, min(a + block, n_push))).items():
                got[0][k_] += v
        dec = StreamDecoder.from_header(enc.header(len(x)), device=dev)[0]
        frames = [b for b in frames if b]
        for a in range(0, len(frames), block):
            pushes = frames[a:a + block]
            for k_, v in device_kernel_launches(
                    lambda: [dec.push(b) for b in pushes]).items():
                got[1][k_] += v
        return got

    # ---- stream_parity_on_card
    t_phase = time.perf_counter()
    with open(golden.GOLDEN_PATH) as f:
        want = json.load(f)
    material = golden.clips()
    parity = {}
    for name, (preset, change, clip) in GOLDEN_CASES.items():
        x, fs = material[clip]
        cfg = PRESETS[preset].replace(precision="parity", sample_rate=fs,
                                      **change)
        c = x.shape[1]
        enc = StreamEncoder(cfg, n_channels=c, device=dev)
        one = enc.header(len(x)) + enc.push(x) + enc.flush()
        rng = np.random.default_rng(5)
        enc = StreamEncoder(cfg, n_channels=c, device=dev)
        parts, i, resumed = [enc.header(len(x))], 0, False
        while i < len(x):
            n = int(rng.integers(1, 700))
            parts.append(enc.push(x[i:i + n]))
            i += n
            if not resumed and i >= len(x) // 2:
                blob = enc.state.to_bytes()
                enc = StreamEncoder(cfg, n_channels=c, device=dev)
                enc.state = StreamState.from_bytes(blob)
                resumed = True
        chunked = b"".join(parts) + enc.flush()
        dec, off = StreamDecoder.from_header(chunked, precision="parity",
                                             device=dev)
        pieces, pos = [], off
        while pos < len(chunked):
            step = int(rng.integers(1, 1500))
            pieces.append(dec.push(chunked[pos:pos + step]))
            pos += step
        y_stream = np.concatenate(pieces)
        y_full = api.decode_array(chunked, "parity")[0]
        parity[name] = {
            "one_push": hashlib.sha256(one).hexdigest() == want[name]["sha256"],
            "random_pushes_resumed":
                hashlib.sha256(chunked).hexdigest() == want[name]["sha256"],
            "decoder_exact": (y_stream.shape == y_full.shape
                              and bool(np.array_equal(y_stream, y_full)))}
    print(json.dumps({"stream_parity_on_card": {
        "goldens": len(parity), "streams": parity,
        "seconds": time.perf_counter() - t_phase, "card": card}}))
    check(all(all(v.values()) for v in parity.values()),
          "a parity stream on the card differs from its golden or its "
          "decoder from decode_array")

    # ---- stream_path: counters zeroed just before, read just after
    t_phase = time.perf_counter()
    xs = make_switching_clips(1, SECONDS)[0]                 # [2, T]
    cases = (("streaming-ll", PRESETS["streaming-ll"], xs[0].astype(np.float64),
              256),
             ("vbr-bs", PRESETS["vbr-bs"], xs.T.astype(np.float64), 1024))
    offline, t_step = {}, time.perf_counter()
    with torch.no_grad():
        for what, cfg, x, hop in cases:      # warm: 40 pushes, the offline run
            enc = StreamEncoder(cfg, n_channels=x.reshape(len(x), -1).shape[1],
                                device=dev)
            for i in range(40):
                enc.push(x[i * hop:(i + 1) * hop])
            data = api.encode_array(x, cfg)
            offline[what] = (data, api.decode_array(data, "fast")[0])
    steps = {"warm_and_offline_s": time.perf_counter() - t_step}
    zero()
    records, captured = {}, {}
    launches_stream = dict.fromkeys(counters, 0)   # encode + decode windows
    with torch.no_grad():
        for what, cfg, x, hop in cases:
            c = x.reshape(len(x), -1).shape[1]
            before = read()
            enc = StreamEncoder(cfg, n_channels=c, device=dev)
            n_push = -(-len(x) // hop)
            marks = {n_push // 3, n_push // 2, 2 * n_push // 3}
            frames, enc_ms, log = [], [], {}
            t0 = time.perf_counter()
            for i in range(n_push):
                if i in marks:
                    enc = carried_on(enc, cfg, c)
                t1 = time.perf_counter()
                if i in marks:
                    with captured_kernel_inputs(log):
                        b = enc.push(x[i * hop:(i + 1) * hop])
                else:
                    b = enc.push(x[i * hop:(i + 1) * hop])
                enc_ms.append((time.perf_counter() - t1) * 1e3)
                frames.append(b)
            frames.append(enc.flush())
            enc_wall = time.perf_counter() - t0
            mid = read()
            header = enc.header(len(x))
            dec = StreamDecoder.from_header(header, device=dev)[0]
            outs, dec_ms = [], []
            t0 = time.perf_counter()
            for b in frames:
                if not b:
                    continue
                t1 = time.perf_counter()
                outs.append(dec.push(b))
                dec_ms.append((time.perf_counter() - t1) * 1e3)
            dec_wall = time.perf_counter() - t0
            after = read()
            issued = ({k_: mid[k_] - before[k_] for k_ in mid},
                      {k_: after[k_] - mid[k_] for k_ in mid})
            # a graphed coder's replays launch from the card: its launches
            # are the profiler's, over the same pushes again
            t1 = time.perf_counter()
            graphed = streaming.graphed(cfg, dev)
            launched = on_card(cfg, x, hop, c, marks) if graphed else issued
            steps[f"{what}_on_card_s"] = time.perf_counter() - t1
            for k_ in launches_stream:
                launches_stream[k_] += launched[0][k_] + launched[1][k_]
            captured[what] = log
            stream = header + b"".join(frames)
            y_stream = np.concatenate(outs)
            data_off, y_off = offline[what]
            n_diff, first_diff, n_frames = differing_frames(stream, data_off)
            y_full = api.decode_array(stream, "fast")[0]
            err_dec = float(np.abs(y_stream - y_full).max())
            snr_vs_offline = snr_db(y_off.astype(np.float64),
                                    y_stream.astype(np.float64))
            audio_s = len(x) / cfg.sample_rate
            hop_ms = hop / cfg.sample_rate * 1e3
            records[what] = {
                "config": f"{what} fast", "channels": c, "seconds": audio_s,
                "hop_samples": hop, "pushes": n_push,
                "encode_push": wall_stats(enc_ms, hop_ms),
                "encode_audio_s_per_wall_s": audio_s / enc_wall,
                "decode_push": wall_stats(dec_ms, hop_ms),
                "decode_audio_s_per_wall_s": audio_s / dec_wall,
                "launches_counted_by": "profiler" if graphed else "counters",
                "launches_encode": launched[0],
                "launches_decode": launched[1],
                "launches_python_encode": issued[0],
                "launches_python_decode": issued[1],
                "stream_bytes": len(stream), "offline_bytes": len(data_off),
                "frames_differing_from_offline": n_diff,
                "first_differing_frame": first_diff, "frames": n_frames,
                "encode_wall_s": enc_wall, "decode_wall_s": dec_wall,
                "decoder_vs_decode_array_max_abs": err_dec,
                "snr_db_vs_offline_decode": snr_vs_offline}
            records[what]["launches_per_push"] = {
                k_: v / n_push for k_, v in records[what]["launches_encode"].items()}
            check(y_stream.shape == y_full.shape == (len(x), c),
                  f"{what}: streamed decode shape {y_stream.shape}")
            check(err_dec <= 2e-5, f"{what}: StreamDecoder differs from "
                  f"decode_array by {err_dec}")
            check(abs(len(stream) - len(data_off)) <= max(4, len(data_off) // 1000),
                  f"{what}: stream {len(stream)} B vs offline {len(data_off)} B")
            check(snr_vs_offline >= 40.0, f"{what}: streamed decode "
                  f"{snr_vs_offline:.2f} dB from the offline decode")
            check(stream == data_off, f"{what}: {n_diff} of {n_frames} "
                  f"frames differ from the offline encode (first "
                  f"{first_diff})")
            check(all(launched[j][k_] >= issued[j][k_] for j in (0, 1)
                      for k_ in counters),
                  f"{what}: the card launched fewer kernels than Python "
                  f"called: {launched} against {issued}")
    steps["streams_s"] = (time.perf_counter() - t_step
                          - sum(v for v in steps.values()))
    t_step = time.perf_counter()
    print(f"stream path launches: {launches_stream}")
    check(all(launches_stream[k_] > 0 for k_ in kernel_counters()),
          "a kernel of the stream path was never launched")
    check(launches_stream["mdct_fused"] == 0, "K5 launched on the stream path")
    with torch.no_grad():                    # device kernels per push
        for what, cfg, x, hop in cases:
            enc = StreamEncoder(cfg, n_channels=x.reshape(len(x), -1).shape[1],
                                device=dev)
            for i in range(5):
                enc.push(x[i * hop:(i + 1) * hop])
            prof = profile_device(lambda: [enc.push(x[i * hop:(i + 1) * hop])
                                           for i in range(5, 9)])
            records[what]["profile_4_pushes"] = {
                k_: prof[k_] for k_ in ("wall_ms", "device_busy_ms",
                                        "idle_share", "launches")}
            records[what]["device_launches_per_push"] = prof["launches"] / 4
    steps["profile_s"] = time.perf_counter() - t_step

    # the captured mid-stream kernel inputs, kernel against plain
    errs = {"water_fill": 0, "vbr_scan": 0}
    res0_max = 0
    with torch.no_grad():
        for args, kw in captured["streaming-ll"].get("water_fill", []):
            errs["water_fill"] = max(errs["water_fill"], worst_err(
                k1.water_fill_rows(*args, **kw),
                k1.water_fill_rows_plain(*args, **kw)))
        for args, kw in captured["vbr-bs"].get("vbr_scan", []):
            res0_max = max(res0_max, int(args[3].max().item()))
            errs["vbr_scan"] = max(errs["vbr_scan"], worst_err(
                k3.vbr_reservoir_scan(*args, **kw),
                k3.vbr_reservoir_scan_plain(*args, **kw)))
    n_k1 = len(captured["streaming-ll"].get("water_fill", []))
    n_k3 = len(captured["vbr-bs"].get("vbr_scan", []))
    print(f"  K1 on {n_k1} captured streaming-ll pushes: max_abs_err "
          f"{errs['water_fill']}; K3 on {n_k3} captured vbr-bs pushes, "
          f"carried fill up to {res0_max}: max_abs_err {errs['vbr_scan']}")
    check(n_k1 > 0 and n_k3 > 0, "no K1 / K3 input captured in mid-stream")
    check(res0_max > 0, "no captured K3 push resumed from a fill above 0")
    check(errs["water_fill"] == 0 and errs["vbr_scan"] == 0,
          "a kernel differs from its plain version on mid-stream inputs")
    print(json.dumps({"stream_path": {
        **records, "launches": launches_stream,
        "captured_k1_pushes": n_k1, "captured_k3_pushes": n_k3,
        "captured_k3_res0_max": res0_max, "max_abs_err": errs,
        "seconds": time.perf_counter() - t_phase, "seconds_by_step": steps,
        "card": card}}))

    # ---- seek_path: the streams and full decodes first; counters zeroed
    # just before the seeks, read just after
    t_phase = time.perf_counter()
    # one parity stream is enough here: the CPU tests hold parity seeks
    # exact in every family, and a 15 s parity encode costs ~13 s
    seek_cases = {"vbr-huffman": (PRESETS["vbr-huffman"],
                                  make_clips(1, SECONDS)[0].T, ("fast",)),
                  "vbr-ms-bs": (PRESETS["vbr-ms-bs"], xs.T,
                                ("fast", "parity"))}
    streams = {}
    with torch.no_grad():
        for what, (cfg, x, precs) in seek_cases.items():   # not the seek path
            for prec in precs:
                data = api.encode_array(x.astype(np.float64),
                                        cfg.replace(precision=prec))
                streams[what, prec] = (data, api.decode_array(data, prec)[0])
        t_seeks = time.perf_counter()
        zero()
        seeks = {}
        for (what, prec), (data, full) in streams.items():
            h = read_header(data)[0].n_mdct_lines
            worst, ms_ = 0.0, []
            for s0, s1 in seek_ranges(full.shape[0], h):
                t1 = time.perf_counter()
                got = api.decode_range(data, s0, s1, prec)[0]
                ms_.append((time.perf_counter() - t1) * 1e3)
                check(got.shape == (s1 - s0, full.shape[1]),
                      f"seek {what} {prec} {s0}:{s1} shape {got.shape}")
                d = float(np.abs(got - full[s0:s1]).max()) if s1 > s0 else 0.0
                worst = max(worst, d)
            gate = 2e-5 if prec == "fast" else 0.0
            check(worst <= gate, f"seek {what} {prec}: {worst} from the full "
                  "decode")
            seeks[f"{what} {prec}"] = {
                "seeks": len(ms_), "max_abs_vs_full": worst, "gate": gate,
                "ms_mean": float(np.mean(ms_)), "ms_p50": float(np.median(ms_)),
                "ms_max": float(np.max(ms_)), "bytes": len(data)}
        launches_seek = read()
    print(f"seek path launches: {launches_seek}")
    check(launches_seek["huffdec"] > 0, "K4 never launched on the seek path")
    check(launches_seek["mdct_fused"] == 0, "K5 launched on the seek path")
    print(json.dumps({"seek_path": {
        "clip_seconds": SECONDS, "channels": 2, "ranges": seeks,
        "launches": launches_seek, "seconds": time.perf_counter() - t_phase,
        "seconds_seeks": time.perf_counter() - t_seeks, "card": card}}))

    # ---- fuzz_on_card
    t_phase = time.perf_counter()
    base = PRESETS["mono16-64"]
    fams = {"raw": base.replace(precision="fast"),
            "vbr": base.replace(use_huffman=True, precision="fast",
                                use_psy=True, alloc_mode="greedy"),
            "combo": base.replace(use_block_switch=True, use_huffman=True,
                                  n_mdct_lines_short=128, precision="fast"),
            "ms-combo": base.replace(n_channels=2, stereo_mode="ms",
                                     use_block_switch=True, use_huffman=True,
                                     n_mdct_lines_short=128, precision="fast",
                                     use_psy=True, alloc_mode="greedy")}
    t = np.arange(int(16000 * 0.35)) / 16000
    sig = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
    sig[2000:2100] += np.linspace(0, 0.4, 100)
    stereo = np.stack([sig, np.roll(sig, 37) * 0.8], axis=1)

    def via_decode_array(m, rng):
        hdr = read_header(m)[0]
        y = api.decode_array(m, "fast")[0]
        return y, (hdr.num_samples, hdr.n_channels)

    def via_decode_range(m, rng):
        hdr = read_header(m)[0]
        s0, s1 = sorted(int(v) for v in
                        rng.integers(-100, hdr.num_samples + 100, 2))
        lo = min(max(s0, 0), hdr.num_samples)
        hi = max(min(s1, hdr.num_samples), lo)
        return api.decode_range(m, s0, s1, "fast")[0], (hi - lo, hdr.n_channels)

    def via_stream_decoder(m, rng):
        dec, pos = StreamDecoder.from_header(m, device=dev)
        outs = [np.zeros((0, dec.cfg.n_channels), np.float32)]
        while pos < len(m):
            n = int(rng.integers(1, 900))
            outs.append(dec.push(m[pos:pos + n]))
            pos += n
        y = np.concatenate(outs)
        return y, (min(y.shape[0], dec.num_samples), dec.cfg.n_channels)

    surfaces = {"decode_array": via_decode_array,
                "decode_range": via_decode_range,
                "stream_decoder": via_stream_decoder}
    fuzz = {}
    with torch.no_grad():
        for fam, cfg in fams.items():
            data = api.encode_array(stereo if cfg.n_channels == 2 else sig, cfg)
            off = read_header(data)[1]
            for surf, fn in surfaces.items():
                rng = np.random.default_rng(
                    [list(fams).index(fam), list(surfaces).index(surf)])
                tally = {"typed_error": 0, "audio": 0}
                for m in fuzz_mutants(data, off, rng, 40, 12, 12):
                    try:
                        y, shape = fn(m, rng)
                    except (CorruptStreamError, ValueError):
                        tally["typed_error"] += 1
                    else:
                        check(y.shape == shape and bool(np.isfinite(y).all()),
                              f"fuzz {fam} {surf}: shape {y.shape} vs {shape} "
                              "or a non-finite sample")
                        tally["audio"] += 1
                    torch.cuda.synchronize()       # the context is alive
                fuzz[f"{fam} {surf}"] = tally
    print(json.dumps({"fuzz_on_card": {
        "cases": sum(sum(v.values()) for v in fuzz.values()),
        "typed_error": sum(v["typed_error"] for v in fuzz.values()),
        "audio": sum(v["audio"] for v in fuzz.values()), "by_case": fuzz,
        "seconds": time.perf_counter() - t_phase, "card": card}}))

    return {name: {"launches_stream_path": launches_stream[name],
                   "launches_seek_path": launches_seek[name],
                   "max_abs_err": errs.get(name, 0)}
            for name in counters}


CORPUS_STEREO, CORPUS_MONO = 56, 8
LADDER = (8, 16, 32, 64)


def corpus_targets(corpus) -> list:
    """The corpus jobs' file I/O and per-clip fallbacks, for spans_over."""
    return [(corpus.CorpusTranscoder, "_safe_read", "read"),
            (corpus.CorpusDecoder, "_safe_read_bytes", "read"),
            (corpus, "write_wav", "write"),
            (corpus.CorpusTranscoder, "_encode_one", "fallback"),
            (corpus.CorpusDecoder, "_decode_one", "fallback")]


def corpus_material(root: str) -> tuple:
    """The corpus cell's files in root: 56 stereo 44.1 kHz clips of
    make_clips material and 8 mono 16 kHz ones (a second (channels, rate)
    group: make_clips' second channel, the tones with a little noise), each
    cut to a seeded length of 5-15 s, written by the port's write_wav; one
    file that is not RIFF. Returns (wav paths in job order, the non-RIFF
    path, audio per path)."""
    import os

    from tac_torch.io.wav import write_wav

    rng = np.random.default_rng(88)
    stereo = make_clips(CORPUS_STEREO, 15.0, 44100)
    mono = make_clips(CORPUS_MONO, 15.0, 16000)[:, 1]
    paths, audio = [], {}
    for i in range(CORPUS_STEREO + CORPUS_MONO):
        fs = 44100 if i < CORPUS_STEREO else 16000
        n = int(fs * rng.uniform(5.0, 15.0))
        x = stereo[i, :, :n].T if i < CORPUS_STEREO \
            else mono[i - CORPUS_STEREO, :n]
        p = os.path.join(root, f"clip{i:02d}.wav")
        write_wav(p, x, fs)
        paths.append(p)
        audio[p] = (x, fs)
    bad = os.path.join(root, "not_riff.wav")
    with open(bad, "wb") as f:
        f.write(b"this is not a RIFF file" * 10)
    # job order mixes the two groups inside batches
    order = list(rng.permutation(len(paths)))
    return [paths[i] for i in order] + [bad], bad, audio


def corpus_clip_checks(cfg, good: list, pacs: list, dec_dir: str,
                       audio: dict, what: str) -> tuple:
    """Each clip of a corpus job: its decoded WAV in dec_dir against
    decode_array of its .pac (the largest gap in 16-bit LSBs), and its
    decode SNR against a solo encode_array's (fast). Returns (LSBs, clips
    byte-identical to their solo encodes, {clip: (rate, SNR, solo SNR)},
    the worst clip, its SNR gap in dB)."""
    import os

    from tac_torch import api
    from tac_torch.io.wav import read_wav

    lsb, same, diffs = 0.0, 0, {}
    for p, pac in zip(good, pacs):
        x, fs = audio[p]
        x = x[:, None] if x.ndim == 1 else x
        x16 = np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0
        with open(pac, "rb") as f:
            data = f.read()
        y = api.decode_array(data, "fast")[0]
        wav = read_wav(os.path.join(dec_dir, os.path.basename(
            pac)[:-4] + ".wav"))[0]
        ref = np.clip(np.round(y * 32768.0), -32768, 32767) / 32768.0
        check(wav.shape == ref.shape and bool(np.isfinite(y).all()),
              f"{what} {p}: decoded shape")
        lsb = max(lsb, float(np.abs(wav - ref).max()) * 32768.0)
        solo = api.encode_array(x16, cfg.replace(sample_rate=fs,
                                                 n_channels=x.shape[1]))
        same += solo == data
        ys = api.decode_array(solo, "fast")[0]
        diffs[os.path.basename(p)] = (fs, snr_db(x16, y), snr_db(x16, ys))
    worst = max(diffs, key=lambda k: abs(diffs[k][1] - diffs[k][2]))
    return lsb, same, diffs, worst, abs(diffs[worst][1] - diffs[worst][2])


def parity_wavs(root: str, tag: str, good: list, audio: dict) -> list:
    """The parity check's WAVs: the first 2 s of two clips of each group."""
    import os

    from tac_torch.io.wav import write_wav

    two = [os.path.join(root, f"par_{tag}_{i}.wav") for i in range(4)]
    picks = ([p for p in good if audio[p][1] == 44100][:2]
             + [p for p in good if audio[p][1] == 16000][:2])
    for q, p in zip(two, picks):
        x, fs = audio[p]
        write_wav(q, x[:2 * fs], fs)
    return two


def parity_same(cfg, wavs: list, par_dir: str) -> int:
    """How many of a parity corpus job's .pac files in par_dir equal
    encode_array of their WAV in parity precision."""
    import os

    from tac_torch import api
    from tac_torch.io.wav import read_wav

    pcfg, same = cfg.replace(precision="parity"), 0
    for q in wavs:
        x, fs = read_wav(q)
        with open(os.path.join(par_dir, os.path.basename(q)[:-4] + ".pac"),
                  "rb") as f:
            same += f.read() == api.encode_array(
                x, pcfg.replace(sample_rate=fs, n_channels=x.shape[1]))
    return same


def phase_corpus(card: str) -> dict:
    """Phase 13: the corpus path, through the port's CLI as a user calls it
    (``tac_torch.cli.main``, default device and batch), on 64 WAVs of
    5-15 s in two (channels, rate) groups and one file that is not RIFF,
    for PRESETS["corpus"] (fixed rate: K1 + K2) and PRESETS["vbr-huffman"]
    (K3 + K2 on encode, K4 on decode).

    Per family (one ``corpus_path`` line): `corpus` and `corpus-decode`
    audio-s per wall-s, the share of each wall in WAV / PAC reads and writes
    against the device batches, the launches of K1-K5 inside each window,
    a resume of the same job (it must encode nothing) and its wall,
    `corpus-decode` with a truncated .pac planted (it must be corrupt).
    Checks: every clip but the planted files ok; no per-clip fallback in
    either direction; the family's kernels launched; the decoded WAVs
    within one 16-bit LSB of decode_array of the same file; each clip's
    decode SNR within 0.1 dB of its solo encode's; every clip's fast .pac
    byte-identical to its solo encode_array, and in parity precision 4
    clips x 2 s through the corpus. Then ``corpus_pure_tones``: 8 pure-tone
    mono clips through the corpus and solo in both families, byte-identical
    with equal decode SNRs, and each tone's fast SNR (first 2 s) within
    0.1 dB of its parity encode's under the line psy model (printed under
    the band model, which differs by design). Then ``corpus_ladder``: the
    corpus family's encode rate at batch 8 / 16 / 32 / 64 (the better of
    two passes). Returns per kernel its launches on the corpus path, by
    family and window."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    from tac_torch import api, cli, consts, corpus, family, tuning
    from tac_torch.config import PRESETS
    from tac_torch.io.wav import read_wav, write_wav

    counters = all_counters()
    t_phase = time.perf_counter()

    def zero():
        zero_counters(counters)

    def read():
        return read_counters(counters)

    def statuses(manifest: str) -> dict:
        return {k: v["status"] for k, v in
                corpus._load_manifest(manifest).items()}

    def instrumented():
        """Wrap the corpus jobs' I/O, device batches and per-clip
        fallbacks with wall-clock spans for the length of the block."""
        return spans_over(corpus_targets(corpus) + [
            (corpus.CorpusTranscoder, "_encode_batch", "batch"),
            (corpus.CorpusDecoder, "_decode_batch", "batch")])

    def cli_run(argv) -> tuple:
        """(stats, wall s, launches, spans) of one CLI call, the counters
        zeroed just before and read just after."""
        out = io.StringIO()
        with instrumented() as spans, contextlib.redirect_stdout(out):
            zero()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read()
        check(rc == 0, f"corpus CLI {argv[0]} exited {rc}")
        return json.loads(out.getvalue().strip().splitlines()[-1]), wall, \
            launches, spans

    batch = tuning.CORPUS_BATCH
    result, launches_by_family = {}, {}
    with tempfile.TemporaryDirectory() as root, torch.no_grad():
        wavs, bad, audio = corpus_material(root)
        good = [p for p in wavs if p != bad]
        audio_s = sum(len(x) / fs for x, fs in audio.values())
        print(f"corpus: {len(good)} clips ({CORPUS_STEREO} stereo 44.1 kHz, "
              f"{CORPUS_MONO} mono 16 kHz), {audio_s:.1f} s of audio, "
              f"batch {batch}")
        # warm each family once outside the timed windows (cuBLAS handles,
        # the kernels' first loads), on one clip of each group
        pair = [next(p for p in good if audio[p][1] == fs)
                for fs in (44100, 16000)]
        for fam in ("corpus", "vbr-huffman"):
            warm = os.path.join(root, f"warm_{fam}")
            cli_run(["corpus", *pair, "-o", warm, "--preset", fam])
            cli_run(["corpus-decode", *(os.path.join(warm, os.path.basename(
                p)[:-4] + ".pac") for p in pair), "-o", warm + "_dec"])
        for fam in ("corpus", "vbr-huffman"):
            enc_dir = os.path.join(root, f"enc_{fam}")
            dec_dir = os.path.join(root, f"dec_{fam}")
            st, enc_wall, enc_l, enc_sp = cli_run(
                ["corpus", *wavs, "-o", enc_dir, "--preset", fam])
            recs = statuses(os.path.join(enc_dir, "manifest.jsonl"))
            check(all(recs[p] == "ok" for p in good)
                  and recs[bad] == "read_error" and st["ok"] == len(good),
                  f"corpus {fam}: statuses {st}")
            check(enc_sp["fallback"].calls == 0,
                  f"corpus {fam}: a batch took the per-clip fallback")
            # the resume: the same job again encodes nothing
            st_r, resume_wall, _, res_sp = cli_run(
                ["corpus", *wavs, "-o", enc_dir, "--preset", fam])
            check(res_sp["batch"].calls == 0 and st_r["ok"] == len(good),
                  f"corpus {fam}: the resume encoded clips ({st_r})")
            pacs = [os.path.join(enc_dir, os.path.basename(p)[:-4] + ".pac")
                    for p in good]
            planted = os.path.join(root, f"planted_{fam}.pac")
            with open(pacs[0], "rb") as f:
                blob = f.read()
            with open(planted, "wb") as f:
                f.write(blob[:len(blob) // 2])
            st_d, dec_wall, dec_l, dec_sp = cli_run(
                ["corpus-decode", *pacs, planted, "-o", dec_dir])
            drecs = corpus._load_manifest(os.path.join(
                dec_dir, "decode_manifest.jsonl"))
            check(all(drecs[p]["status"] == "ok" for p in pacs)
                  and drecs[planted]["status"] == "corrupt"
                  and st_d["ok"] == len(pacs),
                  f"corpus-decode {fam}: statuses {st_d}")
            check(dec_sp["fallback"].calls == 0,
                  f"corpus-decode {fam}: a batch took the per-stream fallback")
            need = (("water_fill", "scatter_words"), ()) if fam == "corpus" \
                else (("scatter_words", "vbr_scan"), ("huffdec",))
            need = (need[0] + ("row_gemm", "psy_smr"), need[1])
            check(all(enc_l[k] > 0 for k in need[0])
                  and all(dec_l[k] > 0 for k in need[1])
                  and enc_l["mdct_fused"] == dec_l["mdct_fused"] == 0,
                  f"corpus {fam}: launches encode {enc_l} decode {dec_l}")
            launches_by_family[fam] = {"encode": enc_l, "decode": dec_l}

            # each clip: its decoded WAV within one LSB of decode_array of
            # the same file; its decode SNR within 0.1 dB of a solo encode's
            cfg = PRESETS[fam]
            lsb, same, diffs, worst, d_snr = corpus_clip_checks(
                cfg, good, pacs, dec_dir, audio, f"corpus {fam}")

            # parity: 4 clips x 2 s (two of each group) through the corpus
            # == solo, byte for byte
            two = parity_wavs(root, fam, good, audio)
            par_dir = os.path.join(root, f"par_{fam}")
            corpus.CorpusTranscoder(cfg.replace(precision="parity"), par_dir,
                                    batch_size=4).run(two, log=lambda *a: None)
            par_same = parity_same(cfg, two, par_dir)
            enc_b, dec_b = enc_sp["batch"].wall(), dec_sp["batch"].wall()
            result[fam] = {
                "config": f"{fam} fast", "batch": batch,
                "clips_ok": st["ok"], "clips_failed": st["failed"],
                "audio_s": audio_s,
                "encode_audio_s_per_wall_s": audio_s / enc_wall,
                "decode_audio_s_per_wall_s": audio_s / dec_wall,
                "encode_wall_s": enc_wall, "decode_wall_s": dec_wall,
                "encode_share_wav_reads": enc_sp["read"].wall() / enc_wall,
                "encode_share_device_batches": enc_b / enc_wall,
                "decode_share_pac_reads": dec_sp["read"].wall() / dec_wall,
                "decode_share_wav_writes": dec_sp["write"].wall() / dec_wall,
                "decode_share_device_batches": dec_b / dec_wall,
                "batches": [enc_sp["batch"].calls, dec_sp["batch"].calls],
                "fallbacks": [enc_sp["fallback"].calls,
                              dec_sp["fallback"].calls],
                "launches_encode": enc_l, "launches_decode": dec_l,
                "resume_wall_s": resume_wall, "resume_batches":
                    res_sp["batch"].calls,
                "planted": drecs[planted]["status"],
                "planted_error": drecs[planted].get("error"),
                "max_lsb_vs_decode_array": lsb,
                "max_snr_diff_vs_solo_db": d_snr,
                "worst_clip": [worst, *diffs[worst]],
                "snr_diff_vs_solo_db_by_rate": {
                    str(r): max(abs(a - b) for f_, a, b in diffs.values()
                                if f_ == r) for r in (44100, 16000)},
                "clips_over_0.1_db": sorted(
                    k for k, (_, a, b) in diffs.items() if abs(a - b) >= 0.1),
                "fast_bytes_identical_to_solo": int(same),
                "parity_bytes_identical_to_solo": par_same, "card": card}
            print(json.dumps({"corpus_path": result[fam]}))
            # gated after the line is printed, so a failing run still shows
            # every number of the family
            check(lsb <= 1.001, f"corpus {fam}: decoded WAV {lsb} LSB from "
                  "decode_array")
            check(d_snr < 0.1, f"corpus {fam}: decode SNR {d_snr} dB from "
                  f"the solo encode's ({worst})")
            check(par_same == 4, f"corpus {fam}: parity {par_same} / 4 .pac "
                  "files equal their solo encodes")
            check(same == len(good), f"corpus {fam}: fast {same} / "
                  f"{len(good)} .pac files equal their solo encodes")

        # pure tones (make_clips' first channel) at the mono group's rate
        # and lengths, through the corpus and solo: byte-identical (before
        # K6 and K7 a batched and a solo encode fell on either side of
        # 1/16-dB grid ties, and moved a VBR decode SNR by 0.727 dB). The
        # fast SNR of each tone's first 2 s against its parity encode is
        # held within SPEC section 10's 0.1 dB where the psy model is
        # line-granular, as tests/test_parity.py holds it; the band-granular
        # model (the `corpus` family) differs from parity by design
        # (tests/test_parity.py::test_band_default_divergence_bounded), so
        # its gap is printed
        tone_src = make_clips(CORPUS_MONO, 15.0, 16000)[:, 0]
        tone_wavs = []
        for i, p in enumerate(sorted(p for p in good
                                     if audio[p][1] == 16000)):
            q = os.path.join(root, f"tone{i:02d}.wav")
            write_wav(q, tone_src[i, :len(audio[p][0])], 16000)
            tone_wavs.append(q)
        tones = {}
        for fam in ("corpus", "vbr-huffman"):
            cfg = PRESETS[fam].replace(sample_rate=16000, n_channels=1)
            out = os.path.join(root, f"tones_{fam}")
            corpus.CorpusTranscoder(PRESETS[fam], out).run(
                tone_wavs, log=lambda *a: None)
            rows, vs_parity = [], []
            for q in tone_wavs:
                x = read_wav(q)[0]
                with open(os.path.join(out, os.path.basename(q)[:-4]
                                       + ".pac"), "rb") as f:
                    data = f.read()
                solo = api.encode_array(x, cfg)
                rows.append((snr_db(x, api.decode_array(data, "fast")[0]),
                             snr_db(x, api.decode_array(solo, "fast")[0]),
                             data == solo))
                x2 = x[:2 * 16000]
                vs_parity.append(snr_db(x2, api.decode_array(
                    api.encode_array(x2, cfg), "fast")[0]) - snr_db(
                    x2, api.decode_array(api.encode_array(
                        x2, cfg.replace(precision="parity")), "parity")[0]))
            tones[fam] = {
                "psy": "band" if consts.band_thresh(cfg) else "line",
                "fast_minus_parity_snr_db_2s": vs_parity,
                "max_snr_diff_vs_solo_db": max(abs(a - b)
                                               for a, b, _ in rows),
                "clips_over_0.1_db": sum(abs(a - b) >= 0.1
                                         for a, b, _ in rows),
                "snr_db_corpus_solo": [[a, b] for a, b, _ in rows],
                "bytes_identical_to_solo": sum(s_ for _, _, s_ in rows)}
        print(json.dumps({"corpus_pure_tones": {
            "clips": len(tone_wavs), "rate": 16000,
            "gated": "bytes and SNRs equal to solo encodes; fast within "
                     "0.1 dB of parity under the line psy model",
            "by_family": tones, "card": card}}))
        for fam, t_ in tones.items():
            check(t_["bytes_identical_to_solo"] == len(tone_wavs)
                  and t_["max_snr_diff_vs_solo_db"] == 0.0,
                  f"corpus pure tones {fam}: batched encodes differ from "
                  f"solo ({t_})")
            check(t_["psy"] == "band" or max(
                map(abs, t_["fast_minus_parity_snr_db_2s"])) < 0.1,
                f"corpus pure tones {fam}: fast SNR more than 0.1 dB from "
                f"parity ({t_['fast_minus_parity_snr_db_2s']})")

        # zero frames decode to silence through K4
        cv = PRESETS["vbr-huffman"]
        zeros = np.zeros((2, 2, 32, family.payload_words(cv)), np.int32)
        before = counters["huffdec"].launches
        y = corpus.parallel.decode_batch_packed(
            zeros, cv, 31 * cv.n_mdct_lines, pcm16=True)
        check(counters["huffdec"].launches == before + 1 and not y.any(),
              "all-zero VBR rows did not decode to silence through K4")

        # the batch ladder: the corpus family's encode rate by batch size,
        # two passes in opposite orders, the better of each size's two
        ladder = {b: {"audio_s_per_wall_s": 0.0} for b in LADDER}
        for i, b in enumerate(LADDER + LADDER[::-1]):
            _, wall, _, sp = cli_run(
                ["corpus", *wavs, "-o", os.path.join(root, f"ladder{i}"),
                 "--preset", "corpus", "--batch-size", str(b)])
            if audio_s / wall > ladder[b]["audio_s_per_wall_s"]:
                ladder[b] = {"audio_s_per_wall_s": audio_s / wall,
                             "share_device_batches": sp["batch"].wall() / wall,
                             "share_wav_reads": sp["read"].wall() / wall}
        best = max(v["audio_s_per_wall_s"] for v in ladder.values())
        knee = min(b for b, v in ladder.items()
                   if v["audio_s_per_wall_s"] >= 0.9 * best)
        print(json.dumps({"corpus_ladder": {
            "config": "corpus fast", "by_batch": ladder, "knee": knee,
            "rule": "the smallest batch within 10 % of the best rate",
            "default": batch, "card": card}}))
        print(f"corpus phase: {time.perf_counter() - t_phase:.1f} s")
    return {name: {"launches_corpus_path": {
        fam: {w: launches_by_family[fam][w][name] for w in ("encode",
                                                            "decode")}
        for fam in launches_by_family}} for name in counters}


MESH_FAMILIES = ("stereo44-128", "vbr-huffman")
MESH_TIMEOUT_S = 420            # a rank that outlives it fails the run


def mesh_rank(rank: int, world: int, init: str, root: str,
              backend: str) -> int:
    """One rank of phase_mesh, a process of its own (``python3
    chip_smoke.py --mesh-rank R --mesh-world N --mesh-init file://...
    --mesh-root DIR --mesh-backend gloo|nccl``). gloo puts every rank on
    cuda:0; NCCL gives rank r the card r. Writes rank{r}.npz (its shard's
    words and decodes) and rank{r}.json (launches, times, the checks made
    here) into DIR. On a 2-clips mesh: the sharded packed encode and
    decode of each family with its launch counts (K1 / K3 inputs captured
    on rank 1 held against their plain versions), corpus_metrics_sharded,
    the words gathered on rank 0; on a 1 x 2 mesh the frame-sharded
    decode of the flagship FrameCode against decode_clip on rank 0; under
    gloo, the corpus jobs of ROOT/job.json through the mesh."""
    import os

    import torch

    from tac_torch import codec, parallel
    from tac_torch.config import PRESETS
    from tac_torch.ops import alloc as k1
    from tac_torch.ops import vbr_scan as k3

    t0 = time.perf_counter()
    parallel.init_distributed(init, world, rank)
    card0 = "cuda:0" if backend == "gloo" else None
    mesh = parallel.make_mesh(backend=backend, device=card0)
    log = {"rank": rank, "backend": backend, "device": str(mesh.device),
           "bring_up_s": time.perf_counter() - t0, "families": {}}
    arrays = {}
    counters = all_counters()
    x = make_clips(CLIPS, SECONDS) if rank == 0 else None
    with torch.no_grad():
        xs = parallel.shard_clips(x, mesh)
        t = xs.shape[-1]
        captured = {}
        for fam in MESH_FAMILIES:
            cfg = PRESETS[fam]
            parallel.encode_batch_packed_sharded(xs, cfg, mesh)      # warm
            zero_counters(counters)
            cap = captured.setdefault(fam, {})
            with captured_kernel_inputs(cap) if rank == 1 \
                    else contextlib.nullcontext():
                (w, nb), enc_ms = timed(
                    lambda: parallel.encode_batch_packed_sharded(xs, cfg, mesh))
            enc_l = read_counters(counters)
            zero_counters(counters)
            y, dec_ms = timed(lambda: parallel.decode_batch_packed_sharded(
                w, cfg, t, mesh))
            y16 = parallel.decode_batch_packed_sharded(w, cfg, t, mesh,
                                                       pcm16=True)
            torch.cuda.synchronize()
            dec_l = read_counters(counters)
            mean, snr = parallel.corpus_metrics_sharded(xs, y, mesh)
            snr_all = parallel.gather_clips(snr, mesh)
            words_all = parallel.gather_clips(w, mesh)
            log["families"][fam] = {
                "encode_ms": enc_ms, "decode_ms": dec_ms,
                "launches": {"encode": enc_l, "decode": dec_l},
                "mean_snr_db": mean}
            if rank == 0:
                log["families"][fam]["snr_db_gathered"] = \
                    snr_all.cpu().tolist()
                log["families"][fam]["gathered_words_shape"] = \
                    list(words_all.shape)
            for name, a in (("words", w), ("nbits", nb), ("y", y),
                            ("y16", y16)):
                arrays[f"{fam}_{name}"] = a.cpu().numpy()
        if rank == 1:       # one K1 launch's and one K3 launch's inputs
            (a1, kw1), (a3, kw3) = (captured["stereo44-128"]["water_fill"][0],
                                    captured["vbr-huffman"]["vbr_scan"][0])
            log["captured"] = {
                "k1_rows": list(a1[0].shape), "k3_shape": list(a3[0].shape),
                "k1_err": worst_err(k1.water_fill_rows(*a1, **kw1),
                                    k1.water_fill_rows_plain(*a1, **kw1)),
                "k3_err": worst_err(k3.vbr_reservoir_scan(*a3, **kw3),
                                    k3.vbr_reservoir_scan_plain(*a3, **kw3))}
        del captured, xs

        # the frames axis: all 16 clips on both ranks, half the frames each
        mesh12 = parallel.make_mesh(n_clips=1, n_frames=2, backend=backend,
                                    device=card0)
        cfg = PRESETS["stereo44-128"]
        code = parallel.encode_batch_sharded(parallel.shard_clips(x, mesh12),
                                             cfg, mesh12)
        rows, halo_ms = timed(lambda: parallel.decode_batch_sharded(
            code, cfg, t, mesh12))
        y = parallel.gather_frames(rows, mesh12, t)
        log["halo"] = {"frames": code.ovs.shape[2], "rows": list(rows.shape),
                       "decode_ms": halo_ms}
        if rank == 0:
            ref = codec.decode_clip(code, cfg, t, mesh12.device)
            log["halo"]["max_abs_diff"] = float((y - ref).abs().max())
            log["halo"]["shape"] = list(y.shape)
        del code, rows, y

        if backend == "gloo":
            with open(os.path.join(root, "job.json")) as f:
                job = json.load(f)
            log["corpus"] = mesh_corpus_jobs(job, mesh)
    np.savez(os.path.join(root, f"rank{rank}.npz"), **arrays)
    log["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(log, f)
    torch.distributed.destroy_process_group()
    return 0


def mesh_corpus_jobs(job: dict, mesh) -> dict:
    """The corpus jobs of phase_mesh on every rank of `mesh` (each rank
    calls run; the leader does the files): per family the encode, its
    decode, a resume of the single-device job's manifest and the parity
    check. On the leader, each window's wall and its shares in file
    reads and writes, in the scatters and gathers (``parallel.shard_clips``
    / ``gather_clips``, gloo through host memory) and in the leader's own
    shard; and the per-clip fallbacks."""
    import torch

    from tac_torch import corpus, parallel
    from tac_torch.config import PRESETS

    quiet, out = dict(log=lambda *a: None), {}
    targets = corpus_targets(corpus) + [
        (parallel, "shard_clips", "scatter"),
        (parallel, "gather_clips", "gather"),
        (corpus.CorpusTranscoder, "_run_shard", "shard"),
        (corpus.CorpusDecoder, "_run_shard", "shard")]

    def window(fn):
        """(fn(), wall s, {kind: share of the wall}, fallbacks)."""
        with spans_over(targets) as spans:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return res, wall, {k: sp.wall() / wall for k, sp in spans.items()
                           if k != "fallback"}, spans["fallback"].calls

    for fam in MESH_FAMILIES:
        j, cfg = job["families"][fam], PRESETS[fam]
        enc, enc_s, enc_sh, enc_fb = window(lambda: corpus.CorpusTranscoder(
            cfg, j["enc"], mesh=mesh).run(job["wavs"], **quiet))
        dec, dec_s, dec_sh, dec_fb = window(lambda: corpus.CorpusDecoder(
            j["dec"], mesh=mesh).run(j["pacs"], **quiet))
        res, res_s, _, _ = window(lambda: corpus.CorpusTranscoder(
            cfg, j["single_enc"], mesh=mesh).run(job["wavs"], **quiet))
        corpus.CorpusTranscoder(cfg.replace(precision="parity"), j["par"],
                                batch_size=4, mesh=mesh).run(
            j["par_wavs"], **quiet)
        out[fam] = {"encode": enc, "encode_wall_s": enc_s,
                    "encode_shares": enc_sh,
                    "decode": dec, "decode_wall_s": dec_s,
                    "decode_shares": dec_sh,
                    "resume": res, "resume_wall_s": res_s,
                    "fallbacks": {"encode": enc_fb, "decode": dec_fb}}
    return out


def start_ranks(world: int, backend: str, root: str) -> list:
    """`world` rank processes of this script, rendezvous through a file in
    root; their output goes to root/rank{r}.log."""
    import os

    init = "file://" + os.path.join(root, f"rendezvous_{backend}")
    procs = []
    for r in range(world):
        log = open(os.path.join(root, f"rank{r}_{backend}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
             "--mesh-world", str(world), "--mesh-init", init,
             "--mesh-root", root, "--mesh-backend", backend],
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def wait_ranks(procs: list, what: str) -> None:
    """Every rank must exit 0 within MESH_TIMEOUT_S; any that has not is
    killed, and the run fails with the end of each rank's log."""
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [(r, p.returncode) for r, (p, _) in enumerate(procs)
           if p.returncode != 0]
    for r, rc in bad:
        with open(procs[r][1].name) as f:
            print(f"--- {what} rank {r} exited {rc}:\n{f.read()[-4000:]}",
                  file=sys.stderr)
    check(not bad, f"{what}: ranks {bad} failed or outlived "
          f"{MESH_TIMEOUT_S} s")


def load_ranks(root: str, world: int) -> list:
    import os

    out = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            log = json.load(f)
        out.append((log, dict(np.load(os.path.join(root, f"rank{r}.npz")))))
    return out


def check_sharded_path(ranks: list, x: np.ndarray, single: dict,
                       what: str) -> dict:
    """The rank logs and arrays of one mesh run against this process's own
    runs on the card: each rank's words equal the full batch's words for
    its clips (K6 and K7 make a row's floats independent of the batch
    shape); each rank's decodes equal the decode of its own words; the gathered SNRs within 0.1 dB of the full batch's; the mean
    of every rank equal to the gathered SNRs' mean (relative 1e-6); K1-K4
    launched on their families, K5 not; the captured K1 / K3 inputs equal
    their plain versions; the frame-sharded decode within 1e-6."""
    import torch

    from tac_torch import parallel
    from tac_torch.config import PRESETS
    from tac_torch.dsp.mdct import num_frames

    dev = torch.device("cuda")
    b = CLIPS // len(ranks)
    fams = {}
    for fam in MESH_FAMILIES:
        cfg = PRESETS[fam]
        same_w = same_y = True
        _, w_full, nb_full = single[fam]
        for r, (log, arr) in enumerate(ranks):
            same_w &= bool(np.array_equal(arr[f"{fam}_words"],
                                          w_full[r * b:(r + 1) * b])
                           and np.array_equal(arr[f"{fam}_nbits"],
                                              nb_full[r * b:(r + 1) * b]))
            words = torch.as_tensor(arr[f"{fam}_words"], device=dev)
            y = parallel.decode_batch_packed(words, cfg, x.shape[-1],
                                             device=dev)
            y16 = parallel.to_pcm16(y)
            same_y &= bool(np.array_equal(arr[f"{fam}_y"], y.cpu().numpy())
                           and np.array_equal(arr[f"{fam}_y16"],
                                              y16.cpu().numpy()))
        lead = ranks[0][0]["families"][fam]
        snrs = np.array(lead["snr_db_gathered"])
        d_snr = float(np.abs(snrs - single[fam][0]).max())
        means = [log["families"][fam]["mean_snr_db"] for log, _ in ranks]
        mean_err = max(abs(m - snrs.mean()) / abs(snrs.mean()) for m in means)
        launches = [log["families"][fam]["launches"] for log, _ in ranks]
        need = (("water_fill", "scatter_words"), ()) \
            if fam == "stereo44-128" else (("scatter_words", "vbr_scan"),
                                           ("huffdec",))
        need = (need[0] + ("row_gemm", "psy_smr"), need[1])
        fams[fam] = {
            "words_equal_full_batch": same_w,
            "decodes_equal_single_process": same_y,
            "max_snr_diff_vs_full_batch_db": d_snr,
            "mean_snr_db": means, "mean_rel_err_vs_gathered": mean_err,
            "gathered_words_shape": lead["gathered_words_shape"],
            "encode_ms_by_rank": [log["families"][fam]["encode_ms"]
                                  for log, _ in ranks],
            "decode_ms_by_rank": [log["families"][fam]["decode_ms"]
                                  for log, _ in ranks],
            "launches_by_rank": launches}
        check(same_w, f"{what} {fam}: a rank's words differ from the full "
              "batch's words for its clips")
        check(same_y, f"{what} {fam}: a rank's decode differs from the "
              "single-process decode of its words")
        check(d_snr < 0.1, f"{what} {fam}: SNR {d_snr} dB from the full "
              "batch's")
        check(mean_err <= 1e-6, f"{what} {fam}: mean SNR {means} against "
              f"the gathered {snrs.mean()}")
        check(all(l_["encode"][k] > 0 for l_ in launches for k in need[0])
              and all(l_["decode"][k] > 0 for l_ in launches for k in need[1])
              and all(l_[w_]["mdct_fused"] == 0 for l_ in launches
                      for w_ in ("encode", "decode")),
              f"{what} {fam}: launches {launches}")
    cap = ranks[1][0]["captured"]
    halo = ranks[0][0]["halo"]
    check(cap["k1_err"] == 0 and cap["k3_err"] == 0,
          f"{what}: captured K1 / K3 inputs differ from the plain versions "
          f"({cap})")
    f = num_frames(x.shape[-1], PRESETS["stereo44-128"].n_mdct_lines)
    check(halo["frames"] == f and halo["rows"][2] == -(-f // 2)
          and halo["shape"] == [CLIPS, 2, x.shape[-1]]
          and halo["max_abs_diff"] <= 1e-6,
          f"{what}: frame-sharded decode {halo}")
    return {"families": fams, "captured_on_rank_1": cap, "halo_1x2": halo,
            "bring_up_s": [log["bring_up_s"] for log, _ in ranks],
            "rank_wall_s": [log["wall_s"] for log, _ in ranks],
            "devices": [log["device"] for log, _ in ranks]}


def full_batch(x: np.ndarray) -> dict:
    """Per family of the mesh phase, (per-clip SNRs, words, nbits) of one
    batched encode and decode of all of x on the card, in one process."""
    import torch

    from tac_torch import parallel
    from tac_torch.config import PRESETS

    out = {}
    with torch.no_grad():
        for fam in MESH_FAMILIES:
            cfg = PRESETS[fam]
            w, nb = parallel.encode_batch_packed(x, cfg, "cuda")
            y = parallel.decode_batch_packed(w, cfg, x.shape[-1],
                                             device="cuda").cpu().numpy()
            out[fam] = (np.array([snr_db(x[i].astype(np.float64),
                                         y[i].astype(np.float64))
                                  for i in range(len(x))]),
                        w.cpu().numpy(), nb.cpu().numpy())
    return out


def phase_mesh(x: np.ndarray, card: str) -> dict:
    """Phase 14: the mesh (tac_torch.parallel's mesh half, the corpus under
    a mesh), two rank processes of this script on the one card over gloo
    (NCCL runs no two ranks of one communicator on one card), 8 clips per
    rank of the 16 x 15 s: ``mesh_path`` (``check_sharded_path``) and
    ``mesh_corpus``: the corpus cell of phase 13 (64 WAVs and a non-RIFF
    file, both families) through CorpusTranscoder / CorpusDecoder(mesh=)
    against the same jobs on one process run here first: statuses equal,
    every clip once in the manifest, a resume of the single-device
    manifest that encodes nothing, no per-clip fallback, decodes within
    one LSB of decode_array and 0.1 dB of solo encodes, parity bytes
    equal solo encodes; rates printed beside the single process's, not
    gated. Then a 1-rank NCCL mesh in this process (sharded encode, words
    equal the batch's, corpus_metrics_sharded) and, with two or more
    cards, the sharded path on 2 NCCL ranks on cards 0 and 1. Returns
    per kernel its launches on the mesh path, by rank and family."""
    import os
    import tempfile

    import torch

    from tac_torch import corpus, parallel, tuning
    from tac_torch.config import PRESETS

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    quiet = dict(log=lambda *a: None)
    with tempfile.TemporaryDirectory() as root, torch.no_grad():
        # this process first: the full batch's SNRs, then the corpus jobs
        single = full_batch(x)
        wavs, bad, audio = corpus_material(root)
        good = [p for p in wavs if p != bad]
        audio_s = sum(len(a) / fs for a, fs in audio.values())
        job, single_rates = {"wavs": wavs, "families": {}}, {}
        for fam in MESH_FAMILIES:
            d = {k: os.path.join(root, f"{k}_{fam}") for k in
                 ("enc", "dec", "single_enc", "single_dec", "par")}
            d["pacs"] = [os.path.join(d["enc"], os.path.basename(p)[:-4]
                                      + ".pac") for p in good]
            d["par_wavs"] = parity_wavs(root, fam, good, audio)
            job["families"][fam] = d
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = corpus.CorpusTranscoder(PRESETS[fam], d["single_enc"]).run(
                wavs, **quiet)
            t1 = time.perf_counter()
            corpus.CorpusDecoder(d["single_dec"]).run(
                [os.path.join(d["single_enc"], os.path.basename(p))
                 for p in d["pacs"]], **quiet)
            torch.cuda.synchronize()
            single_rates[fam] = (audio_s / (t1 - t0),
                                 audio_s / (time.perf_counter() - t1))
            check(st["ok"] == len(good), f"single-device corpus {fam}: {st}")
        with open(os.path.join(root, "job.json"), "w") as f:
            json.dump(job, f)

        t0 = time.perf_counter()
        wait_ranks(start_ranks(2, "gloo", root), "gloo mesh")
        ranks_wall = time.perf_counter() - t0
        ranks = load_ranks(root, 2)
        path = check_sharded_path(ranks, x, single, "gloo mesh")

        corpus_out = {}
        for fam in MESH_FAMILIES:
            d, cfg = job["families"][fam], PRESETS[fam]
            co = ranks[0][0]["corpus"][fam]
            check(all(log["corpus"][fam]["encode"] == co["encode"]
                      for log, _ in ranks),
                  f"mesh corpus {fam}: the ranks' stats differ")
            recs = [json.loads(line) for line in open(os.path.join(
                d["enc"], "manifest.jsonl"))]
            single_st = corpus._load_manifest(os.path.join(
                d["single_enc"], "manifest.jsonl"))
            once = len(recs) == len({r_["clip"] for r_ in recs}) == len(wavs)
            check(once and {r_["clip"]: r_["status"] for r_ in recs}
                  == {k: v["status"] for k, v in single_st.items()},
                  f"mesh corpus {fam}: the manifest differs from the "
                  "single-device job's statuses")
            resumed = [json.loads(line) for line in open(os.path.join(
                d["single_enc"], "manifest.jsonl"))]
            check(co["resume"]["ok"] == len(good)
                  and co["resume"]["audio_s"] == 0.0
                  and len(resumed) == len(wavs) + 1,  # the read_error again
                  f"mesh corpus {fam}: the resume encoded clips "
                  f"({co['resume']})")
            check(co["fallbacks"] == {"encode": 0, "decode": 0},
                  f"mesh corpus {fam}: per-clip fallbacks {co['fallbacks']}")
            check(co["decode"]["ok"] == len(good),
                  f"mesh corpus-decode {fam}: {co['decode']}")
            lsb, same, diffs, worst, d_snr = corpus_clip_checks(
                cfg, good, d["pacs"], d["dec"], audio, f"mesh corpus {fam}")
            par_same = parity_same(cfg, d["par_wavs"], d["par"])
            corpus_out[fam] = {
                "config": f"{fam} fast", "ranks": 2, "backend": "gloo",
                "batch": 2 * tuning.CORPUS_BATCH, "audio_s": audio_s,
                "encode_audio_s_per_wall_s": audio_s / co["encode_wall_s"],
                "decode_audio_s_per_wall_s": audio_s / co["decode_wall_s"],
                "single_process_encode_audio_s_per_wall_s":
                    single_rates[fam][0],
                "single_process_decode_audio_s_per_wall_s":
                    single_rates[fam][1],
                "clips_ok": co["encode"]["ok"],
                "clips_failed": co["encode"]["failed"],
                "encode_shares_leader": co["encode_shares"],
                "decode_shares_leader": co["decode_shares"],
                "resume_wall_s": co["resume_wall_s"],
                "manifest_records": len(recs),
                "max_lsb_vs_decode_array": lsb,
                "max_snr_diff_vs_solo_db": d_snr, "worst_clip": [worst,
                                                                 *diffs[worst]],
                "fast_bytes_identical_to_solo": int(same),
                "parity_bytes_identical_to_solo": par_same, "card": card}
            print(json.dumps({"mesh_corpus": corpus_out[fam]}))
            check(lsb <= 1.001, f"mesh corpus {fam}: {lsb} LSB from "
                  "decode_array")
            check(d_snr < 0.1, f"mesh corpus {fam}: decode SNR {d_snr} dB "
                  f"from the solo encode's ({worst})")
            check(par_same == 4, f"mesh corpus {fam}: parity {par_same} / 4 "
                  ".pac files equal their solo encodes")

        # NCCL's bring-up and all_reduce on the card: a 1-rank mesh here
        t0 = time.perf_counter()
        parallel.init_distributed("file://" + os.path.join(root, "nccl1"),
                                  1, 0)
        try:
            mesh = parallel.make_mesh(backend="nccl")
            cfg = PRESETS["stereo44-128"]
            xs = parallel.shard_clips(x, mesh)
            w, _ = parallel.encode_batch_packed_sharded(xs, cfg, mesh)
            got = parallel.gather_clips(w, mesh)
            want, _ = parallel.encode_batch_packed(x, cfg, dev)
            y = parallel.decode_batch_packed_sharded(w, cfg, x.shape[-1],
                                                     mesh)
            mean, snr = parallel.corpus_metrics_sharded(xs, y, mesh)
            nccl1 = {"device": str(mesh.device),
                     "words_equal_single_process": bool(torch.equal(got,
                                                                    want)),
                     "mean_snr_db": mean,
                     "mean_rel_err": abs(mean - float(snr.double().mean()))
                     / abs(mean), "wall_s": time.perf_counter() - t0}
        finally:
            torch.distributed.destroy_process_group()
        check(nccl1["words_equal_single_process"]
              and nccl1["mean_rel_err"] <= 1e-6, f"1-rank NCCL mesh {nccl1}")

        if torch.cuda.device_count() >= 2:
            root2 = os.path.join(root, "nccl2")
            os.makedirs(root2)
            wait_ranks(start_ranks(2, "nccl", root2), "NCCL mesh")
            nccl2 = check_sharded_path(load_ranks(root2, 2), x, single,
                                       "NCCL mesh")
        else:
            nccl2 = {"ran": False, "why": "one card: NCCL runs no two ranks "
                     "of one communicator on one card"}
            print("mesh: 2 NCCL ranks on two cards did not run: this machine "
                  "has one card")
        launches = [log["families"] for log, _ in ranks]
        print(json.dumps({"mesh_path": {
            "ranks": 2, "backend": "gloo", "clips_per_rank": CLIPS // 2,
            "clip_seconds": SECONDS, **path, "ranks_wall_s": ranks_wall,
            "nccl_1_rank": nccl1, "nccl_2_cards": nccl2, "card": card}}))
        print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return {name: {"launches_mesh_path": [
        {fam: {w_: fams[fam]["launches"][w_][name] for w_ in ("encode",
                                                              "decode")}
         for fam in MESH_FAMILIES} for fams in launches]}
        for name in all_counters()}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of tac_torch on "
                                 "one GPU; the --mesh-* flags run one rank "
                                 "of the mesh phase.")
    ap.add_argument("--mesh-rank", type=int)
    ap.add_argument("--mesh-world", type=int)
    ap.add_argument("--mesh-init")
    ap.add_argument("--mesh-root")
    ap.add_argument("--mesh-backend", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import tac_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tac_torch package is not importable ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank, args.mesh_world, args.mesh_init,
                         args.mesh_root, args.mesh_backend)
    from tac_torch import _build, api, bitalloc, codec, family
    from tac_torch import huffman as hf
    from tac_torch.config import PRESETS
    from tac_torch.ops import alloc as k1
    from tac_torch.ops import bitpack
    from tac_torch.ops import huffdec as k4
    from tac_torch.ops import pack as k2
    from tac_torch.ops import vbr_scan as k3

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card)                     # name, power limit (nvidia-smi's own line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- 2. build
    for name, (secs, out) in _build.build_all().items():
        print(f"build {name}: {secs:.1f} s")
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling")):
                print(f"  {line.strip()}")

    # ---- main-path material and the flagship's kernel inputs
    cfg = PRESETS["stereo44-128"]
    x = make_clips(CLIPS, SECONDS, cfg.sample_rate)
    xd = torch.as_tensor(x, device=dev)
    c = codec.make_consts(cfg, dev)
    frames = codec.fb.frame_signal(xd, cfg.n_mdct_lines).reshape(
        -1, 2 * cfg.n_mdct_lines)
    rows = frames.shape[0]
    cap = codec.payload_capacity_bits(cfg, c)
    w32 = -(-cap // 32)
    smr_q, fields = [], []
    for fc in frames.split(codec.ENC_CHUNK):
        lines, smr = codec.analyze_frame(fc, cfg, c)
        smr_q.append(bitalloc.snap_smr(smr).float())
        code = codec.quantize_given_alloc(lines, codec.allocate_rows(smr, cfg, c),
                                          cfg, c)
        fields.append(bitpack.field_words(*codec.payload_fields(code, cfg, c))[:3])
    smr_q = torch.cat(smr_q).contiguous()
    c0, c1, word0 = (torch.cat(f).contiguous() for f in zip(*fields))
    budgets = torch.full((rows,), c.budget, dtype=torch.int32, device=dev)
    print(f"flagship: {rows} rows x {smr_q.shape[1]} bands, "
          f"{c0.shape[1]} fields, W32 = {w32}")

    # ---- 3a. K6 / K7 against their plain versions; the invariance
    # diagnostic before (library products and cumsums) and after
    k6_entry, k7_entry = phase_row_kernels(frames, card)
    k8_entry = phase_psy_kernel(frames, card)
    phase_batch_invariance(card)

    # ---- 3. kernel checks: kernel == plain on the card
    def k1_case(name, s, nl, bud):
        got = k1.water_fill_rows(s, nl, bud)
        want = k1.water_fill_rows_plain(s, nl, bud)
        err = (got.long() - want.long()).abs().max().item() if got.numel() else 0
        print(f"  K1 {name}: {tuple(s.shape)} max_abs_err {err}")
        check(err == 0, f"K1 {name} differs from its plain version")
        return err, got

    rng = np.random.default_rng(1)
    nl = c.n_lines
    r_rand = 4096
    rand_smr = torch.as_tensor(rng.normal(10, 25, (r_rand, 25)), dtype=torch.float32,
                               device=dev)
    rand_bud = torch.as_tensor(rng.choice([0, 5, 12, 600, 1282, 5000], r_rand),
                               dtype=torch.int32, device=dev)
    ties = torch.tensor([[0.0] * 25, [90.0] * 25, [-90.0] * 25,
                         [50.0] * 5 + [-50.0] * 20], device=dev)
    nl2 = torch.cat([nl, nl]).contiguous()
    joint = torch.as_tensor(rng.normal(10, 25, (1024, 50)), dtype=torch.float32,
                            device=dev)
    per_row_nl = torch.as_tensor(rng.integers(0, 60, (2048, 25)), dtype=torch.int32,
                                 device=dev)
    fma_s, fma_nl, fma_bud, fma_want = FMA_ROW
    fma_fused = fused_water_fill(np.float32(fma_s), np.array(fma_nl), fma_bud).tolist()
    check(fma_fused != fma_want,
          "the FMA row does not separate fused from unfused arithmetic")
    with torch.no_grad():
        # the plain run of the comparison counts the chain's greedy-loop
        # trips after the warm start (grants + freezes) over all rows
        k1.water_fill_rows_plain.trips = 0
        k1_err, flag_alloc = k1_case("flagship smr", smr_q, nl, budgets)
        k1_trips = k1.water_fill_rows_plain.trips / rows
        for case in (("random", bitalloc.snap_smr(rand_smr), nl, rand_bud),
                     ("ties/extremes", ties, nl,
                      torch.full((4,), c.budget, dtype=torch.int32, device=dev)),
                     ("joint 50-band", bitalloc.snap_smr(joint), nl2,
                      torch.full((1024,), 2 * c.budget, dtype=torch.int32,
                                 device=dev)),
                     ("per-row n_lines", bitalloc.snap_smr(rand_smr[:2048]),
                      per_row_nl, rand_bud[:2048].contiguous())):
            k1_err = max(k1_err, k1_case(*case)[0])
        fma = k1.water_fill_rows(torch.tensor([fma_s], device=dev),
                                 torch.tensor(fma_nl, dtype=torch.int32, device=dev),
                                 torch.tensor([fma_bud], dtype=torch.int32, device=dev))
        print(f"  K1 FMA row: kernel {fma.tolist()[0]} unfused {fma_want} "
              f"fused {fma_fused}")
        check(fma.tolist()[0] == fma_want, "K1 FMA row")

        k2_got = k2.scatter_words_rows(c0, c1, word0, w32=w32)
        k2_want = k2.scatter_words_rows_plain(c0, c1, word0, w32=w32)
        k2_err = int((k2_got.long() - k2_want.long()).abs().max().item())
        print(f"  K2 flagship fields: {tuple(c0.shape)} -> {tuple(k2_got.shape)} "
              f"max_abs_err {k2_err}")
        check(k2_err == 0, "K2 differs from its plain version")

        # ---- timing (CUDA events). `ms`, `plain_ms` and `library_ms` run
        # the main path's own launch shapes: one call per ENC_CHUNK rows, all
        # of one flagship encode's rows. `ms_one_launch` puts all rows in one.
        n_chunks = -(-rows // codec.ENC_CHUNK)
        k1_ms = cuda_ms(per_chunk(lambda s, b: k1.water_fill_rows(s, nl, b),
                                  smr_q, budgets), 50)
        # the same 11 launches under the profiler: the card's own kernel
        # time beside the host's wall, which the chunked events measure
        k1_prof = profile_device(per_chunk(
            lambda s, b: k1.water_fill_rows(s, nl, b), smr_q, budgets))
        k1_one_ms = cuda_ms(lambda: k1.water_fill_rows(smr_q, nl, budgets), 50)
        k1_plain_ms = cuda_ms(per_chunk(
            lambda s, b: k1.water_fill_rows_plain(s, nl, b), smr_q, budgets),
            3, warmup=1)
        k2_ms = cuda_ms(per_chunk(
            lambda a, b, w: k2.scatter_words_rows(a, b, w, w32=w32),
            c0, c1, word0), 50)
        k2_one_ms = cuda_ms(lambda: k2.scatter_words_rows(c0, c1, word0, w32=w32),
                            50)
        k2_plain_ms = cuda_ms(per_chunk(
            lambda a, b, w: k2.scatter_words_rows_plain(a, b, w, w32=w32),
            c0, c1, word0), 3, warmup=1)

        def library_pack(a0, a1, w0, w1):
            buf = torch.zeros((a0.shape[0], w32 + 2), dtype=torch.int64,
                              device=dev)
            buf.scatter_add_(1, w0, a0)
            buf.scatter_add_(1, w1, a1)
            return buf

        w0l = word0.long()
        k2_lib_ms = cuda_ms(per_chunk(library_pack, c0.long() & 0xFFFFFFFF,
                                      c1.long() & 0xFFFFFFFF, w0l, w0l + 1), 20)
        del w0l

    k1_bytes = smr_q.numel() * 8 + rows * 4 + nl.numel() * 4
    # the least arithmetic this run's data needs: a greedy over a heap of
    # the B needs does a subtract and 2 log2(B) compares per granted bit
    k1_ops = int(flag_alloc.sum().item()) * (
        1 + 2 * int(np.ceil(np.log2(smr_q.shape[1]))))
    k2_bytes = c0.numel() * 12 + rows * w32 * 4
    k2_ops = c0.numel() * 4             # two bounds checks + two ORs a field

    del c0, c1, word0, fields

    # ---- 4. main path: counters zeroed just before, read just after
    def encode():
        return family.encode_clip_packed(xd, cfg, dev)

    encode()                                            # warm (caches)
    main_counters = kernel_counters()
    zero_counters(main_counters)
    a_ev, b_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a_ev.record()
    words, nbits = encode()
    b_ev.record()
    torch.cuda.synchronize()
    enc_ms = a_ev.elapsed_time(b_ev)
    check(tuple(words.shape) == (CLIPS, 2, rows // (2 * CLIPS), w32),
          f"encode words shape {tuple(words.shape)}")
    t0 = time.perf_counter()
    streams = [api.encode_array(x[i].T, cfg) for i in range(CLIPS)]
    t_enc_full = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = [api.decode_array(s, "fast")[0] for s in streams]
    t_dec_full = time.perf_counter() - t0
    launches = read_counters(main_counters)
    print(f"main path launches: {launches}")
    check(all(launches[k_] > 0 for k_ in ("water_fill", "scatter_words",
                                          "row_gemm", "psy_smr")),
          "a kernel of the main path was never launched")

    snrs = decode_checks(x, decoded, "fixed-rate")
    # card vs the port's CPU run on clip 0, first 2 s
    x0 = x[0].T[: 2 * cfg.sample_rate]
    gpu_snr, cpu_snr = card_vs_cpu(x0, cfg, "fixed-rate")

    prof = profile_device(encode)
    print(json.dumps({"profile": {"what": "one batched device encode", **prof}}))

    audio_s = CLIPS * SECONDS
    print(json.dumps({"main_path": {
        "config": "stereo44-128 fast", "clips": CLIPS, "clip_seconds": SECONDS,
        "rows": rows,
        "device_encode_ms": enc_ms,
        "audio_s_per_s_device": audio_s / (enc_ms / 1e3),
        "audio_s_per_s_full_encode": audio_s / t_enc_full,
        "audio_s_per_s_full_decode": audio_s / t_dec_full,
        "snr_db": snrs, "clip0_2s_snr_card": gpu_snr, "clip0_2s_snr_cpu": cpu_snr,
        "stream_bytes": sum(len(s) for s in streams), "card": card}}))


    # ---- 5. the VBR slice: kernel inputs at the VBR run's own shapes
    cfg_v = PRESETS["vbr-huffman"]
    cv = codec.make_consts(cfg_v, dev)
    lanes, n_fr = 2 * CLIPS, rows // (2 * CLIPS)
    w32_v = -(-codec.payload_capacity_bits(cfg_v, cv) // 32)
    base_v, cap_v = cv.budget, cfg_v.reservoir_factor * cv.budget
    n_sets_v = cfg_v.huffman_sets

    with torch.no_grad():
        lines_v, smr_fl, bh_fl = codec._vbr_phase1_lanes(
            frames.reshape(lanes, n_fr, 1, -1), cfg_v, cv)
        smr_fl = bitalloc.snap_smr(smr_fl).float().contiguous()
    res0_v = torch.zeros(lanes, dtype=torch.int32, device=dev)
    print(f"vbr: {lanes} lanes x {n_fr} frames x {smr_fl.shape[2]} bands, "
          f"{bh_fl.shape[3]} cost columns, base {base_v}, cap {cap_v}, "
          f"W32 = {w32_v}")

    def k3_case(name, s_, bh_, nl_, r0_, base, cap_):
        got = k3.vbr_reservoir_scan(s_, bh_, nl_, r0_, base=base, cap=cap_)
        want, plain_ms = timed(lambda: k3.vbr_reservoir_scan_plain(
            s_, bh_, nl_, r0_, base=base, cap=cap_))
        err = worst_err(got, want)
        print(f"  K3 {name}: {tuple(s_.shape)} x {bh_.shape[3]} columns "
              f"max_abs_err {err}")
        check(err == 0, f"K3 {name} differs from its plain version")
        return err, got, plain_ms

    # the plain run of the comparison counts the chain's greedy-loop trips
    # after the warm start (grants + freezes, over all lanes and frames)
    k1.water_fill_rows_plain.trips = 0

    def k3_inputs(f_, l_, nl_np, sets):
        nb_ = len(nl_np)
        s_ = bitalloc.snap_smr(torch.as_tensor(
            rng.normal(8, 22, (f_, l_, nb_)), dtype=torch.float32, device=dev))
        m_ = rng.integers(2, 9, (f_, l_, nb_, 7 * sets))
        bh_ = (m_ * nl_np[None, None, :, None] * rng.uniform(0.7, 1.3, m_.shape))
        return s_.contiguous(), bh_.astype(np.int32)

    def dev_i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev) \
            .contiguous()

    nl_np = nl.cpu().numpy()
    raw_cost = (np.arange(2, 9)[None, :] * nl_np[:, None]).astype(np.int32)
    with torch.no_grad():
        k3_err, k3_out, k3_plain_ms = k3_case("vbr run", smr_fl, bh_fl, nl, res0_v,
                                              base_v, cap_v)
        k3_trips = k1.water_fill_rows_plain.trips / (lanes * n_fr)
        zeros4 = torch.zeros(4, dtype=torch.int32, device=dev)
        for sets in (1, 3):
            s_, bh_ = k3_inputs(8, 4, nl_np, sets)
            k3_err = max(k3_err, k3_case(f"{sets} set(s)", s_, dev_i32(bh_), nl,
                                         zeros4, 700, 2800)[0])
        s_, bh_ = k3_inputs(8, 4, nl_np, 2)
        bh_[0, 0, :, :7] = raw_cost                       # set 1 == raw
        bh_[1, 1, :, 7:] = bh_[1, 1, :, :7]               # set 2 == set 1
        bh_[2, 2, :, 7:] = np.minimum(bh_[2, 2, :, :7], raw_cost) - 1
        err, got, _ = k3_case("forced ties", s_, dev_i32(bh_), nl, zeros4, 700, 2800)
        tid_t = got[1].cpu().numpy()
        check(tid_t[0, 0] != 1 and tid_t[1, 1] != 2 and tid_t[2, 2] == 2,
              "K3 tie order raw <= set 1 <= set 2")
        nl_short = 2 * codec.bands.lines_per_band(cfg_v.sample_rate, 512)
        nl_pf = np.where(rng.random((8, 4, 1)) < 0.4, nl_short, nl_np)
        k3_err = max(k3_err, err, k3_case("per-frame n_lines", s_, dev_i32(bh_),
                                          dev_i32(nl_pf), zeros4, 650, 2600)[0])
        r0 = dev_i32(rng.integers(1, 2800, 4))
        err, full, _ = k3_case("res0 != 0", s_, dev_i32(bh_), nl, r0, 700, 2800)
        bh_d = dev_i32(bh_)
        head = k3.vbr_reservoir_scan(s_[:3].contiguous(), bh_d[:3].contiguous(), nl,
                                     r0, base=700, cap=2800)
        tail = k3.vbr_reservoir_scan(s_[3:].contiguous(), bh_d[3:].contiguous(), nl,
                                     head[3][-1].contiguous(), base=700, cap=2800)
        split = worst_err(full, [torch.cat([h_, t_]) for h_, t_ in zip(head, tail)])
        print(f"  K3 split chain (3 + 5 frames) vs whole: max_abs_err {split}")
        check(split == 0, "K3 split chain differs from the whole chain")
        s2_, bh2_ = k3_inputs(8, 4, np.concatenate([nl_np, nl_np]), 2)
        k3_err = max(k3_err, err, split, k3_case(
            "joint 50-band", s2_, dev_i32(bh2_), nl2, zeros4, 1400, 5600)[0])
        err, got, _ = k3_case(
            "FMA row", torch.tensor([[fma_s]], device=dev),
            torch.zeros((1, 1, 2, 7), dtype=torch.int32, device=dev),
            dev_i32(fma_nl), zeros4[:1].contiguous(), fma_bud, 4 * fma_bud)
        print(f"  K3 FMA row: kernel {got[0].tolist()[0][0]} unfused {fma_want}")
        check(got[0].tolist()[0][0] == fma_want, "K3 FMA row")
        k3_err = max(k3_err, err)

        k3_ms = cuda_ms(lambda: k3.vbr_reservoir_scan(
            smr_fl, bh_fl, nl, res0_v, base=base_v, cap=cap_v), 5, warmup=1)
        smr_c0, bh_c0 = smr_fl[:, :2].contiguous(), bh_fl[:, :2].contiguous()
        k3_clip_ms = cuda_ms(lambda: k3.vbr_reservoir_scan(
            smr_c0, bh_c0, nl, res0_v[:2].contiguous(), base=base_v, cap=cap_v),
            5, warmup=1)
        # K2 at the VBR rows' shape: the first chunk's 2+2B+2H fields
        ch = codec.ENC_CHUNK
        code_v = codec.quantize_given_alloc(
            lines_v[:ch], k3_out[0].transpose(0, 1).reshape(rows, -1)[:ch],
            cfg_v, cv)
        c0v, c1v, w0v = bitpack.field_words(*codec.payload_fields_vbr(
            code_v, k3_out[1].transpose(0, 1).reshape(rows)[:ch], cfg_v, cv))[:3]
        k2v_err = worst_err(k2.scatter_words_rows(c0v, c1v, w0v, w32=w32_v),
                            k2.scatter_words_rows_plain(c0v, c1v, w0v, w32=w32_v))
        print(f"  K2 vbr chunk fields: {tuple(c0v.shape)} -> W32 {w32_v} "
              f"max_abs_err {k2v_err}")
        check(k2v_err == 0, "K2 differs from its plain version at VBR shapes")
        k2_vbr_chunk_ms = cuda_ms(lambda: k2.scatter_words_rows(
            c0v, c1v, w0v, w32=w32_v), 50)
        del lines_v, code_v, c0v, c1v, w0v
    k3_bytes = (smr_fl.numel() + bh_fl.numel() + k3_out[0].numel()
                + 3 * lanes * n_fr + nl.numel() + lanes) * 4
    # least arithmetic for this run's data: the heap greedy of K1's bound per
    # granted bit, plus one add per band and priced total (raw and each set)
    k3_ops = (int(k3_out[0].sum().item())
              * (1 + 2 * int(np.ceil(np.log2(smr_fl.shape[2]))))
              + smr_fl.numel() * (1 + n_sets_v))
    del smr_c0, bh_c0

    # ---- K4 at the VBR run's shapes: the words the VBR encode produces
    def encode_v():
        return family.encode_clip_packed(xd, cfg_v, dev)

    with torch.no_grad():
        words_v, nbits_v = encode_v()               # also warms the path
        check(tuple(words_v.shape) == (CLIPS, 2, n_fr, w32_v),
              f"VBR encode words shape {tuple(words_v.shape)}")
        check(int(nbits_v.max().item()) <= 32 * w32_v, "VBR row over capacity")
        wf = words_v.reshape(-1, w32_v).contiguous()
        _, tid_v, _, _, m_line_v, mant_start_v = codec._vbr_head(wf, cfg_v, cv)
        tid_share = (torch.bincount(tid_v.long(), minlength=4).float()
                     / tid_v.numel()).tolist()
        print(f"  tid shares (raw, set 1, set 2, set 3): "
              f"{[round(v, 4) for v in tid_share]}")
        check(sum(tid_share[1:]) > 0, "no Huffman-coded frame in the VBR run")
        sets_present = [sid for sid in range(1, len(cv.huff) + 1)
                        if tid_share[sid] > 0]
        raw_v = codec.read_raw_mantissas(wf, mant_start_v[:, None].long(),
                                         m_line_v)

        def k4_case(name, w_, ms_, ml_, tid_, raw_, huff):
            """K4's multi-set entry against its plain version, each on its
            own copy of the raw reading (the kernel fills the Huffman rows
            of its copy in place)."""
            got = k4.huffman_decode_sets(w_, ms_, ml_, tid_, raw_.clone(), huff)
            want, plain_ms = timed(lambda: k4.huffman_decode_sets_plain(
                w_, ms_, ml_, tid_, raw_.clone(), huff))
            err = worst_err(got, want)
            print(f"  K4 {name}: words {tuple(w_.shape)} lines {ml_.shape[1]} "
                  f"sets {len(huff)} max_abs_err {err}")
            check(err == 0, f"K4 {name} differs from its plain version")
            return err, got, plain_ms

        # ms: one decode's launch over all 20 704 rows, every set at once;
        # ms_per_clip_launch: one clip's 1 294 rows
        k4_err, _, k4_plain_ms = k4_case("vbr run", wf, mant_start_v, m_line_v,
                                         tid_v, raw_v, cv.huff)
        out_v = raw_v.clone()           # the timed launches write into it
        k4_ms = cuda_ms(lambda: k4.huffman_decode_sets(
            wf, mant_start_v, m_line_v, tid_v, out_v, cv.huff), 20)
        rows_clip = 2 * n_fr
        wc, sc, mc, tc_, rc = (t[:rows_clip].contiguous() for t in
                               (wf, mant_start_v, m_line_v, tid_v, raw_v))
        k4_clip_ms = cuda_ms(lambda: k4.huffman_decode_sets(
            wc, sc, mc, tc_, rc, cv.huff), 20)
        n_walk = int(((tid_v >= 1) & (tid_v <= len(cv.huff))).sum().item())

        def random_rows(k_, h_, w_):
            words = rng.integers(0, 1 << 32, (k_, w_), dtype=np.uint64) \
                .astype(np.uint32).view(np.int32)
            return (dev_i32(words), dev_i32(rng.integers(0, 200, k_)),
                    dev_i32(rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 13, 16],
                                       (k_, h_))),
                    dev_i32(rng.choice([0, 1, 2, 3, 7], k_)),
                    dev_i32(rng.integers(0, 1 << 16, (k_, h_))))

        # sizes outside [2, 8], escapes, tids of no loaded set; each set
        # alone (as tableId 1), then all three
        for sid in range(1, len(cv.huff) + 1):
            k4_err = max(k4_err, k4_case(f"random bits, set {sid} alone",
                                         *random_rows(1000, 200, w32_v),
                                         (cv.huff[sid - 1],))[0])
        k4_err = max(k4_err, k4_case("random bits, all sets",
                                     *random_rows(1000, 200, w32_v), cv.huff)[0])
        k4_err = max(k4_err, k4_case("walks past the payload",
                                     *random_rows(100, 128, 6), cv.huff)[0])
        # a table whose m = 2 codes leave a peek uncovered: length 0, a stall
        tab = dict(hf.host_tables(1))
        pak = np.array(tab["dec_pak"])
        lmax = pak.shape[1].bit_length() - 1
        pak[0, -(1 << (lmax - int((pak[0] >> 16).max()))):] = 0
        tab["dec_pak"] = pak
        hc_stall = hf.device_tables(tab, dev)
        peek = int(np.flatnonzero(pak[0] == 0)[0])
        w_, ms_, ml_, tid_, raw_ = random_rows(64, 128, 64)
        w_[0] = int(np.uint32(peek << (32 - lmax)).view(np.int32))
        ml_[0] = 2
        ms_[0] = 0
        tid_[:] = 1
        err, got, _ = k4_case("stalling table", w_, ms_, ml_, tid_, raw_,
                              (hc_stall,))
        check(bool((got[0] == 0).all()), "K4 stall row moved")
        k4_err = max(k4_err, err)
    # each byte once: the walked rows' words, m_line and output, every row's
    # tid and mant_start, the sets' compact LUTs
    k4_bytes = (4 * (n_walk * (w32_v + 2 * m_line_v.shape[1]) + 2 * rows)
                + sum(2 * hc.lut.numel() + 4 * 7 for hc in cv.huff))
    # per walked line: the window shift, the index, the size tests, the
    # escape test, the value select and the cursor and buffer shifts
    k4_ops = n_walk * m_line_v.shape[1] * 8
    del wf, m_line_v, mant_start_v, raw_v, out_v, wc, sc, mc, tc_, rc

    # ---- 6. VBR path: counters zeroed just before, read just after
    counters = kernel_counters()
    zero_counters(counters)
    (words_v, nbits_v), enc_v_ms = timed(encode_v)
    y_batch, dec_v_ms = timed(lambda: family.decode_clip_packed(
        words_v, cfg_v, x.shape[-1], dev))
    t0 = time.perf_counter()
    streams_v = [api.encode_array(x[i].T, cfg_v) for i in range(CLIPS)]
    t_enc_full_v = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded_v = [api.decode_array(s_, "fast")[0] for s_ in streams_v]
    t_dec_full_v = time.perf_counter() - t0
    launches_v = {name: fn.launches for name, fn in counters.items()}
    print(f"vbr path launches: {launches_v}")
    check(all(launches_v[k_] > 0 for k_ in ("scatter_words", "vbr_scan", "huffdec",
                                            "row_gemm", "psy_smr")),
          "a kernel of the VBR path was never launched")

    snrs_v = decode_checks(x, decoded_v, "VBR")
    # the batched decode against a solo decode of the same words (clip 0);
    # f32 IMDCT matmuls of two batch shapes: within 1e-5
    y0 = family.decode_clip_packed(words_v[0], cfg_v, x.shape[-1], dev)
    check(float((y0 - y_batch[0]).abs().max()) < 1e-5,
          "batched VBR decode differs from the solo decode of the same words")
    snr_batch = decode_checks(x, y_batch.cpu().numpy().swapaxes(1, 2),
                              "batched VBR")
    gpu_snr_v, cpu_snr_v = card_vs_cpu(x0, cfg_v, "VBR")

    prof_v = profile_device(encode_v)
    print(json.dumps({"profile_vbr": {"what": "one batched VBR device encode",
                                      **prof_v}}))
    print(json.dumps({"vbr_path": {
        "config": "vbr-huffman fast", "clips": CLIPS, "clip_seconds": SECONDS,
        "rows": rows, "lanes": lanes, "frames": n_fr,
        "device_encode_ms": enc_v_ms, "device_decode_ms": dec_v_ms,
        "audio_s_per_s_device": audio_s / (enc_v_ms / 1e3),
        "audio_s_per_s_device_decode": audio_s / (dec_v_ms / 1e3),
        "audio_s_per_s_full_encode": audio_s / t_enc_full_v,
        "audio_s_per_s_full_decode": audio_s / t_dec_full_v,
        "tid_share": tid_share, "sets_walked": sets_present,
        "launches": launches_v, "snr_db": snrs_v, "snr_db_batched": snr_batch,
        "clip0_2s_snr_card": gpu_snr_v, "clip0_2s_snr_cpu": cpu_snr_v,
        "stream_bytes": sum(len(s_) for s_ in streams_v), "card": card}}))

    # ---- 7-9. K5 and the filterbank path; block switching, both ways
    del xd, frames, words_v, nbits_v, words, nbits
    torch.cuda.empty_cache()
    k5_entry = phase_k5(x, card)
    xs = make_switching_clips(CLIPS, SECONDS, cfg.sample_rate)
    bs = phase_block_switch(xs, card)
    ms = phase_ms(x, xs, {"stereo44-128": (snrs, sum(len(s) for s in streams)),
                          "vbr-huffman": (snrs_v, sum(len(s_) for s_ in streams_v))},
                  card)
    phase_parity_on_card(card)
    phase_zero_line_parity(card)
    st = phase_stream(card)
    co = phase_corpus(card)
    me = phase_mesh(x, card)

    def with_bs(entry: dict) -> dict:
        """A kernel's entry plus what the block-switch, M/S, streaming,
        corpus and mesh phases measured."""
        for extra in (dict(ph.get(entry["name"], {}))
                      for ph in (bs, ms, st, co, me)):
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       extra.pop("max_abs_err", 0))
            entry = {**entry, **extra}
        return entry

    b1, b1_by = bound(k1_bytes, k1_ops)
    b2, b2_by = bound(k2_bytes, k2_ops)
    b3, b3_by = bound(k3_bytes, k3_ops)
    b4, b4_by = bound(k4_bytes, k4_ops)
    kernels = [with_bs(entry) for entry in (
        {"name": "water_fill", "route": "cuda",
         "source": "tac_torch/csrc/water_fill.cu",
         "replaces": "tac/ops/pallas_alloc.py:308",
         "launches": launches["water_fill"], "ok": True,
         "design": f"warp per row, {k1.WARM_ROUNDS} x {k1.WARM_BISECT} warm "
                   "start counting events by estimate and fix-up",
         "max_abs_err": k1_err, "trips_per_row": k1_trips,
         "ms": k1_ms, "ms_one_launch": k1_one_ms, "chunks": n_chunks,
         "device_ms_chunks": k1_prof["device_busy_ms"],
         "wall_ms_chunks_profiled": k1_prof["wall_ms"],
         "plain_ms": k1_plain_ms, "bound_ms": b1, "bound_by": b1_by,
         "library_ms": None},
        {"name": "scatter_words", "route": "cuda",
         "source": "tac_torch/csrc/scatter_words.cu",
         "replaces": "tac/ops/pallas_pack.py:161",
         "launches": launches["scatter_words"],
         "launches_vbr_path": launches_v["scatter_words"], "ok": True,
         "max_abs_err": max(k2_err, k2v_err), "ms": k2_ms,
         "ms_one_launch": k2_one_ms, "ms_vbr_chunk_launch": k2_vbr_chunk_ms,
         "chunks": n_chunks, "plain_ms": k2_plain_ms, "bound_ms": b2,
         "bound_by": b2_by, "library_ms": k2_lib_ms},
        # ms: the batched VBR encode's one launch (32 lanes x 647 frames);
        # plain_ms: the one plain run that the comparison above made
        {"name": "vbr_scan", "route": "cuda",
         "source": "tac_torch/csrc/vbr_scan.cu",
         "replaces": "tac/ops/pallas_vbr_scan.py:191",
         "launches": launches_v["vbr_scan"], "ok": True,
         "design": "rows by cp.async ring, DEC in a register, one-reduce grant, "
                   f"{k3.WARM_ROUNDS} x {k3.WARM_BISECT} warm start counting "
                   "events by estimate and fix-up",
         "max_abs_err": k3_err, "ms": k3_ms, "ms_per_clip_launch": k3_clip_ms,
         "us_per_frame": k3_ms * 1e3 / n_fr, "trips_per_frame": k3_trips,
         "us_per_trip": k3_ms * 1e3 / (n_fr * k3_trips),
         "plain_ms": k3_plain_ms, "bound_ms": b3, "bound_by": b3_by,
         "library_ms": None},
        # ms: the batched VBR decode's one launch over all 20 704 rows, every
        # set at once; plain_ms: the plain version over the same rows
        {"name": "huffdec", "route": "cuda",
         "source": "tac_torch/csrc/huffdec.cu",
         "replaces": "tac/ops/pallas_huffdec.py:175",
         "launches": launches_v["huffdec"], "ok": True,
         "design": "thread per row, one launch per decode, every set's compact "
                   "peek LUT in shared memory, bits in a register buffer fed "
                   "four words ahead, branch-free line",
         "max_abs_err": k4_err,
         "ms": k4_ms, "ms_per_clip_launch": k4_clip_ms, "sets_walked": sets_present,
         "plain_ms": k4_plain_ms, "bound_ms": b4, "bound_by": b4_by,
         "library_ms": None},
    )] + [with_bs({**entry, "launches": launches[entry["name"]],
                   "launches_vbr_path": launches_v[entry["name"]]})
          for entry in (k6_entry, k7_entry, k8_entry)] + [{**k5_entry,
           "launches_stream_path": st["mdct_fused"]["launches_stream_path"],
           "launches_seek_path": st["mdct_fused"]["launches_seek_path"],
           "launches_corpus_path": co["mdct_fused"]["launches_corpus_path"],
           "launches_mesh_path": me["mdct_fused"]["launches_mesh_path"]}]
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
