#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tac_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:
  1. card: the GPU's name and power limit (nvidia-smi's line, alone), torch
     and CUDA versions;
  2. build: every CUDA kernel from tac_torch/csrc (one nvcc per source, all
     started together), with nvcc's register / shared-memory / spill lines;
  3. kernel checks at the flagship's shapes: each kernel equals its plain
     PyTorch version exactly, on the card, including a constructed row
     where a fused multiply-add would change the water-fill's decision;
  4. main path: PRESETS["stereo44-128"] (fast) on 16 clips x 15 s stereo —
     the batched device encode (timed with CUDA events), then
     encode_array → bytes → decode_array per clip; the launch counters are
     zeroed just before and read just after, and every kernel must have
     launched; the card's SNR on clip 0 (first 2 s) must be within 0.1 dB
     of the port's own CPU run; then one encode under torch.profiler
     (device time by kernel, idle share).
It prints "profile", "main_path" and "kernels" JSON lines, and last
{"ok": true, "device": {...}}. Without CUDA, or without the tac_torch
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # CUDA cores, outside the tensor cores

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import tac_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tac_torch package is not importable ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2
    from tac_torch import _build, api, bitalloc, codec
    from tac_torch.config import PRESETS
    from tac_torch.ops import alloc as k1
    from tac_torch.ops import bitpack
    from tac_torch.ops import pack as k2

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
        max_err, flag_alloc = k1_case("flagship smr", smr_q, nl, budgets)
        for case in (("random", bitalloc.snap_smr(rand_smr), nl, rand_bud),
                     ("ties/extremes", ties, nl,
                      torch.full((4,), c.budget, dtype=torch.int32, device=dev)),
                     ("joint 50-band", bitalloc.snap_smr(joint), nl2,
                      torch.full((1024,), 2 * c.budget, dtype=torch.int32,
                                 device=dev)),
                     ("per-row n_lines", bitalloc.snap_smr(rand_smr[:2048]),
                      per_row_nl, rand_bud[:2048].contiguous())):
            max_err = max(max_err, k1_case(*case)[0])
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
        def per_chunk(fn, *ts):
            chunks = list(zip(*(t.split(codec.ENC_CHUNK) for t in ts)))
            return lambda: [fn(*ch) for ch in chunks]

        n_chunks = -(-rows // codec.ENC_CHUNK)
        k1_ms = cuda_ms(per_chunk(lambda s, b: k1.water_fill_rows(s, nl, b),
                                  smr_q, budgets), 50)
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

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    del c0, c1, word0, fields

    # ---- 4. main path: counters zeroed just before, read just after
    def encode():
        return codec.encode_clip_packed(xd, cfg, dev)

    encode()                                            # warm (cuBLAS, caches)
    torch.cuda.synchronize()
    k1.water_fill_rows.launches = 0
    k2.scatter_words_rows.launches = 0
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
    launches = {"water_fill": k1.water_fill_rows.launches,
                "scatter_words": k2.scatter_words_rows.launches}
    print(f"main path launches: {launches}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")

    snrs = []
    for i, y in enumerate(decoded):
        check(y.shape == x[i].T.shape and bool(np.isfinite(y).all()),
              f"clip {i} decode shape/finite")
        snrs.append(snr_db(x[i].T.astype(np.float64), y.astype(np.float64)))
    check(min(snrs) > 10.0, f"clip SNR too low: {min(snrs):.2f} dB")
    # card vs the port's CPU run on clip 0, first 2 s
    x0 = x[0].T[: 2 * cfg.sample_rate]
    gpu_snr = snr_db(x0, api.decode_array(api.encode_array(x0, cfg), "fast")[0])
    cpu_snr = snr_db(x0, api.decode_array(
        api.encode_array(x0, cfg, device="cpu"), "fast", device="cpu")[0])
    print(f"clip 0 (2 s): card SNR {gpu_snr:.4f} dB, CPU SNR {cpu_snr:.4f} dB")
    check(abs(gpu_snr - cpu_snr) < 0.1, "card SNR differs from the CPU run")

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

    b1, b1_by = bound(k1_bytes, k1_ops)
    b2, b2_by = bound(k2_bytes, k2_ops)
    kernels = [
        {"name": "water_fill", "route": "cuda",
         "source": "tac_torch/csrc/water_fill.cu",
         "replaces": "tac/ops/pallas_alloc.py:308",
         "launches": launches["water_fill"], "ok": True, "max_abs_err": max_err,
         "ms": k1_ms, "ms_one_launch": k1_one_ms, "chunks": n_chunks,
         "plain_ms": k1_plain_ms, "bound_ms": b1, "bound_by": b1_by,
         "library_ms": None},
        {"name": "scatter_words", "route": "cuda",
         "source": "tac_torch/csrc/scatter_words.cu",
         "replaces": "tac/ops/pallas_pack.py:161",
         "launches": launches["scatter_words"], "ok": True,
         "max_abs_err": k2_err, "ms": k2_ms, "ms_one_launch": k2_one_ms,
         "chunks": n_chunks, "plain_ms": k2_plain_ms, "bound_ms": b2,
         "bound_by": b2_by, "library_ms": k2_lib_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
