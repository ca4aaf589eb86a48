"""Command line: ``python -m tac_torch.cli {encode,decode,info,bench,corpus,
corpus-decode} ...`` (counterpart of tac/cli.py, same subcommands and
flags), plus ``--device``: the commands run on the card (``cuda``, the
default) unless ``--device cpu`` is given; without a card they exit
non-zero and write nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tac_torch.config import PRESETS, CodecConfig, resolve_device


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="named config (BASELINE.json evaluation rungs)")
    p.add_argument("--bitrate", type=int, help="total bits/s across channels")
    p.add_argument("--lines", type=int, help="nMDCTLines (long block H)")
    p.add_argument("--window", choices=["sine", "kbd", "hann"])
    p.add_argument("--alloc", dest="alloc_mode",
                   choices=["greedy", "uniform", "const_snr", "const_mnr"])
    p.add_argument("--no-psy", action="store_true")
    p.add_argument("--huffman", action="store_true")
    p.add_argument("--huffman-sets", dest="huffman_sets", type=int,
                   choices=[1, 2, 3],
                   help="trained table sets to price (default 2; 3 adds "
                        "the side-channel/low-rate set, SPEC.md §8)")
    p.add_argument("--blockswitch", action="store_true")
    p.add_argument("--stereo", dest="stereo_mode", choices=["lr", "ms"],
                   help="ms = mid/side transform + joint allocation "
                        "(SPEC.md §11; even channel counts only)")
    p.add_argument("--precision", choices=["parity", "fast"])


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain PyTorch path)")


def _build_config(args, fs: int | None = None, n_ch: int | None = None
                  ) -> CodecConfig:
    cfg = PRESETS[args.preset] if args.preset else CodecConfig()
    kw = {}
    if fs is not None:
        kw["sample_rate"] = fs
    if n_ch is not None:
        kw["n_channels"] = n_ch
    if args.bitrate:
        kw["bitrate_bps"] = args.bitrate
    if args.lines:
        kw["n_mdct_lines"] = args.lines
    if args.window:
        kw["window"] = args.window
    if args.alloc_mode:
        kw["alloc_mode"] = args.alloc_mode
    if args.no_psy:
        kw["use_psy"] = False
    if args.huffman:
        kw["use_huffman"] = True
    if args.huffman_sets:
        kw["huffman_sets"] = args.huffman_sets
    if args.blockswitch:
        kw["use_block_switch"] = True
    if args.stereo_mode:
        kw["stereo_mode"] = args.stereo_mode
    if args.precision:
        kw["precision"] = args.precision
    return cfg.replace(**kw) if kw else cfg


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tac-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="WAV → PAC-T")
    pe.add_argument("input")
    pe.add_argument("output")
    _add_config_flags(pe)
    pe.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace (Chrome / Perfetto "
                         "JSON) to DIR")

    pd = sub.add_parser("decode", help="PAC-T → WAV")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.add_argument("--precision", choices=["parity", "fast"],
                    default="fast", help="parity = the f64 FFT path")
    pd.add_argument("--start", type=float, default=None, metavar="SEC",
                    help="random access: first output second "
                         "(api.decode_range, only the covering frames)")
    pd.add_argument("--duration", type=float, default=None, metavar="SEC",
                    help="random access: seconds to decode from --start")

    pi = sub.add_parser("info", help="print the PAC-T header as JSON")
    pi.add_argument("input")

    pb = sub.add_parser("bench", help="single-clip encode throughput")
    pb.add_argument("input", nargs="?", default=None,
                    help="WAV file (default: synthetic 30 s stereo)")
    _add_config_flags(pb)

    pc = sub.add_parser("corpus", help="batch-transcode WAVs → PAC-T "
                        "(manifest resume, per-clip quarantine)")
    pc.add_argument("inputs", nargs="+", help="WAV files")
    pc.add_argument("-o", "--out-dir", required=True)
    pc.add_argument("--batch-size", type=int, default=None,
                    help="clips per device batch (default: "
                         "tuning.CORPUS_BATCH)")
    _add_config_flags(pc)

    pcd = sub.add_parser("corpus-decode", help="batch-decode PAC-T → WAVs "
                         "(manifest resume, per-clip quarantine)")
    pcd.add_argument("inputs", nargs="+", help="PAC-T files")
    pcd.add_argument("-o", "--out-dir", required=True)
    pcd.add_argument("--batch-size", type=int, default=None)
    pcd.add_argument("--precision", choices=["parity", "fast"],
                     default="fast")

    for p in (pe, pd, pb, pc, pcd):
        _add_device_flag(p)
    return ap


def _synchronize(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    dev = None
    if args.cmd != "info":
        try:
            dev = resolve_device(args.device)
        except RuntimeError as e:
            print(f"tac-torch: {e}", file=sys.stderr)
            return 2

    if args.cmd == "encode":
        from tac_torch import api
        from tac_torch.io.wav import read_wav

        x, fs = read_wav(args.input)
        cfg = _build_config(args, fs=fs, n_ch=x.shape[1])
        t0 = time.time()
        if args.profile:
            import os

            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                stats = api.encode(args.input, args.output, cfg, dev)
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile,
                                                  "encode_trace.json"))
        else:
            stats = api.encode(args.input, args.output, cfg, dev)
        stats["encode_s"] = round(time.time() - t0, 3)
        print(json.dumps(stats))
        return 0

    if args.cmd == "decode":
        from tac_torch import api

        t0 = time.time()
        if args.start is not None or args.duration is not None:
            from tac_torch import bitstream as bs
            from tac_torch.io.wav import write_wav

            with open(args.input, "rb") as f:
                data = f.read()
            hdr, _ = bs.read_header(data)
            s0 = int(round((args.start or 0.0) * hdr.sample_rate))
            s1 = (s0 + int(round(args.duration * hdr.sample_rate))
                  if args.duration is not None else hdr.num_samples)
            x, fs = api.decode_range(data, s0, s1, args.precision, dev)
            write_wav(args.output, x, fs)
            stats = {"seconds": x.shape[0] / fs, "sample_rate": fs,
                     "channels": x.shape[1], "start_sample": s0}
        else:
            stats = api.decode(args.input, args.output, args.precision, dev)
        stats["decode_s"] = round(time.time() - t0, 3)
        print(json.dumps(stats))
        return 0

    if args.cmd == "info":
        from tac_torch import bitstream as bs

        with open(args.input, "rb") as f:
            data = f.read()
        hdr, off = bs.read_header(data)
        d = {k: (v.tolist() if hasattr(v, "tolist") else v)
             for k, v in vars(hdr).items()}
        d["header_bytes"] = off
        d["total_bytes"] = len(data)
        print(json.dumps(d))
        return 0

    if args.cmd == "bench":
        import numpy as np

        from tac_torch import api

        if args.input:
            from tac_torch.io.wav import read_wav

            x, fs = read_wav(args.input)
        else:
            fs = 44100
            rng = np.random.default_rng(0)
            t = np.arange(fs * 30) / fs
            x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                          0.4 * np.sin(2 * np.pi * 554 * t)], 1)
            x += 0.01 * rng.standard_normal(x.shape)
        cfg = _build_config(args, fs=fs, n_ch=x.shape[1])
        api.encode_array(x, cfg, dev)                # warm: kernels, caches
        _synchronize(dev)
        t0 = time.time()
        data = api.encode_array(x, cfg, dev)
        _synchronize(dev)
        dt = time.time() - t0
        dur = x.shape[0] / fs
        print(json.dumps({"audio_s": dur, "encode_s": round(dt, 4),
                          "throughput_x": round(dur / dt, 2),
                          "kbps": round(len(data) * 8 / dur / 1000, 1),
                          "device": str(dev)}))
        return 0

    if args.cmd == "corpus":
        from tac_torch.corpus import CorpusTranscoder

        tc = CorpusTranscoder(_build_config(args), args.out_dir,
                              batch_size=args.batch_size, device=dev)
        print(json.dumps(tc.run(args.inputs)))
        return 0

    from tac_torch.corpus import CorpusDecoder

    dec = CorpusDecoder(args.out_dir, batch_size=args.batch_size,
                        precision=args.precision, device=dev)
    print(json.dumps(dec.run(args.inputs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
