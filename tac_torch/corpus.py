"""Corpus transcoding in device batches, with manifest resume and per-clip
quarantine (counterpart of tac/corpus.py; BASELINE config 4).

  * Clips are grouped by (channels, sample rate), padded with zeros to a
    common bucket length (a multiple of 32 half-blocks) and encoded in one
    batched call (parallel.encode_batch_packed). The bucket's zeros are
    the codec's own flush padding, so each clip's rows up to its true frame
    count are those of a solo encode, and the rows past it are dropped:
    the bytes equal a solo ``api.encode_array``.
  * A failed batch falls back to per-clip encodes, each tried 1 + retries
    times; a clip that still fails is quarantined, a file that does not
    read is a read_error. Neither stops the job.
  * The manifest (JSONL, one record per clip: clip, status, out, seconds,
    kbps, wall_s) makes a re-run skip the clips already ok. Its records
    are tac's, so a job started by either package resumes in the other.
  * CorpusDecoder mirrors it for PAC-T → WAV: streams grouped by their
    header's config, frames zero-padded to a multiple of FRAME_BUCKET (an
    all-zero row decodes to silence), one batched decode to int16 on the
    device; unreadable streams are read_error, unparsable ones corrupt.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from tac_torch import api, parallel, tuning
from tac_torch import bitstream as bs
from tac_torch.config import CodecConfig, resolve_device
from tac_torch.dsp.mdct import num_frames
from tac_torch.io.wav import read_wav, write_wav
from tac_torch.ops.bitpack import rows_to_stream, stream_to_rows


def _bucket_len(t: int, h: int) -> int:
    """Pad target: the next multiple of 32 half-blocks (at least one)."""
    step = 32 * h
    return max(-(-t // step) * step, step)


def _load_manifest(path: str) -> dict[str, dict]:
    """clip → its last record; a torn line (a killed job's) is skipped."""
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    done[rec["clip"]] = rec
                except json.JSONDecodeError:
                    continue
    return done


def _out_path(out_dir: str, src: str, ext: str) -> str:
    return os.path.join(out_dir,
                        os.path.splitext(os.path.basename(src))[0] + ext)


class _Job:
    """The manifest and counters shared by both directions."""

    def __init__(self, out_dir: str, manifest: str,
                 batch_size: Optional[int], retries: int, io_threads: int,
                 device):
        self.device = resolve_device(device)
        self.out_dir = out_dir
        self.manifest_path = manifest
        self.batch_size = batch_size or tuning.CORPUS_BATCH
        self.retries = retries
        self.io_threads = io_threads
        os.makedirs(out_dir, exist_ok=True)

    def _todo(self, paths: Sequence[str]) -> list:
        done = _load_manifest(self.manifest_path)
        return [p for p in paths if done.get(p, {}).get("status") != "ok"]

    def _record(self, mf, stats, clip, status, **kw):
        rec = {"clip": clip, "status": status, **kw}
        mf.write(json.dumps(rec) + "\n")
        mf.flush()
        if status == "ok":
            stats["ok"] += 1
            stats["audio_s"] += kw.get("seconds", 0.0)
            stats["wall_s"] += kw.get("wall_s", 0.0)
        else:
            stats["failed"] += 1

    def _with_retries(self, batch_fn, one_fn, items) -> list:
        """batch_fn(items) → per-item results. When the batch fails, each
        item goes alone through one_fn up to 1 + retries times; an item
        that never succeeds gets None (quarantined by the caller)."""
        try:
            return batch_fn(items)
        except Exception:
            out = [None] * len(items)
            for i, it in enumerate(items):
                for _ in range(self.retries + 1):
                    try:
                        out[i] = one_fn(it)
                        break
                    except Exception:
                        continue
            return out


class CorpusTranscoder(_Job):
    """WAV → PAC-T over a corpus, with resume and quarantine."""

    def __init__(self, cfg: CodecConfig, out_dir: str,
                 manifest: Optional[str] = None,
                 batch_size: Optional[int] = None, retries: int = 1,
                 io_threads: int = 4, device=None):
        super().__init__(out_dir, manifest or os.path.join(
            out_dir, "manifest.jsonl"), batch_size, retries, io_threads,
            device)
        self.cfg = cfg

    def _encode_batch(self, clips: list,
                      cfg: Optional[CodecConfig] = None) -> list[bytes]:
        """clips: [T_i, C] float arrays of one (channels, rate) group →
        per-clip payload bytes (without header). cfg overrides self.cfg
        for the group."""
        cfg = cfg or self.cfg
        h = cfg.n_mdct_lines
        tb = max(_bucket_len(c.shape[0], h) for c in clips)
        batch = np.zeros((len(clips), clips[0].shape[1], tb), np.float32)
        for i, c in enumerate(clips):
            batch[i, :, :c.shape[0]] = c.T
        words, nbits = parallel.encode_batch_packed(batch, cfg, self.device)
        w_np = words.cpu().numpy().view(np.uint32)
        n_np = nbits.cpu().numpy()
        out = []
        for i, c in enumerate(clips):
            f = num_frames(c.shape[0], h)
            out.append(rows_to_stream(w_np[i, :, :f].swapaxes(0, 1),
                                      n_np[i, :, :f].swapaxes(0, 1)))
        return out

    def _encode_one(self, x: np.ndarray,
                    cfg: Optional[CodecConfig] = None) -> bytes:
        return self._encode_batch([x], cfg)[0]

    def run(self, wav_paths: Sequence[str], log=print) -> dict:
        todo = self._todo(wav_paths)
        log(f"corpus: {len(wav_paths)} clips, {len(wav_paths) - len(todo)} "
            f"already done, {len(todo)} to encode")
        stats = {"ok": len(wav_paths) - len(todo), "failed": 0,
                 "audio_s": 0.0, "wall_s": 0.0}
        with open(self.manifest_path, "a") as mf, \
                ThreadPoolExecutor(self.io_threads) as pool:
            for lo in range(0, len(todo), self.batch_size):
                paths = todo[lo:lo + self.batch_size]
                groups: dict = {}
                for p, (x, fs) in zip(paths, pool.map(self._safe_read, paths)):
                    if x is None:
                        self._record(mf, stats, p, "read_error")
                    else:
                        groups.setdefault((x.shape[1], fs), []).append((p, x))
                for (n_ch, fs), items in groups.items():
                    self._run_group(items, n_ch, fs, mf, stats)
        return stats

    def _run_group(self, items, n_ch, fs, mf, stats):
        t0 = time.perf_counter()
        try:
            cfg = self.cfg.replace(sample_rate=fs, n_channels=n_ch)
        except ValueError:              # e.g. an odd channel count under M/S
            payloads = [None] * len(items)
        else:
            payloads = self._with_retries(
                lambda xs: self._encode_batch(xs, cfg),
                lambda x: self._encode_one(x, cfg), [x for _, x in items])
        wall = time.perf_counter() - t0
        for (p, x), payload in zip(items, payloads):
            if payload is None:
                self._record(mf, stats, p, "quarantined")
                continue
            data = api.stream_header(cfg, x.shape[0]) + payload
            out = _out_path(self.out_dir, p, ".pac")
            with open(out, "wb") as fo:
                fo.write(data)
            dur = x.shape[0] / fs
            self._record(mf, stats, p, "ok", out=out, seconds=dur,
                         kbps=len(data) * 8 / dur / 1000.0,
                         wall_s=wall / len(items))

    @staticmethod
    def _safe_read(path):
        try:
            return read_wav(path)
        except Exception:
            return None, None


class CorpusDecoder(_Job):
    """PAC-T → WAV over a corpus: the decode mirror of CorpusTranscoder."""

    FRAME_BUCKET = 32

    def __init__(self, out_dir: str, manifest: Optional[str] = None,
                 batch_size: Optional[int] = None, retries: int = 1,
                 io_threads: int = 4, precision: str = "fast", device=None):
        super().__init__(out_dir, manifest or os.path.join(
            out_dir, "decode_manifest.jsonl"), batch_size, retries,
            io_threads, device)
        self.precision = precision

    def _stage(self, data: bytes):
        """bytes → (header, decode cfg, payload rows uint32 [C, F, W32])."""
        hdr, off = bs.read_header(data)
        cfg = api.header_config(hdr, self.precision)
        f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
        c = hdr.n_channels
        w32 = api.payload_words(cfg)
        offs, lens = bs.split_blocks(data, off, f * c)
        rows = stream_to_rows(data, offs, lens, w32)
        return hdr, cfg, np.ascontiguousarray(
            rows.reshape(f, c, w32).swapaxes(0, 1))

    def _decode_batch(self, staged: list) -> list[np.ndarray]:
        """staged: (hdr, cfg, rows [C, F_i, W32]) sharing one cfg → per-clip
        int16 [T_i, C] PCM, quantized on the device."""
        cfg = staged[0][1]
        f_max = max(s[2].shape[1] for s in staged)
        f_pad = -(-f_max // self.FRAME_BUCKET) * self.FRAME_BUCKET
        c, w32 = staged[0][2].shape[0], staged[0][2].shape[2]
        words = np.zeros((len(staged), c, f_pad, w32), np.uint32)
        for i, (_, _, rows) in enumerate(staged):
            words[i, :, :rows.shape[1]] = rows
        y = parallel.decode_batch_packed(
            words.view(np.int32), cfg, (f_pad - 1) * cfg.n_mdct_lines,
            pcm16=True, device=self.device).cpu().numpy()
        return [np.ascontiguousarray(y[i, :, :hdr.num_samples].T)
                for i, (hdr, _, _) in enumerate(staged)]

    def _decode_one(self, item) -> np.ndarray:
        return self._decode_batch([item])[0]

    def run(self, pac_paths: Sequence[str], log=print) -> dict:
        todo = self._todo(pac_paths)
        log(f"corpus decode: {len(pac_paths)} streams, "
            f"{len(pac_paths) - len(todo)} already done, {len(todo)} to go")
        stats = {"ok": len(pac_paths) - len(todo), "failed": 0,
                 "audio_s": 0.0, "wall_s": 0.0}
        with open(self.manifest_path, "a") as mf, \
                ThreadPoolExecutor(self.io_threads) as pool:
            for lo in range(0, len(todo), self.batch_size):
                paths = todo[lo:lo + self.batch_size]
                staged, group_paths = {}, {}
                for p, data in zip(paths, pool.map(self._safe_read_bytes,
                                                   paths)):
                    if data is None:
                        self._record(mf, stats, p, "read_error")
                        continue
                    try:
                        hdr, cfg, rows = self._stage(data)
                    except Exception as e:      # any parse fault: corrupt
                        self._record(mf, stats, p, "corrupt",
                                     error=type(e).__name__)
                        continue
                    staged.setdefault(cfg, []).append((hdr, cfg, rows))
                    group_paths.setdefault(cfg, []).append(p)
                for cfg, items in staged.items():
                    self._run_group(items, group_paths[cfg], mf, stats)
        return stats

    def _run_group(self, items, paths, mf, stats):
        t0 = time.perf_counter()
        pcms = self._with_retries(self._decode_batch, self._decode_one, items)
        wall = time.perf_counter() - t0
        for (hdr, _, _), p, pcm in zip(items, paths, pcms):
            if pcm is None:
                self._record(mf, stats, p, "quarantined")
                continue
            out = _out_path(self.out_dir, p, ".wav")
            write_wav(out, pcm, hdr.sample_rate)
            self._record(mf, stats, p, "ok", out=out,
                         seconds=hdr.num_samples / hdr.sample_rate,
                         wall_s=wall / len(items))

    @staticmethod
    def _safe_read_bytes(path):
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            return None
