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
  * Under a mesh (``parallel.make_mesh``; tac's ``mesh=``), every rank
    calls ``run`` with the same paths. Rank 0, the leader, does the job
    as above: it reads the manifest and the files, writes every output
    and the manifest. Each batch is scattered over the clips axis
    (``parallel.shard_clips``, the pad clips dropped on the way back);
    the other ranks serve their shards until the leader says stop. A
    rank whose shard raises still answers, with its ok flag down; the
    leader then retries the batch's clips one by one on its own device.
    ``run`` returns the job's stats on every rank.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tac_torch import api, family, parallel, tracing, tuning
from tac_torch import bitstream as bs
from tac_torch.config import CodecConfig, resolve_device
from tac_torch.dsp.mdct import num_frames
from tac_torch.io.wav import read_wav, write_wav


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
    """The manifest, the counters and the mesh protocol shared by both
    directions. Under a mesh the device is the rank's, and the default
    batch gives each clips rank tuning.CORPUS_BATCH clips."""

    def __init__(self, out_dir: str, manifest: str,
                 batch_size: Optional[int], retries: int, io_threads: int,
                 device, mesh: Optional[parallel.Mesh]):
        if mesh is not None and device is not None \
                and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the rank's "
                             f"{mesh.device}")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.out_dir = out_dir
        self.manifest_path = manifest
        self.batch_size = batch_size or tuning.CORPUS_BATCH * (
            mesh.shape["clips"] if mesh is not None else 1)
        self.retries = retries
        self.io_threads = io_threads
        os.makedirs(out_dir, exist_ok=True)

    @property
    def _leads(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _todo(self, paths: Sequence[str]) -> list:
        """The paths not yet ok in the manifest (the leader reads it; the
        barrier holds the other ranks until it has)."""
        done = _load_manifest(self.manifest_path)
        if self.mesh is not None:
            dist.barrier(group=self.mesh.host_group)
        return [p for p in paths if done.get(p, {}).get("status") != "ok"]

    # ------------------------------------------------------------ mesh ---

    def _run_shard(self, shard, *args) -> tuple:
        """This rank's part of a batch: its shard → a tuple of tensors."""
        raise NotImplementedError

    def _sharded(self, batch: np.ndarray, *args) -> list:
        """The leader's batch through the mesh: tell the other ranks to run
        ``_run_shard(shard, *args)``, then serve it here too. Returns the
        gathered outputs [n, ...] on this rank's device; raises when any
        rank's shard failed."""
        dist.broadcast_object_list([("run", args)], src=0,
                                   group=self.mesh.host_group)
        return self._serve_batch(args, batch)

    def _serve_batch(self, args: tuple, batch=None):
        """One batch on every rank: the scatter, this rank's shard, the ok
        flags of all ranks, then (when all are up) the gather. A failing
        shard still reaches the flags, so no rank waits on it."""
        mesh = self.mesh
        shard = parallel.shard_clips(batch, mesh)
        try:
            out = self._run_shard(shard, *args)
        except Exception:                       # reported in-band below
            traceback.print_exc()
            out = None
        oks = [None] * dist.get_world_size()
        dist.all_gather_object(oks, out is not None, group=mesh.host_group)
        if not all(oks):
            if self._leads:
                raise RuntimeError("the shards of ranks "
                                   f"{[r for r, ok in enumerate(oks) if not ok]}"
                                   " failed")
            return None
        n = len(batch) if self._leads else None
        return [parallel.gather_clips(o, mesh, n=n) for o in out]

    def _serve(self) -> dict:
        """A non-leader rank's job: serve each batch the leader announces
        until it says stop; returns the leader's stats."""
        dist.barrier(group=self.mesh.host_group)      # the manifest is read
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0, group=self.mesh.host_group)
            kind, args = msg[0]
            if kind == "stop":
                return args
            self._serve_batch(args)

    def _stop(self, stats: dict) -> None:
        """The leader's last word to the other ranks, with the stats."""
        if self.mesh is not None:
            dist.broadcast_object_list([("stop", stats)], src=0,
                                       group=self.mesh.host_group)

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
                 io_threads: int = 4, device=None,
                 mesh: Optional[parallel.Mesh] = None):
        super().__init__(out_dir, manifest or os.path.join(
            out_dir, "manifest.jsonl"), batch_size, retries, io_threads,
            device, mesh)
        self.cfg = cfg

    def _run_shard(self, shard, cfg: CodecConfig) -> tuple:
        return parallel.encode_batch_packed_sharded(shard, cfg, self.mesh)

    def _encode_batch(self, clips: list, cfg: Optional[CodecConfig] = None,
                      shard: bool = True) -> list[bytes]:
        """clips: [T_i, C] float arrays of one (channels, rate) group →
        per-clip payload bytes (without header). cfg overrides self.cfg
        for the group. Under a mesh the batch is sharded over it unless
        shard is False (then it runs on this rank's device alone)."""
        cfg = cfg or self.cfg
        h = cfg.n_mdct_lines
        tb = max(_bucket_len(c.shape[0], h) for c in clips)
        batch = np.zeros((len(clips), clips[0].shape[1], tb), np.float32)
        for i, c in enumerate(clips):
            batch[i, :, :c.shape[0]] = c.T
        if self.mesh is not None and shard:
            words, nbits = self._sharded(batch, cfg)
        else:
            words, nbits = parallel.encode_batch_packed(batch, cfg,
                                                        self.device)
        w_np = tracing.to_host(words).numpy().view(np.uint32)
        n_np = tracing.to_host(nbits).numpy()
        out = []
        for i, c in enumerate(clips):
            f = num_frames(c.shape[0], h)
            out.append(api.host_words_to_stream(w_np[i, :, :f],
                                                n_np[i, :, :f]))
        return out

    def _encode_one(self, x: np.ndarray,
                    cfg: Optional[CodecConfig] = None) -> bytes:
        return self._encode_batch([x], cfg, shard=False)[0]

    def run(self, wav_paths: Sequence[str], log=print) -> dict:
        if not self._leads:
            return self._serve()
        todo = self._todo(wav_paths)
        log(f"corpus: {len(wav_paths)} clips, {len(wav_paths) - len(todo)} "
            f"already done, {len(todo)} to encode")
        stats = {"ok": len(wav_paths) - len(todo), "failed": 0,
                 "audio_s": 0.0, "wall_s": 0.0}
        try:
            with open(self.manifest_path, "a") as mf, \
                    ThreadPoolExecutor(self.io_threads) as pool:
                for lo in range(0, len(todo), self.batch_size):
                    self._run_batch(todo[lo:lo + self.batch_size], pool, mf,
                                    stats)
        finally:
            self._stop(stats)
        return stats

    def _run_batch(self, paths, pool, mf, stats):
        groups: dict = {}
        for p, (x, fs) in zip(paths, pool.map(self._safe_read, paths)):
            if x is None:
                self._record(mf, stats, p, "read_error")
            else:
                groups.setdefault((x.shape[1], fs), []).append((p, x))
        for (n_ch, fs), items in groups.items():
            self._run_group(items, n_ch, fs, mf, stats)

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
                 io_threads: int = 4, precision: str = "fast", device=None,
                 mesh: Optional[parallel.Mesh] = None):
        super().__init__(out_dir, manifest or os.path.join(
            out_dir, "decode_manifest.jsonl"), batch_size, retries,
            io_threads, device, mesh)
        self.precision = precision

    def _run_shard(self, shard, cfg: CodecConfig, t: int) -> tuple:
        return (parallel.decode_batch_packed_sharded(shard, cfg, t, self.mesh,
                                                     pcm16=True),)

    def _stage(self, data: bytes):
        """bytes → (header, decode cfg, payload rows uint32 [C, F, W32])."""
        hdr, off = bs.read_header(data)
        cfg = api.header_config(hdr, self.precision)
        f = num_frames(hdr.num_samples, hdr.n_mdct_lines)
        c = hdr.n_channels
        offs, lens = bs.split_blocks(data, off, f * c)
        return hdr, cfg, api.stream_words(data, offs, lens, c,
                                          family.payload_words(cfg))

    def _decode_batch(self, staged: list, shard: bool = True) -> list:
        """staged: (hdr, cfg, rows [C, F_i, W32]) sharing one cfg → per-clip
        int16 [T_i, C] PCM, quantized on the device; sharded over the mesh,
        if any, unless shard is False."""
        cfg = staged[0][1]
        f_max = max(s[2].shape[1] for s in staged)
        f_pad = -(-f_max // self.FRAME_BUCKET) * self.FRAME_BUCKET
        c, w32 = staged[0][2].shape[0], staged[0][2].shape[2]
        words = np.zeros((len(staged), c, f_pad, w32), np.uint32)
        for i, (_, _, rows) in enumerate(staged):
            words[i, :, :rows.shape[1]] = rows
        t = (f_pad - 1) * cfg.n_mdct_lines
        if self.mesh is not None and shard:
            y, = self._sharded(words.view(np.int32), cfg, t)
        else:
            y = parallel.decode_batch_packed(words.view(np.int32), cfg, t,
                                             pcm16=True, device=self.device)
        y = tracing.to_host(y).numpy()
        return [np.ascontiguousarray(y[i, :, :hdr.num_samples].T)
                for i, (hdr, _, _) in enumerate(staged)]

    def _decode_one(self, item) -> np.ndarray:
        return self._decode_batch([item], shard=False)[0]

    def run(self, pac_paths: Sequence[str], log=print) -> dict:
        if not self._leads:
            return self._serve()
        todo = self._todo(pac_paths)
        log(f"corpus decode: {len(pac_paths)} streams, "
            f"{len(pac_paths) - len(todo)} already done, {len(todo)} to go")
        stats = {"ok": len(pac_paths) - len(todo), "failed": 0,
                 "audio_s": 0.0, "wall_s": 0.0}
        try:
            with open(self.manifest_path, "a") as mf, \
                    ThreadPoolExecutor(self.io_threads) as pool:
                for lo in range(0, len(todo), self.batch_size):
                    self._run_batch(todo[lo:lo + self.batch_size], pool, mf,
                                    stats)
        finally:
            self._stop(stats)
        return stats

    def _run_batch(self, paths, pool, mf, stats):
        staged, group_paths = {}, {}
        for p, data in zip(paths, pool.map(self._safe_read_bytes, paths)):
            if data is None:
                self._record(mf, stats, p, "read_error")
                continue
            try:
                hdr, cfg, rows = self._stage(data)
            except Exception as e:              # any parse fault: corrupt
                self._record(mf, stats, p, "corrupt", error=type(e).__name__)
                continue
            staged.setdefault(cfg, []).append((hdr, cfg, rows))
            group_paths.setdefault(cfg, []).append(p)
        for cfg, items in staged.items():
            self._run_group(items, group_paths[cfg], mf, stats)

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
