"""Streaming encode and decode with explicit, serializable state
(counterpart of tac/streaming.py, SURVEY.md §5.4).

The encoder's carried state is a ``StreamState``: the previous half-block
(overlap), the lookahead half-block (block switching), the samples not yet
a half-block, the bit reservoir of each VBR lane and the transient-flag
history of each channel (or mid/side pair). It is enough to resume an
encode mid-stream bit-exactly, and its bytes are those tac writes, so a
state written by either package resumes in the other.

Every push codes exactly the frames its samples complete, in one call of
the frame-level cores of ``codec`` / ``blockswitch``, which run the
offline row paths and their kernels: K1 and K2 per push, K3 resumed from
the carried fills under VBR. So the stream equals the offline
``api.encode_array`` bytes under any push chunking in parity precision;
in fast precision a push's batch shape may move 1/16-dB grid ties (the
rate and the decoded audio agree with the offline stream's).

Latency: under block switching, frames leave one half-block behind the
input, so the transient detector sees the half-block entering the next
frame (SPEC.md §9): 2·H/fs of algorithmic delay, 11.6 ms at H = 256,
44.1 kHz. The decoder finishes frame i's first half when frame i arrives:
one half-block of delay.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Optional

import numpy as np
import torch

from tac_torch import api, codec
from tac_torch import blockswitch as bsw
from tac_torch.bitstream import read_header
from tac_torch.config import CodecConfig, resolve_device
from tac_torch.ops.bitpack import stream_to_rows


@dataclasses.dataclass
class StreamState:
    """Everything the encoder carries between pushes (the byte layout of
    tac's StreamState)."""
    prior: np.ndarray        # [C, H] float64 previous half-block
    look: np.ndarray         # [C, H] float64 lookahead half-block
    pending: np.ndarray      # [C, <H] float64 samples not yet a half-block
    reservoir: np.ndarray    # [L] int64 VBR fill per lane (channel or pair)
    t_hist: np.ndarray = None  # [L, 2] bool transient flags t[e-2], t[e-1]
    blocks_out: int = 0
    primed: bool = False     # lookahead filled?

    def to_bytes(self) -> bytes:
        """A 4-byte length, a JSON head, then the five arrays in np.save
        format, for checkpoint and resume."""
        bio = io.BytesIO()
        meta = {"blocks_out": self.blocks_out, "primed": self.primed,
                "pending_len": self.pending.shape[1]}
        head = json.dumps(meta).encode()
        bio.write(len(head).to_bytes(4, "little"))
        bio.write(head)
        for a in (self.prior, self.look, self.pending, self.reservoir,
                  self.t_hist):
            np.save(bio, np.ascontiguousarray(a))
        return bio.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "StreamState":
        bio = io.BytesIO(data)
        n = int.from_bytes(bio.read(4), "little")
        meta = json.loads(bio.read(n))
        prior, look, pending, reservoir, t_hist = (
            np.load(bio, allow_pickle=False) for _ in range(5))
        return cls(prior=prior, look=look, pending=pending,
                   reservoir=reservoir, t_hist=t_hist,
                   blocks_out=meta["blocks_out"], primed=meta["primed"])


class StreamEncoder:
    """Push samples in, get PAC-T block payload bytes out: ``header()``
    followed by every push's bytes and ``flush()``'s is the offline
    ``api.encode_array`` stream of the whole signal. Runs on `device`
    (CUDA unless named)."""

    def __init__(self, cfg: CodecConfig, n_channels: Optional[int] = None,
                 device=None):
        c = n_channels or cfg.n_channels
        self.cfg = cfg = cfg.replace(n_channels=c)
        self.device = resolve_device(device)
        self.consts = (bsw.make_bs_consts if cfg.use_block_switch
                       else codec.make_consts)(cfg, self.device)
        h = cfg.n_mdct_lines
        # one reservoir and one flag history per lane: a channel, or under
        # M/S a pair (the halves stay L/R; the cores butterfly them)
        lanes = codec.n_lanes((c,), cfg)
        self.state = StreamState(
            prior=np.zeros((c, h)), look=np.zeros((c, h)),
            pending=np.zeros((c, 0)), reservoir=np.zeros(lanes, np.int64),
            t_hist=np.zeros((lanes, 2), bool))

    def header(self, num_samples: int = 0) -> bytes:
        return api.stream_header(self.cfg, num_samples)

    def push(self, x: np.ndarray) -> bytes:
        """x: float[T'] or [T', C] new samples → the payload bytes of every
        frame they complete."""
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            x = x[:, None]
        st = self.state
        h = self.cfg.n_mdct_lines
        buf = np.concatenate([st.pending, x.T], axis=1)
        c, total = buf.shape
        m = total // h
        st.pending = buf[:, m * h:]
        if m == 0:
            return b""
        return self._emit(
            np.ascontiguousarray(buf[:, :m * h].reshape(c, m, h)))

    def flush(self) -> bytes:
        """The last frames: the pending samples zero-padded to a half, the
        flush half and, under block switching, one more to drain the
        lookahead."""
        st = self.state
        c, p = st.pending.shape
        h = self.cfg.n_mdct_lines
        tail = []
        if p > 0:
            tail.append(np.concatenate(
                [st.pending, np.zeros((c, h - p))], axis=1)[:, None, :])
            st.pending = st.pending[:, :0]
        tail.append(np.zeros((c, 1, h)))
        if self.cfg.use_block_switch:
            tail.append(np.zeros((c, 1, h)))
        return self._emit(np.concatenate(tail, axis=1))

    def _emit(self, halves: np.ndarray) -> bytes:
        if self.cfg.use_block_switch:
            return self._emit_bs(halves)
        return self._emit_flat(halves)

    def _res0(self) -> torch.Tensor:
        return torch.as_tensor(self.state.reservoir.astype(np.int32),
                               device=self.device)

    def _emit_flat(self, halves: np.ndarray) -> bytes:
        """Fixed rate and VBR: half h_j completes frame j = [h_{j-1} | h_j]."""
        st, cfg, c = self.state, self.cfg, self.consts
        if cfg.use_huffman:
            words, nbits, ress = codec.encode_frames_vbr_packed_halves(
                st.prior, halves, self._res0(), cfg, c)
            st.reservoir = ress[:, -1].cpu().numpy().astype(np.int64)
        else:
            words, nbits = codec.encode_frames_packed_halves(
                st.prior, halves, cfg, c)
        st.prior = halves[:, -1].copy()
        st.blocks_out += halves.shape[1]
        return api.words_to_stream(words, nbits)

    def _emit_bs(self, halves: np.ndarray) -> bytes:
        """Block switching: a new half h_{e+1} makes frame e emittable, its
        state needing the flags up to t_{e+1}."""
        st, cfg, c = self.state, self.cfg, self.consts
        if not st.primed:                  # the first half is the lookahead
            st.look = halves[:, 0].copy()
            st.primed = True
            halves = halves[:, 1:]
            if halves.shape[1] == 0:
                return b""
        m = halves.shape[1]
        if cfg.use_huffman:
            words, nbits, t, ress = bsw.encode_frames_bs_vbr_packed(
                st.prior, st.look, halves, st.t_hist, self._res0(), cfg, c)
            st.reservoir = ress[:, -1].cpu().numpy().astype(np.int64)
        else:
            words, nbits, t = bsw.encode_frames_bs_packed(
                st.prior, st.look, halves, st.t_hist, cfg, c)
        st.t_hist = t[:, m:m + 2].cpu().numpy()   # (t_{e+m-2}, t_{e+m-1})
        st.prior = (halves[:, -2] if m >= 2 else st.look).copy()
        st.look = halves[:, -1].copy()
        st.blocks_out += m
        return api.words_to_stream(words, nbits)


class StreamDecoder:
    """Push PAC-T payload bytes in (any chunking), get PCM out: the decode
    mirror of StreamEncoder. Each push decodes the whole frames (C blocks
    each) it completes in one call of the offline frame decoders; the
    overlap-add's carried half (``tail`` [C, H], on the device) is the only
    state. Runs on `device` (CUDA unless named)."""

    def __init__(self, cfg: CodecConfig, num_samples: int = 0, device=None):
        self.cfg = cfg
        self.num_samples = int(num_samples)   # 0: unknown, emit everything
        self.device = resolve_device(device)
        self.consts = codec.frame_decoder(cfg)[1](cfg, self.device)
        self.w32 = api.payload_words(cfg)
        self.buf = b""
        self.tail: Optional[torch.Tensor] = None
        self.frames_in = 0
        self.emitted = 0

    @classmethod
    def from_header(cls, data: bytes, precision: str = "fast", device=None
                    ) -> tuple["StreamDecoder", int]:
        """Parse a PAC-T header → (decoder, payload offset). Feed
        ``data[offset:]`` and any later bytes to push()."""
        hdr, off = read_header(data)
        return cls(api.header_config(hdr, precision), hdr.num_samples,
                   device), off

    def push(self, data: bytes) -> np.ndarray:
        """data: the next stream bytes → float32[T', C] newly finished
        samples (none until a whole frame of C blocks has arrived)."""
        self.buf += data
        cfg = self.cfg
        c, h = cfg.n_channels, cfg.n_mdct_lines
        offs, lens, pos = [], [], 0
        while len(self.buf) - pos >= 2:
            (ln,) = struct.unpack_from("<H", self.buf, pos)
            if pos + 2 + ln > len(self.buf):
                break
            offs.append(pos + 2)
            lens.append(ln)
            pos += 2 + ln
        m = len(offs) // c
        if m == 0:
            return np.zeros((0, c), np.float32)
        # raises CorruptStreamError on a block longer than the capacity
        rows = stream_to_rows(self.buf, np.asarray(offs[:m * c], np.int64),
                              np.asarray(lens[:m * c], np.int64), self.w32)
        self.buf = self.buf[offs[m * c - 1] + lens[m * c - 1]:]
        words = np.ascontiguousarray(
            rows.reshape(m, c, self.w32).swapaxes(0, 1)).view(np.int32)
        priming = self.tail is None        # frame 0's first half is padding
        tail = torch.zeros((c, h)) if priming else self.tail
        out, self.tail = codec.decode_frames_stream(words, tail, cfg,
                                                    self.consts)
        self.frames_in += m
        if priming:
            out = out[:, 1:]
        out = out.reshape(c, -1).T.cpu().numpy().astype(np.float32)
        if self.num_samples:
            out = out[:max(self.num_samples - self.emitted, 0)]
        self.emitted += out.shape[0]
        return out
