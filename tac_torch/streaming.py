"""Streaming encode and decode with explicit, serializable state
(counterpart of tac/streaming.py, SURVEY.md §5.4).

The encoder's carried state is a ``StreamState``: the previous half-block
(overlap), the lookahead half-block (block switching), the samples not yet
a half-block, the bit reservoir of each VBR lane and the transient-flag
history of each channel (or mid/side pair). It is enough to resume an
encode mid-stream bit-exactly, and its bytes are those tac writes, so a
state written by either package resumes in the other.

Every push codes exactly the frames its samples complete, in one call of
the family's streaming core (``family.encode_stream``), which runs the
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

On a card, a fast fixed-rate coder (``graphed``) replays its push core as
a CUDA graph: a push's shapes are fixed by its channels and frames, and
the core is some 700 small kernels (the decoder's some 200) that the host
would otherwise launch one by one. The same kernels run in the same order
on the same inputs, so the bytes and the PCM are the eager path's.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
import struct
from typing import Optional

import numpy as np
import torch

from tac_torch import api, codec, family, tracing
from tac_torch.bitstream import read_header
from tac_torch.config import CodecConfig, resolve_device

# Push shapes (C, m) of which a coder keeps a CUDA graph: a live stream
# pushes one or two; shapes past these run eagerly.
GRAPHS = 4


def graphed(cfg: CodecConfig, device: torch.device) -> bool:
    """Whether a coder of `cfg` on `device` replays its push core as a CUDA
    graph: fast precision on a card, fixed rate (flat or block switching,
    L/R or M/S). Parity's forward FFT runs on the host (``mdct_fft``),
    which no graph holds; the Huffman (VBR) families, whose cores carry the
    reservoir fills through the host and run K3 and K4, have not been held
    to their eager bytes under capture. Those stay eager, as the CPU
    does."""
    return (device.type == "cuda" and cfg.precision == "fast"
            and not cfg.use_huffman)


def _capture(fn, ins: list):
    """fn over the static inputs `ins`, captured as a CUDA graph → (graph,
    fn's outputs: the graph's own tensors). Capturing runs nothing."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn(*ins)
    return graph, outs


class _Graph:
    """One push core captured at one input shape: static inputs, pinned
    staging for those that come from the host, the graph and its outputs.
    The kernels' ``.launches`` count the capture's calls, once; a replay
    counts in ``graph_replays`` (the card's own launches are the
    profiler's to count)."""

    def __init__(self, fn, args: tuple, device: torch.device):
        pin = device.type == "cuda"
        self.stage = [torch.empty(a.shape, dtype=a.dtype, pin_memory=pin)
                      if a.device.type == "cpu" else None for a in args]
        self.ins = [torch.empty(a.shape, dtype=a.dtype, device=device)
                    for a in args]
        self.graph, self.outs = _capture(fn, self.ins)
        tracing.count("graph_captures")

    def replay(self, args: tuple):
        for a, st, x in zip(args, self.stage, self.ins):
            if st is not None:
                st.copy_(a)
                tracing.stage(x, st)
            elif a is not x:
                x.copy_(a)
        self.graph.replay()
        tracing.count("graph_replays")
        return self.outs


class _PushGraphs:
    """A push core ``fn(*tensors) → tuple of tensors`` run on `device` as
    CUDA graphs, one per input shape. A shape's first push runs eagerly and
    makes every constant the core caches; its second is captured, and it
    and every later push of that shape replay the graph, up to GRAPHS
    shapes. Arguments on the host are staged through pinned memory into
    the graph's static inputs; arguments on the device are copied into
    them unless they are those inputs. A replay's outputs are the graph's
    own tensors, overwritten by its next replay."""

    def __init__(self, fn, device: torch.device):
        self.fn, self.device = fn, device
        self.seen, self.graphs = set(), {}

    def __call__(self, *args):
        key = tuple((a.shape, a.dtype, a.device.type) for a in args)
        g = self.graphs.get(key)
        if g is None:
            if key not in self.seen or len(self.graphs) >= GRAPHS:
                self.seen.add(key)
                return self.fn(*args)
            with tracing.span("tac.stream.graph.capture"):
                g = self.graphs[key] = _Graph(self.fn, args, self.device)
        with tracing.span("tac.stream.graph.replay"):
            return g.replay(args)


def _decode_into(cfg: CodecConfig, c, words, tail: torch.Tensor):
    """The graphed decoder's push core: (words int32 [C, m, W32], the
    carried tail [C, H]) → (out [C, m, H], tail), the new tail written over
    the old, so that a graph's tail stays its static input."""
    out, new = family.decode_stream(cfg, c, words, tail)
    tail.copy_(new)
    return out, tail


def _seq(dtype, *parts: np.ndarray) -> torch.Tensor:
    """Half-blocks [C, k_i, H] (host arrays) side by side → one host tensor
    [C, Σk_i, H] in the codec's float type."""
    return torch.from_numpy(np.concatenate(parts, axis=1)).to(dtype)


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
        self.family = family.of(cfg)
        self.consts = self.family.make_consts(cfg, self.device)
        # the core holds the config and constants, not the coder
        self.core = functools.partial(family.encode_stream, cfg, self.consts)
        self.graphs = (_PushGraphs(self.core, self.device)
                       if graphed(cfg, self.device) else None)
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
        with tracing.span("tac.stream.enc.push"):
            with tracing.span("tac.stream.enc.frame"):
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
                halves = np.ascontiguousarray(buf[:, :m * h].reshape(c, m, h))
            return self._emit(halves)

    def flush(self) -> bytes:
        """The last frames: the pending samples zero-padded to a half, the
        flush half and, under block switching, one more to drain the
        lookahead."""
        with tracing.span("tac.stream.enc.push"):
            with tracing.span("tac.stream.enc.frame"):
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
                halves = np.concatenate(tail, axis=1)
            return self._emit(halves)

    def _emit(self, halves: np.ndarray) -> bytes:
        if self.cfg.use_block_switch:
            return self._emit_bs(halves)
        return self._emit_flat(halves)

    def _fills(self) -> tuple:
        """What the core takes of the reservoir: each lane's fill, int32
        [L] on the device, under VBR; nothing at a fixed rate."""
        if not self.family.reservoir:
            return ()
        return (tracing.upload(self.state.reservoir.astype(np.int32),
                               self.device),)

    def _core(self, *args):
        """The push core, replayed as a CUDA graph where the coder has
        them."""
        return (self.core if self.graphs is None else self.graphs)(*args)

    def _carry(self, res: list) -> None:
        """Keep each lane's fill after the push's last frame, under VBR."""
        if res:
            self.state.reservoir = tracing.to_host(
                res[0][:, -1]).numpy().astype(np.int64)

    def _emit_flat(self, halves: np.ndarray) -> bytes:
        """No block switching: half h_j completes frame j = [h_{j-1} |
        h_j]."""
        st = self.state
        with tracing.span("tac.stream.enc.core"):
            seq = _seq(self.consts.dtype, st.prior[:, None], halves)
            words, nbits, *res = self._core(seq, *self._fills())
        self._carry(res)
        st.prior = halves[:, -1].copy()
        st.blocks_out += halves.shape[1]
        return api.words_to_stream(words, nbits)

    def _emit_bs(self, halves: np.ndarray) -> bytes:
        """Block switching: a new half h_{e+1} makes frame e emittable, its
        state needing the flags up to t_{e+1}."""
        st = self.state
        if not st.primed:                  # the first half is the lookahead
            st.look = halves[:, 0].copy()
            st.primed = True
            halves = halves[:, 1:]
            if halves.shape[1] == 0:
                return b""
        m = halves.shape[1]
        with tracing.span("tac.stream.enc.core"):
            seq = _seq(self.consts.cl.dtype, st.prior[:, None],
                       st.look[:, None], halves)
            words, nbits, t, *res = self._core(
                seq, torch.from_numpy(st.t_hist), *self._fills())
        self._carry(res)
        # (t_{e+m-2}, t_{e+m-1})
        st.t_hist = tracing.to_host(t[:, m:m + 2]).numpy()
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
        self.consts = family.of(cfg).make_consts(cfg, self.device)
        self.graphs = (_PushGraphs(functools.partial(
            _decode_into, cfg, self.consts), self.device)
            if graphed(cfg, self.device) else None)
        self.w32 = family.payload_words(cfg)
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
        with tracing.span("tac.stream.dec.push"):
            cfg = self.cfg
            c, h = cfg.n_channels, cfg.n_mdct_lines
            with tracing.span("tac.stream.dec.walk"):
                self.buf += data
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
                # raises CorruptStreamError on a block longer than the
                # capacity
                words = api.stream_words(
                    self.buf, np.asarray(offs[:m * c], np.int64),
                    np.asarray(lens[:m * c], np.int64), c,
                    self.w32).view(np.int32)
                self.buf = self.buf[offs[m * c - 1] + lens[m * c - 1]:]
            priming = self.tail is None    # frame 0's first half is padding
            with tracing.span("tac.stream.dec.decode"):
                tail = (torch.zeros((c, h), device=self.device) if priming
                        else self.tail)
                if self.graphs is None:
                    out, self.tail = family.decode_stream(
                        cfg, self.consts, words, tail)
                else:
                    out, self.tail = self.graphs(torch.from_numpy(words),
                                                 tail)
            self.frames_in += m
            if priming:
                out = out[:, 1:]
            out = tracing.to_host(out.reshape(c, -1).T).numpy().astype(
                np.float32)
            if self.num_samples:
                out = out[:max(self.num_samples - self.emitted, 0)]
            self.emitted += out.shape[0]
            return out
