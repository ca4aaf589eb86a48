"""The program's own spans and counters: where a batch or a push spends
the host's time, how often the host waits for the card, and how many
bytes cross the bus.

Off by default, and then ``span`` hands back one shared no-op context
manager and the helpers below touch no counter. ``enable(True)`` turns it
on for the process, ``reset()`` clears what was recorded and
``snapshot()`` returns it.

A span records its name, ``time.perf_counter_ns()`` at its start and end,
the index of its parent (the span open on the same thread when it began;
-1 for none) and the index of its root (the outermost such span: one
batch call or one push), in memory, up to ``CAP`` spans; ``dropped``
counts the rest. While a ``torch.profiler`` profile is running, each span
also opens a ``record_function`` range of its name, so that the profiler's
trace (``export_chrome_trace``) carries the program's phases on the same
timeline as the kernels they launch.

Spans (``tac.`` names):

  tac.encode            a packed encode entry (encode_batch_packed,
                        encode_array): root
  tac.codec.analysis    the framing (and the transient flags and window
                        states under block switching) once per call, then
                        per row chunk the MDCT (both under block switching)
  tac.codec.psy         per chunk: the SMRs
  tac.codec.alloc       per chunk: the bit allocation (SMR snap, K1)
  tac.codec.quant       per chunk: quantization at the allocation
  tac.codec.pack        per chunk: payload fields and the bit pack (K2)
  tac.api.serialize     stream_header, words_to_stream
  tac.stream.enc.push   StreamEncoder.push / flush: root, over
                        tac.stream.enc.frame (the host buffering) and
                        tac.stream.enc.core (the frame core)
  tac.stream.dec.push   StreamDecoder.push: root, over tac.stream.dec.walk
                        (the u16 framing walk, stream_to_rows) and
                        tac.stream.dec.decode (the frame decode)
  tac.stream.graph.capture  inside .enc.core / .dec.decode on a card: the
                        push core captured as a CUDA graph (its inner
                        tac.codec.* spans are the capture's)
  tac.stream.graph.replay   the same: the graph staged and replayed, in
                        place of the core's inner spans
  tac.sync              every blocking read of a tensor to the host
                        (``to_host``)
  tac.h2d               every upload of host data (``upload``)

Counters: ``syncs`` and ``d2h_bytes`` (reads of device tensors through
``to_host``: on a card each one waits for the device), ``h2d_bytes`` and
``h2d_pageable_bytes`` (uploads to a device through ``upload``, and those
of them from memory that is not pinned; ``stage`` counts its copies
there too), ``graph_captures`` and ``graph_replays`` (push cores captured
as CUDA graphs, and replays of them).
"""

from __future__ import annotations

import threading
import time

import torch
import torch.autograd.profiler as _profiler

CAP = 1_000_000
COUNTERS = ("syncs", "d2h_bytes", "h2d_bytes", "h2d_pageable_bytes",
            "graph_captures", "graph_replays")


class _Trace:
    """The process's record: one, since the spans are opened deep inside
    calls that take no tracer."""

    def __init__(self):
        self.on = False
        self.lock = threading.Lock()     # counters, reset and snapshot
        self.local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            # [name, start_ns, end_ns, the parent's record or None]
            self.spans = []
            self.dropped = 0
            self.counters = dict.fromkeys(COUNTERS, 0)

    def stack(self) -> list:
        """This thread's open spans' records, innermost last."""
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


_T = _Trace()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "range")

    def __init__(self, name: str):
        self.rec = [name, 0, None, None]

    def __enter__(self):
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.rec[0])
            self.range.__enter__()
        rec, st, spans = self.rec, _T.stack(), _T.spans
        if st:
            rec[3] = st[-1]
        if len(spans) < CAP:
            spans.append(rec)            # one call: atomic across threads
            st.append(rec)
        else:
            with _T.lock:
                _T.dropped += 1
            # its children hang from its nearest recorded ancestor
            st.append(rec[3])
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        _T.stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def enable(on: bool = True) -> bool:
    """Turn tracing on or off for the process; returns the previous
    setting."""
    was, _T.on = _T.on, bool(on)
    return was


def reset() -> None:
    """Forget every span and zero the counters."""
    _T.reset()


def span(name: str):
    """A context manager that records one span of `name` while tracing is
    on, and does nothing while it is off."""
    return _Span(name) if _T.on else _OFF


def launches() -> dict:
    """The hand-written kernels' own launch counters, read where they are:
    the calls Python makes, a CUDA graph's capture among them; a graph's
    replays are counted in ``graph_replays``."""
    from tac_torch.ops import (alloc, huffdec, mdct_fused, pack, psy_smr,
                               row_gemm, segment_sum, vbr_scan)

    return {f.__name__: f.launches for f in (
        alloc.water_fill_rows, pack.scatter_words_rows,
        vbr_scan.vbr_reservoir_scan, huffdec.huffman_decode_sets,
        mdct_fused.mdct_frames_fused, row_gemm.row_matmul,
        segment_sum.segment_sums, psy_smr.psy_smr_rows)}


# each counter's kernel on the card, by a part of the name a profiler lists
# it under (a template adds its arguments): what a replayed graph launches
# is counted there
DEVICE_KERNELS = {"water_fill_rows": "water_fill_kernel",
                  "scatter_words_rows": "scatter_words_kernel",
                  "vbr_reservoir_scan": "vbr_scan_kernel",
                  "huffman_decode_sets": "huffdec_sets_kernel",
                  "mdct_frames_fused": "mdct_wgmma_kernel",
                  "row_matmul": "row_gemm_kernel",
                  "segment_sums": "segment_sum_kernel",
                  "psy_smr_rows": "psy_smr_kernel"}


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while tracing is on."""
    if _T.on:
        with _T.lock:
            _T.counters[name] += n


def snapshot() -> dict:
    """What was recorded since the last reset: {"spans": [(name, start_ns,
    end_ns, parent, root)] in the order they began (end_ns None while a
    span is open; parent and root are indices into the list, -1 for
    none), "dropped": spans past CAP, "counters": {name: count},
    "launches": the kernels' launch counters}."""
    with _T.lock:
        recs = list(_T.spans)
        dropped, counters = _T.dropped, dict(_T.counters)
    index = {id(r): i for i, r in enumerate(recs)}
    spans, roots = [], []
    for i, (name, t0, t1, up) in enumerate(recs):
        # a parent opened before the last reset is not in this record
        parent = -1 if up is None else index.get(id(up), -1)
        roots.append(i if parent < 0 else roots[parent])
        spans.append((name, t0, t1, parent, roots[i]))
    return {"spans": spans, "dropped": dropped, "counters": counters,
            "launches": launches()}


def to_host(t: torch.Tensor) -> torch.Tensor:
    """t on the host (``t.cpu()``). Every blocking read of a tensor to the
    host goes through here, in a tac.sync span; a read of a device tensor
    counts one sync and its bytes."""
    if not _T.on:
        return t.cpu()
    with span("tac.sync"):
        out = t.cpu()
        if t.device.type != "cpu" and t.numel():
            n = t.numel() * t.element_size()
            with _T.lock:
                _T.counters["syncs"] += 1
                _T.counters["d2h_bytes"] += n
        return out


def _count_h2d(t: torch.Tensor) -> None:
    """Count host tensor t's bytes as uploaded, and apart if it is not
    pinned."""
    n = t.numel() * t.element_size()
    with _T.lock:
        _T.counters["h2d_bytes"] += n
        _T.counters["h2d_pageable_bytes"] += 0 if t.is_pinned() else n


def upload(x, device) -> torch.Tensor:
    """x (an array or a tensor) on `device`, its dtype kept. Every upload of
    host data goes through here, in a tac.h2d span; one from the host to
    another device counts its bytes, and those of pageable memory apart."""
    t = torch.as_tensor(x)
    if not _T.on:
        return t.to(device)
    with span("tac.h2d"):
        out = t.to(device)
        if t.device.type == "cpu" and out.device.type != "cpu" and t.numel():
            _count_h2d(t)
        return out


def stage(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst (on a device) ← src (host, pinned on a card), without waiting
    for the copy: a graph's static input loaded before its replay. Counted
    as ``upload`` counts, in a tac.h2d span."""
    if not _T.on:
        dst.copy_(src, non_blocking=True)
        return
    with span("tac.h2d"):
        dst.copy_(src, non_blocking=True)
        if dst.device.type != "cpu" and src.numel():
            _count_h2d(src)
