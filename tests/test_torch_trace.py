"""The port's own spans and counters (tac_torch/tracing.py), on the CPU at
tiny sizes: off by default and then silent; the same bytes and PCM with it
on; the span names, their nesting and their roots on a stereo44-128 batch
and a streaming-ll stream; the host reads and uploads of every push going
through the two helpers; the cap; encode --profile's trace."""

import collections
import json

import numpy as np
import pytest
import torch

from tac_torch import api, cli, parallel, tracing
from tac_torch.config import PRESETS
from tac_torch.io.wav import write_wav
from tac_torch.streaming import StreamDecoder, StreamEncoder

SPANS = {"tac.encode", "tac.h2d", "tac.codec.analysis", "tac.codec.psy",
         "tac.codec.alloc", "tac.codec.quant", "tac.codec.pack",
         "tac.api.serialize", "tac.sync", "tac.stream.enc.push",
         "tac.stream.enc.frame", "tac.stream.enc.core", "tac.stream.dec.push",
         "tac.stream.dec.walk", "tac.stream.dec.decode"}
# streaming-ll, a push that codes (or decodes) frames: the encoder reads the
# flag history and the words and bit counts back, and uploads the halves
# and the flag history; the decoder uploads the words and reads the PCM
# back (the quantizers' and the head's field widths are constants, made
# on the device once, in the run with tracing off)
PUSH_SITES = {"tac.stream.enc.push": {"tac.sync": 3, "tac.h2d": 2},
              "tac.stream.dec.push": {"tac.sync": 1, "tac.h2d": 1}}


def _batch(x, cfg):
    """A stereo44-128 batch as the bulk job runs it: the batched encode,
    then each clip's complete stream on the host."""
    words, nbits = parallel.encode_batch_packed(x, cfg, "cpu")
    wh, nh = words.cpu(), nbits.cpu()
    return [api.stream_header(cfg, x.shape[-1]) + api.words_to_stream(wh[i],
                                                                      nh[i])
            for i in range(x.shape[0])]


def _stream(y, cfg, hop: int = 256):
    """y pushed hop by hop through a StreamEncoder, each push's bytes at
    once through a StreamDecoder, then the flush → (bytes, PCM)."""
    enc = StreamEncoder(cfg, device="cpu")
    head = enc.header(0)
    dec, _ = StreamDecoder.from_header(head, device="cpu")
    sent, pcm = [head], []
    for i in range(0, y.shape[0], hop):
        sent.append(enc.push(y[i:i + hop]))
        pcm.append(dec.push(sent[-1]))
    sent.append(enc.flush())
    pcm.append(dec.push(sent[-1]))
    return b"".join(sent), np.concatenate(pcm)


@pytest.fixture(scope="module")
def runs():
    """A 2-clip stereo44-128 batch and a 0.5-s streaming-ll stream with
    tracing off, then on: outputs and snapshots of each."""
    rng = np.random.default_rng(14)
    t = np.arange(22050) / 44100
    x = np.stack([np.stack([0.4 * np.sin(2 * np.pi * f * t)
                            + 0.01 * rng.standard_normal(t.size)
                            for f in (f0, 1.5 * f0)])
                  for f0 in (220.0, 330.0)]).astype(np.float32)
    y = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(t.size)
    y[11025:11030] += 0.9                       # a click: SHORT blocks
    bcfg, scfg = PRESETS["stereo44-128"], PRESETS["streaming-ll"]
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    assert not tracing.enable(False)            # off by default
    tracing.reset()
    try:
        out = {"off": (_batch(x, bcfg), _stream(y, scfg)),
               "off_snap": tracing.snapshot()}
        tracing.enable(True)
        tracing.reset()
        b = _batch(x, bcfg)
        out["batch_snap"] = tracing.snapshot()
        tracing.reset()
        out["on"] = (b, _stream(y, scfg))
        out["stream_snap"] = tracing.snapshot()
    finally:
        tracing.enable(False)
        tracing.reset()
        torch.set_num_threads(prev)
    return out


def _children(spans):
    kids = collections.defaultdict(list)
    for i, s in enumerate(spans):
        if s[3] >= 0:
            kids[s[3]].append(i)
    return kids


def test_off_records_nothing(runs):
    snap = runs["off_snap"]
    assert snap["spans"] == [] and snap["dropped"] == 0
    assert set(snap["counters"].values()) == {0}
    assert set(snap["counters"]) == set(tracing.COUNTERS)
    assert set(snap["launches"]) == {
        "water_fill_rows", "scatter_words_rows", "vbr_reservoir_scan",
        "huffman_decode_sets", "mdct_frames_fused", "row_matmul",
        "segment_sums", "psy_smr_rows"}


def test_same_bytes_and_pcm_on_and_off(runs):
    (b0, (s0, p0)), (b1, (s1, p1)) = runs["off"], runs["on"]
    assert b0 == b1 and s0 == s1
    assert p0.shape == p1.shape and np.array_equal(p0, p1)


def test_span_names_are_the_tables(runs):
    names = {s[0] for s in runs["batch_snap"]["spans"]} | {
        s[0] for s in runs["stream_snap"]["spans"]}
    assert names == SPANS


@pytest.mark.parametrize("which", ["batch_snap", "stream_snap"])
def test_nesting_and_self_times(runs, which):
    """Every child inside its parent, every span under its parent's root,
    and the self times under each root adding up to its duration."""
    snap = runs[which]
    spans = snap["spans"]
    assert spans and snap["dropped"] == 0
    assert all(s[2] is not None and s[2] >= s[1] for s in spans)
    kids = _children(spans)
    self_ns = collections.Counter()
    for i, (name, t0, t1, parent, root) in enumerate(spans):
        self_ns[root] += (t1 - t0) - sum(spans[k][2] - spans[k][1]
                                         for k in kids[i])
        if parent < 0:
            assert root == i
        else:
            p = spans[parent]
            assert p[1] <= t0 and t1 <= p[2] and root == p[4]
    for r, ns in self_ns.items():
        assert ns == spans[r][2] - spans[r][1]


def test_batch_spans(runs):
    spans = runs["batch_snap"]["spans"]
    roots = collections.Counter(s[0] for s in spans if s[3] < 0)
    # the encode, then per clip its header and words_to_stream
    assert roots == {"tac.encode": 1, "tac.api.serialize": 4}
    enc = next(i for i, s in enumerate(spans) if s[0] == "tac.encode")
    under = collections.Counter(s[0] for s in spans if s[4] == enc)
    # 2 clips x 2 channels x 23 frames: one row chunk; the input's upload
    # (the quantizer's width is a constant, made in the run with tracing off)
    assert under == {"tac.encode": 1, "tac.codec.analysis": 2,
                     "tac.h2d": 1, "tac.codec.psy": 1, "tac.codec.alloc": 1,
                     "tac.codec.quant": 1, "tac.codec.pack": 1}


def test_stream_push_roots(runs):
    """Every span of a push under its push's root; the pinned number of
    host reads and uploads in every push that codes frames."""
    spans = runs["stream_snap"]["spans"]
    kids = _children(spans)
    under = collections.defaultdict(collections.Counter)
    for s in spans:
        under[s[4]][s[0]] += 1
    roots = [i for i, s in enumerate(spans) if s[3] < 0]
    named = collections.Counter(spans[i][0] for i in roots)
    # 87 hops (the last of 34 samples, no frame) and the flush, each through
    # both pushes; the header
    assert named == {"tac.stream.enc.push": 88, "tac.stream.dec.push": 88,
                     "tac.api.serialize": 1}
    coded = collections.Counter()
    for r in roots:
        name = spans[r][0]
        if name == "tac.api.serialize":
            continue
        first = [spans[k][0] for k in kids[r]]
        if name == "tac.stream.enc.push":
            assert first in (["tac.stream.enc.frame"],
                             ["tac.stream.enc.frame", "tac.stream.enc.core",
                              "tac.sync", "tac.api.serialize"])
        else:
            assert first in (["tac.stream.dec.walk"],
                             ["tac.stream.dec.walk", "tac.stream.dec.decode",
                              "tac.sync"])
        if len(first) > 1:
            coded[name] += 1
            got = {k: under[r][k] for k in ("tac.sync", "tac.h2d")}
            assert got == PUSH_SITES[name], (name, got)
    # the first push only fills the lookahead, the last hop completes no half
    assert coded == {"tac.stream.enc.push": 86, "tac.stream.dec.push": 86}


def test_cpu_streams_capture_no_graph(runs):
    """The CPU's pushes run eagerly: both graph counters are there and read
    0 with tracing on (the card's test holds their counts and spans)."""
    counters = runs["stream_snap"]["counters"]
    assert counters["graph_captures"] == 0 and counters["graph_replays"] == 0
    assert counters["syncs"] == 0 and counters["h2d_bytes"] == 0


def test_counters_count_device_transfers():
    """On the CPU no read or upload crosses a bus: the spans are recorded
    and the counters stay; an upload to another device (meta) counts its
    bytes, pageable."""
    tracing.enable(True)
    tracing.reset()
    try:
        a = np.arange(6, dtype=np.int32)
        assert tracing.upload(a, "cpu").tolist() == a.tolist()
        assert tracing.to_host(torch.ones(3)).tolist() == [1.0] * 3
        assert set(tracing.snapshot()["counters"].values()) == {0}
        assert tracing.upload(a, "meta").device.type == "meta"
        snap = tracing.snapshot()
    finally:
        tracing.enable(False)
        tracing.reset()
    assert [s[0] for s in snap["spans"]] == ["tac.h2d", "tac.sync", "tac.h2d"]
    assert snap["counters"] == {"syncs": 0, "d2h_bytes": 0, "h2d_bytes": 24,
                                "h2d_pageable_bytes": 24,
                                "graph_captures": 0, "graph_replays": 0}


def test_cap_counts_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    tracing.enable(True)
    tracing.reset()
    try:
        with tracing.span("a"):
            for _ in range(4):
                with tracing.span("b"):
                    with tracing.span("c"):
                        pass
        snap = tracing.snapshot()
    finally:
        tracing.enable(False)
        tracing.reset()
    assert [s[:1] + s[3:] for s in snap["spans"]] == [
        ("a", -1, 0), ("b", 0, 0), ("c", 1, 0)]
    assert snap["dropped"] == 6


def test_encode_profile_carries_the_spans(runs, tmp_path, capsys):
    """encode --profile turns tracing on for its call: the Chrome trace
    holds the tac.* ranges, and tracing is off again afterwards. (After
    `runs`, whose batch built the configuration's constants.)"""
    wav, pac = str(tmp_path / "in.wav"), str(tmp_path / "o.pac")
    t = np.arange(4410) / 44100
    write_wav(wav, 0.4 * np.sin(2 * np.pi * np.outer(t, [300, 450])), 44100)
    assert cli.main(["encode", wav, pac, "--preset", "stereo44-128",
                     "--profile", str(tmp_path / "prof"),
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    with open(tmp_path / "prof" / "encode_trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"tac.encode", "tac.codec.analysis", "tac.codec.pack",
            "tac.api.serialize"} <= names
    assert not tracing.enable(False)
