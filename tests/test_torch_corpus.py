"""The port's corpus jobs (tac_torch/corpus.py) on tests/test_corpus.py's
material, without its two mesh tests: batched bytes equal solo encodes in
every family, resume and quarantine both ways, mixed families in one decode
job, the batched decode within one 16-bit LSB of a solo decode; and across
packages: a manifest tac wrote resumes in the port and the port's records
parse in tac, and the parity .pac files equal tac's CorpusTranscoder's (one
tac corpus run, the file's only tac codec call)."""

import json
import os

import numpy as np
import pytest
import torch

from tac.config import PRESETS as JPRESETS
from tac.corpus import CorpusTranscoder as JTranscoder
from tac.corpus import _load_manifest as tac_load_manifest
from tac_torch import api, corpus, parallel, tuning
from tac_torch.config import PRESETS
from tac_torch.corpus import CorpusDecoder, CorpusTranscoder
from tac_torch.io.wav import read_wav, write_wav

SMALL = dict(sample_rate=16000, n_channels=1, n_mdct_lines=256,
             bitrate_bps=64000)
CFG = PRESETS["corpus"].replace(**SMALL)
FAMILIES = {
    "corpus": CFG,
    "vbr-huffman": CFG.replace(use_huffman=True),
    "bs": CFG.replace(use_block_switch=True, n_mdct_lines_short=64),
    "vbr-bs": CFG.replace(use_huffman=True, use_block_switch=True,
                          n_mdct_lines_short=64),
    # the M/S combo on a two-channel form of the material
    "vbr-ms-bs": CFG.replace(use_huffman=True, use_block_switch=True,
                             n_mdct_lines_short=64, n_channels=2,
                             stereo_mode="ms"),
}
LENGTHS = (4000, 7000, 12000, 12500)
QUIET = dict(log=lambda *a: None)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _clips(channels: int):
    """tests/test_corpus.py's clips (four tones with a little noise, two
    length buckets); the second channel, where asked, is the first delayed
    and at 0.8."""
    fs = 16000
    rng = np.random.default_rng(5)
    out = []
    for i, n in enumerate(LENGTHS):
        t = np.arange(n) / fs
        x = 0.4 * np.sin(2 * np.pi * (200 + 60 * i) * t) \
            + 0.01 * rng.standard_normal(n)
        out.append(x if channels == 1 else
                   np.stack([x, 0.8 * np.roll(x, 23)], axis=1))
    return out


def _write(dir_, clips, prefix="clip"):
    os.makedirs(dir_, exist_ok=True)
    paths = []
    for i, x in enumerate(clips):
        p = os.path.join(dir_, f"{prefix}{i}.wav")
        write_wav(p, x, 16000)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    return {1: _write(str(root / "mono"), _clips(1)),
            2: _write(str(root / "stereo"), _clips(2), "stereo")}


def _pac(out_dir, wav):
    return os.path.join(out_dir,
                        os.path.splitext(os.path.basename(wav))[0] + ".pac")


def _records(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def _solo(wav, cfg):
    return api.encode_array(read_wav(wav)[0], cfg, device="cpu")


def test_default_batch_size_is_eight_on_the_cpu(wavs, tmp_path):
    """batch_size=None takes tuning.CORPUS_BATCH: 8, as tac's off a TPU;
    the bytes equal solo encodes."""
    assert tuning.CORPUS_BATCH == 8
    tc = CorpusTranscoder(CFG, str(tmp_path), device="cpu")
    assert tc.batch_size == 8
    stats = tc.run(wavs[1][:2], **QUIET)
    assert stats["ok"] == 2 and stats["failed"] == 0
    for p in wavs[1][:2]:
        assert open(_pac(tmp_path, p), "rb").read() == _solo(p, CFG)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_batched_bytes_equal_solo(wavs, tmp_path, family):
    """One batch of four clips in two length buckets: each .pac equals the
    solo encode_array (bucket zeros are the codec's flush padding; every
    VBR lane, a channel or an M/S pair, starts its chain at 0), and no
    clip took the per-clip fallback."""
    cfg = FAMILIES[family]
    paths = wavs[cfg.n_channels]
    tc = CorpusTranscoder(cfg, str(tmp_path), batch_size=4, device="cpu")
    tc._encode_one = None                       # the fallback must not run
    stats = tc.run(paths, **QUIET)
    assert stats == {"ok": 4, "failed": 0, "audio_s": sum(LENGTHS) / 16000,
                     "wall_s": pytest.approx(stats["wall_s"])}
    for p in paths:
        assert open(_pac(tmp_path, p), "rb").read() == _solo(p, cfg), p
    assert [r["status"] for r in _records(tmp_path / "manifest.jsonl")] \
        == ["ok"] * 4


def test_resume_and_quarantine_encode(wavs, tmp_path, monkeypatch):
    """A re-run encodes only what is not ok; a file that does not read is
    read_error; a failed batch falls back to per-clip encodes, each tried
    1 + retries times, and a clip that keeps failing is quarantined; a
    group whose config cannot exist (three channels under M/S) too."""
    paths = wavs[1]
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    three = _write(str(tmp_path / "three"),
                   [np.stack([_clips(1)[0]] * 3, axis=1)], "three")[0]
    out = tmp_path / "out"
    tc = CorpusTranscoder(FAMILIES["vbr-ms-bs"].replace(n_channels=1,
                                                        stereo_mode="lr"),
                          str(out), batch_size=2, device="cpu")
    assert tc.run(paths[:2], **QUIET)["ok"] == 2
    first = [os.path.getmtime(_pac(out, p)) for p in paths[:2]]

    real = parallel.encode_batch_packed
    calls = []

    def flaky(x, cfg, device=None):             # batches and clip 3 fail
        calls.append(x.shape[0])
        if x.shape[0] > 1 or np.abs(x[..., 12000:]).sum() > 0:
            raise RuntimeError("injected")
        return real(x, cfg, device)

    monkeypatch.setattr(parallel, "encode_batch_packed", flaky)
    tc.cfg = FAMILIES["vbr-ms-bs"]
    tc.run([str(bad), three], **QUIET)
    tc.cfg = FAMILIES["vbr-ms-bs"].replace(n_channels=1, stereo_mode="lr")
    stats = tc.run(paths, **QUIET)
    assert stats["ok"] == 3 and stats["failed"] == 1
    # the resume skipped clips 0-1; clips 2-3 failed as a batch, then alone:
    # clip 2 once, clip 3 twice (retries=1)
    assert calls == [2, 1, 1, 1]
    assert [os.path.getmtime(_pac(out, p)) for p in paths[:2]] == first
    recs = {r["clip"]: r["status"] for r in _records(out / "manifest.jsonl")}
    assert recs == {paths[0]: "ok", paths[1]: "ok", paths[2]: "ok",
                    paths[3]: "quarantined", str(bad): "read_error",
                    three: "quarantined"}
    assert open(_pac(out, paths[2]), "rb").read() == _solo(paths[2], tc.cfg)


def _encode_all(wavs, tmp_path, cfg, sub):
    out = tmp_path / sub
    CorpusTranscoder(cfg, str(out), batch_size=4, device="cpu").run(
        wavs[cfg.n_channels], **QUIET)
    return [_pac(out, p) for p in wavs[cfg.n_channels]]


def _assert_decodes_like_solo(pacs, out):
    """Each decoded WAV within one 16-bit LSB of the solo fast decode
    quantized by write_wav's rounding (tests/test_corpus.py:178)."""
    for p in pacs:
        y_solo, fs = api.decode_array(open(p, "rb").read(), "fast",
                                      device="cpu")
        name = os.path.splitext(os.path.basename(p))[0] + ".wav"
        y, fs2 = read_wav(os.path.join(out, name))
        assert fs2 == fs and y.shape == y_solo.shape
        ref = np.clip(np.round(y_solo * 32768.0), -32768, 32767) / 32768.0
        np.testing.assert_allclose(y, ref, rtol=0, atol=1.001 / 32768.0)


def test_corpus_decode_matches_solo(wavs, tmp_path):
    """Batched decode (frames zero-padded to 32, int16 on the device) in
    one job of mixed families, three groups by header config (fixed rate,
    VBR, the stereo M/S combo), against solo decodes."""
    pacs = (_encode_all(wavs, tmp_path, FAMILIES["corpus"], "raw")[:2]
            + _encode_all(wavs, tmp_path, FAMILIES["vbr-huffman"], "vbr")[2:]
            + _encode_all(wavs, tmp_path, FAMILIES["vbr-ms-bs"], "ms")[:2])
    dec = CorpusDecoder(str(tmp_path / "dec"), batch_size=8, device="cpu")
    dec._decode_one = None                      # the fallback must not run
    stats = dec.run(pacs, **QUIET)
    assert stats["ok"] == 6 and stats["failed"] == 0
    _assert_decodes_like_solo(pacs, str(tmp_path / "dec"))


def test_corpus_decode_resume_and_quarantine(wavs, tmp_path, monkeypatch):
    """Decode: a re-run skips what is ok; bytes that are not PAC-T are
    corrupt (with the error's type), a truncated stream too, a missing
    file read_error; a failed batch falls back per stream, and a stream
    that keeps failing is quarantined."""
    pacs = _encode_all(wavs, tmp_path, FAMILIES["vbr-huffman"], "enc")
    junk = tmp_path / "junk.pac"
    junk.write_bytes(b"\x00" * 16)
    cut = tmp_path / "cut.pac"
    cut.write_bytes(open(pacs[3], "rb").read()[:-40])
    out = tmp_path / "dec"
    dec = CorpusDecoder(str(out), batch_size=2, device="cpu")
    assert dec.run(pacs[:2], **QUIET)["ok"] == 2

    real = parallel.decode_batch_packed
    calls = []

    f3 = CorpusDecoder._stage(dec, open(pacs[3], "rb").read())[2].shape[1]

    def flaky(words, cfg, t, **kw):             # batches and the 4th fail
        calls.append(words.shape[0])
        if words.shape[0] > 1 or np.any(words[:, :, f3 - 1]):
            raise RuntimeError("injected")
        return real(words, cfg, t, **kw)

    monkeypatch.setattr(parallel, "decode_batch_packed", flaky)
    missing = str(tmp_path / "missing.pac")
    stats = dec.run(pacs + [str(junk), str(cut), missing], **QUIET)
    assert stats["ok"] == 3 and stats["failed"] == 4
    assert calls == [2, 1, 1, 1]
    recs = {r["clip"]: r for r in _records(out / "decode_manifest.jsonl")}
    assert {k: r["status"] for k, r in recs.items()} == {
        pacs[0]: "ok", pacs[1]: "ok", pacs[2]: "ok",
        pacs[3]: "quarantined", str(junk): "corrupt", str(cut): "corrupt",
        missing: "read_error"}
    assert recs[str(junk)]["error"] == "ValueError"
    assert recs[str(cut)]["error"] == "CorruptStreamError"
    _assert_decodes_like_solo(pacs[:3], str(out))


@pytest.fixture(scope="module")
def tac_job(wavs, tmp_path_factory):
    """tac's CorpusTranscoder, parity, on clips 0-1: its output directory
    and manifest."""
    out = str(tmp_path_factory.mktemp("tac_job"))
    jcfg = JPRESETS["corpus"].replace(precision="parity", **SMALL)
    stats = JTranscoder(jcfg, out, batch_size=4).run(wavs[1][:2], **QUIET)
    assert stats["ok"] == 2
    return out


def test_parity_bytes_equal_tac_corpus(wavs, tac_job, tmp_path):
    """In parity precision the port's corpus .pac files are tac's
    CorpusTranscoder's, byte for byte."""
    cfg = CFG.replace(precision="parity")
    CorpusTranscoder(cfg, str(tmp_path), batch_size=4, device="cpu").run(
        wavs[1][:2], **QUIET)
    for p in wavs[1][:2]:
        assert open(_pac(tmp_path, p), "rb").read() == \
            open(_pac(tac_job, p), "rb").read(), p


def test_manifests_cross_packages(wavs, tac_job, tmp_path):
    """A job tac started resumes in the port: tac's ok clips are skipped
    and their .pac files not rewritten, the rest encoded; the port's
    records parse in tac's _load_manifest (a torn last line included)."""
    out = tmp_path / "job"
    out.mkdir()
    for name in os.listdir(tac_job):
        (out / name).write_bytes(open(os.path.join(tac_job, name),
                                      "rb").read())
    manifest = out / "manifest.jsonl"
    recs = _records(manifest)
    for r in recs:                               # tac's out paths, moved
        r["out"] = str(out / os.path.basename(r["out"]))
    manifest.write_text("".join(json.dumps(r) + "\n" for r in recs))
    before = {p: os.path.getmtime(_pac(out, p)) for p in wavs[1][:2]}
    cfg = CFG.replace(precision="parity")
    stats = CorpusTranscoder(cfg, str(out), batch_size=4, device="cpu").run(
        wavs[1], **QUIET)
    assert stats["ok"] == 4 and stats["failed"] == 0
    assert {p: os.path.getmtime(_pac(out, p)) for p in wavs[1][:2]} == before
    assert [r["clip"] for r in _records(manifest)] == wavs[1]
    with open(manifest, "a") as f:
        f.write('{"clip": "torn')
    done = tac_load_manifest(str(manifest))
    assert done == corpus._load_manifest(str(manifest))
    assert sorted(done) == sorted(wavs[1])
    for p in wavs[1]:
        assert done[p]["status"] == "ok" and set(done[p]) == {
            "clip", "status", "out", "seconds", "kbps", "wall_s"}
        assert open(done[p]["out"], "rb").read() == _solo(p, cfg)
