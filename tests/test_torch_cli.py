"""The port's command line (tac_torch/cli.py), every subcommand run on the
CPU through cli.main([..., "--device", "cpu"]) against the API it wraps;
`info` against tac's own `info`; and without a card nor --device, a nonzero
exit with no output file."""

import json
import os

import numpy as np
import pytest
import torch

from tac import cli as jcli
from tac_torch import api, cli
from tac_torch.config import PRESETS, CodecConfig
from tac_torch.io.wav import read_wav, write_wav

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """0.5 s of 16 kHz mono and 0.25 s of 44.1 kHz stereo, tones and a
    little noise."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(3)
    out = {}
    for name, fs, n, ch in (("mono", 16000, 8000, 1),
                            ("stereo", 44100, 11025, 2)):
        t = np.arange(n) / fs
        x = np.stack([0.4 * np.sin(2 * np.pi * (300 + 200 * c) * t)
                      + 0.01 * rng.standard_normal(n) for c in range(ch)], 1)
        p = str(root / f"{name}.wav")
        write_wav(p, x, fs)
        out[name] = p
    return out


def _run(argv, capsys) -> dict:
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,flags,preset", [
    ("mono", ["--preset", "mono16-64"], "mono16-64"),
    ("stereo", ["--preset", "vbr-huffman", "--huffman-sets", "3"],
     "vbr-huffman"),
    ("stereo", ["--huffman", "--blockswitch", "--stereo", "ms",
                "--bitrate", "96000", "--precision", "parity"],
     None),
])
def test_encode_decode_info(wavs, tmp_path, capsys, name, flags, preset):
    """encode writes api.encode_array's bytes of the config the flags build
    (rate and channels from the WAV); decode writes decode_array's audio
    through write_wav, and with --start / --duration decode_range's;
    info prints tac's info JSON for the same file."""
    src, pac = wavs[name], str(tmp_path / "o.pac")
    stats = _run(["encode", src, pac, *flags, *CPU], capsys)
    x, fs = read_wav(src)
    cfg = PRESETS[preset] if preset else CodecConfig()
    kw = dict(sample_rate=fs, n_channels=x.shape[1])
    if preset is None:
        kw.update(use_huffman=True, use_block_switch=True, stereo_mode="ms",
                  bitrate_bps=96000, precision="parity")
    elif "--huffman-sets" in flags:
        kw["huffman_sets"] = 3
    data = open(pac, "rb").read()
    assert data == api.encode_array(x, cfg.replace(**kw), device="cpu")
    assert stats["bytes"] == len(data) and set(stats) == {
        "seconds", "bytes", "kbps", "encode_s"}

    wav = str(tmp_path / "d.wav")
    stats = _run(["decode", pac, wav, *CPU], capsys)
    ref = str(tmp_path / "ref.wav")
    write_wav(ref, api.decode_array(data, "fast", device="cpu")[0], fs)
    assert open(wav, "rb").read() == open(ref, "rb").read()
    assert stats["sample_rate"] == fs and stats["channels"] == x.shape[1]

    stats = _run(["decode", pac, wav, "--start", "0.05", "--duration",
                  "0.1", "--precision", "parity", *CPU], capsys)
    s0 = int(round(0.05 * fs))
    write_wav(ref, api.decode_range(data, s0, s0 + int(round(0.1 * fs)),
                                    "parity", device="cpu")[0], fs)
    assert open(wav, "rb").read() == open(ref, "rb").read()
    assert stats["start_sample"] == s0

    mine = _run(["info", pac], capsys)
    assert jcli.main(["info", pac]) == 0
    assert mine == json.loads(capsys.readouterr().out.strip())


def test_encode_profile_writes_a_trace(wavs, tmp_path, capsys):
    """encode --profile DIR writes a torch.profiler trace beside the same
    bytes."""
    pac = str(tmp_path / "o.pac")
    _run(["encode", wavs["mono"], pac, "--preset", "mono16-64", "--profile",
          str(tmp_path / "prof"), *CPU], capsys)
    trace = json.load(open(tmp_path / "prof" / "encode_trace.json"))
    assert trace["traceEvents"]
    assert open(pac, "rb").read() == api.encode_array(
        read_wav(wavs["mono"])[0], PRESETS["mono16-64"], device="cpu")


@pytest.mark.parametrize("flag", ["-v", "--verbose"])
def test_encode_takes_tacs_verbose_flag(wavs, tmp_path, capsys, flag):
    """tac's encode takes -v / --verbose (tac/cli.py: parsed, read by
    nothing); the port's takes the same command line, exits 0 and writes
    the bytes tac's CLI writes for it (parity)."""
    args = [wavs["mono"], "--preset", "mono16-64", "--precision", "parity"]
    pac, jpac = str(tmp_path / "o.pac"), str(tmp_path / "j.pac")
    _run(["encode", args[0], pac, flag, *args[1:], *CPU], capsys)
    assert jcli.main(["encode", args[0], jpac, flag, *args[1:]]) == 0
    assert open(pac, "rb").read() == open(jpac, "rb").read()


def test_bench_prints_its_keys(wavs, capsys):
    out = _run(["bench", wavs["mono"], "--preset", "mono16-64", *CPU], capsys)
    assert set(out) == {"audio_s", "encode_s", "throughput_x", "kbps",
                        "device"}
    assert out["audio_s"] == 0.5 and out["device"] == "cpu"


def test_corpus_and_corpus_decode(wavs, tmp_path, capsys):
    """corpus encodes each WAV to api.encode_array's bytes (one group per
    rate and channel count) and resumes; corpus-decode writes each stream
    within one LSB of decode_array."""
    out = str(tmp_path / "enc")
    srcs = [wavs["mono"], wavs["stereo"]]
    stats = _run(["corpus", *srcs, "-o", out, "--preset", "corpus", *CPU],
                 capsys)
    assert stats["ok"] == 2 and stats["failed"] == 0
    pacs = []
    for p in srcs:
        x, fs = read_wav(p)
        pacs.append(os.path.join(out, os.path.basename(p)[:-4] + ".pac"))
        cfg = PRESETS["corpus"].replace(sample_rate=fs, n_channels=x.shape[1])
        assert open(pacs[-1], "rb").read() == api.encode_array(x, cfg,
                                                               device="cpu")
    assert _run(["corpus", *srcs, "-o", out, *CPU], capsys)["ok"] == 2
    dec = str(tmp_path / "dec")
    stats = _run(["corpus-decode", *pacs, "-o", dec, "--batch-size", "1",
                  *CPU], capsys)
    assert stats["ok"] == 2 and stats["failed"] == 0
    for p in pacs:
        y = read_wav(os.path.join(dec, os.path.basename(p)[:-4] + ".wav"))[0]
        ref = api.decode_array(open(p, "rb").read(), "fast", device="cpu")[0]
        np.testing.assert_allclose(
            y, np.clip(np.round(ref * 32768.0), -32768, 32767) / 32768.0,
            rtol=0, atol=1.001 / 32768.0)


@pytest.mark.parametrize("cmd", ["encode", "decode", "bench", "corpus",
                                 "corpus-decode"])
def test_no_card_exits_nonzero_without_output(wavs, tmp_path, capsys,
                                              monkeypatch, cmd):
    """Without a card and without --device (default cuda), every command
    that codes exits 2 with resolve_device's message and writes nothing;
    it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    argv = {"encode": ["encode", wavs["mono"], str(out)],
            "decode": ["decode", wavs["mono"], str(out)],
            "bench": ["bench", wavs["mono"]],
            "corpus": ["corpus", wavs["mono"], "-o", str(out)],
            "corpus-decode": ["corpus-decode", wavs["mono"], "-o",
                              str(out)]}[cmd]
    assert cli.main(argv) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "device='cpu'" in cap.err
    assert not out.exists()
