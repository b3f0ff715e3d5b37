"""The port's example programs (examples/torch/) and bench_torch.py on the
CPU: each example runs in process with FLAC_TPU_DEVICE=cpu on a short WAV
(two full frames of 4096 and a partial one: every decode call runs the
plain scan, a Python loop over the blocksize) and returns the input PCM;
bench_torch.py's corpus equals bench.py's, its functions run at a small
blocksize, and its whole CPU run prints bench.py's keys."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench
import bench_torch
from tests.conftest import make_signal

from flac_tpu_torch.containers import AudioBuffer, read_audio, write_wav
from flac_tpu_torch.decode.host_decoder import decode_bytes
from flac_tpu_torch.metadata import get_tags

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"
N = 4096 * 2 + 1000


def _run(name: str, argv: list[str], monkeypatch) -> int:
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return mod.main()


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    pcm = make_signal(N, 2, 16, kind="quiet", seed=21)
    write_wav(str(d / "in.wav"), AudioBuffer(samples=pcm, sample_rate=44100,
                                             bits_per_sample=16))
    return d, pcm


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FLAC_TPU_DEVICE", "cpu")


def test_encode_then_decode_examples(wav, monkeypatch, capsys):
    d, pcm = wav
    assert _run("encode_example", [str(d / "in.wav"), str(d / "a.flac")], monkeypatch) == 0
    data = (d / "a.flac").read_bytes()
    out, si, _ = decode_bytes(data)  # CRC-8, CRC-16 and MD5 checked
    np.testing.assert_array_equal(out, pcm)
    assert get_tags(str(d / "a.flac")).comments == ["ARTIST=example", "TITLE=example"]
    assert _run("decode_example", [str(d / "a.flac"), str(d / "a.wav")], monkeypatch) == 0
    np.testing.assert_array_equal(read_audio(str(d / "a.wav")).samples, pcm)
    assert "path=device" in capsys.readouterr().out


def test_stream_decode_example(wav, monkeypatch, capsys):
    d, pcm = wav
    if not (d / "a.flac").exists():
        _run("encode_example", [str(d / "in.wav"), str(d / "a.flac")], monkeypatch)
    assert _run("stream_decode_example", [str(d / "a.flac"), str(d / "s.wav")],
                monkeypatch) == 0
    np.testing.assert_array_equal(read_audio(str(d / "s.wav")).samples, pcm)
    assert "(3 frames); MD5 verified" in capsys.readouterr().out


def test_pipe_decode_example(wav, monkeypatch, capsysbinary):
    d, pcm = wav
    if not (d / "a.flac").exists():
        _run("encode_example", [str(d / "in.wav"), str(d / "a.flac")], monkeypatch)
    with open(d / "a.flac", "rb") as f:
        monkeypatch.setattr(sys, "stdin", type("Pipe", (), {"buffer": f}))
        assert _run("pipe_decode_example", [], monkeypatch) == 0
    raw = capsysbinary.readouterr().out
    np.testing.assert_array_equal(np.frombuffer(raw, "<i4").reshape(-1, 2), pcm)


def test_oo_api_example(wav, monkeypatch, capsys):
    d, pcm = wav
    assert _run("oo_api_example", [str(d / "in.wav"), str(d / "o.flac")], monkeypatch) == 0
    assert "round trip: bit-exact" in capsys.readouterr().out
    out, _, _ = decode_bytes((d / "o.flac").read_bytes())
    np.testing.assert_array_equal(out, pcm)


@pytest.mark.parametrize("seed", [7, 12])
def test_bench_corpus_equals_bench_py(seed):
    np.testing.assert_array_equal(bench_torch.make_corpus(5000, seed),
                                  bench.make_corpus(5000, seed))


def test_bench_functions_at_a_small_blocksize(monkeypatch):
    """bench_torch's encode and decode rows on the CPU at T=256: the fetched
    frames form a stream that decodes to the corpus, and the decode row
    checks its first batch against the input."""
    import torch

    monkeypatch.setattr(bench_torch, "T", 256)
    cpu = torch.device("cpu")
    rate, frames = bench_torch.bench_encode(5, 4, 2, 1, cpu)
    assert rate > 0 and len(frames) == 2
    stream = bench_torch._assemble_stream(frames, 8 * 256)
    expect = np.concatenate([bench_torch.make_corpus(4 * 256, seed=7 + i) for i in range(2)])
    out, _, _ = decode_bytes(stream, check_md5=False)
    np.testing.assert_array_equal(out, expect)
    assert bench_torch.bench_decode(stream, 8, 4, 1, cpu, fetch=False,
                                    expect=expect[:4 * 256].reshape(4, 256, 2)) > 0
    rate_kernel, none = bench_torch.bench_encode(5, 4, 2, 1, cpu, fetch=False)
    assert rate_kernel > 0 and none is None


@pytest.mark.slow
def test_bench_torch_cpu_run_prints_bench_py_keys():
    r = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], cwd=str(REPO),
                       env={**os.environ, "FLAC_TPU_DEVICE": "cpu"},
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["extra"]["device"]["platform"] == "cpu"
    for row in ("decode_-5", "encode_-8", "encode_-5_kernel", "encode_-8_kernel",
                "decode_-8", "compression_ratio", "decode_-5_delivered"):
        assert row in line["extra"], row
