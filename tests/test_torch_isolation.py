"""The port's boundaries: flac_tpu_torch imports neither JAX nor flac_tpu,
its entry points default to CUDA and raise without a GPU, CPU tensors take
the plain versions without touching a launch counter, and the launchers
refuse CPU tensors instead of computing anything."""

from __future__ import annotations

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flac_tpu_torch.decode import frame_decoder as t_fd
from flac_tpu_torch.decode import seek as t_seek
from flac_tpu_torch.decode import stream as t_stream
from flac_tpu_torch.decode import streaming as t_streaming
from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.encode import encoder as t_encoder
from flac_tpu_torch.encode import frame_encoder as t_fe
from flac_tpu_torch.encode import packer as t_packer
from flac_tpu_torch.dsp import lpc as t_lpc
from flac_tpu_torch.kernels import (compact_stream, iir_scan, pack_words, residual_scan,
                                    restore_scan)
from flac_tpu_torch import replaygain as t_rg

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pathlib, sys
import flac_tpu_torch
root = pathlib.Path(flac_tpu_torch.__path__[0])
names = sorted(".".join(("flac_tpu_torch",) + p.relative_to(root).with_suffix("").parts)
               .removesuffix(".__init__") for p in root.rglob("*.py"))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flac_tpu") or m.startswith(("jax.", "flac_tpu.")))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_flac_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 43  # every module of the slices so far was imported


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_gpu(no_cuda, tmp_path):
    cfg = t_fe.EncoderConfig.from_level(5, 2, 16, 44100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_fe.build_frame_encoder(cfg)
    with open(tmp_path / "s.flac", "wb") as f, \
            pytest.raises(RuntimeError, match="CUDA is not available"):
        t_encoder.StreamEncoder(cfg, f)
    out = tmp_path / "e.flac"
    for verify in (False, True):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_encoder.encode_file(np.zeros((5000, 2), np.int32), 44100, 16, str(out),
                                  verify=verify)
    assert not out.exists()
    geom = t_fd.DecoderGeometry(blocksize=4096, channels=2, bits_per_sample=16,
                                sample_rate=44100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_fd.build_frame_decoder(geom)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_stream.StreamDecoder(b"fLaC")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_stream.decode_bytes_device(b"fLaC")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_seek.SeekableDecoder(b"fLaC")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_streaming.ChunkedStreamDecoder(io.BytesIO(b"fLaC"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_fe.build_frame_encoder_dense(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_rg.GainAnalysis(44100)
    (tmp_path / "r.flac").write_bytes(b"fLaC")
    for call in (t_rg.compute_replay_gain, t_rg.add_replay_gain_tags):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call([str(tmp_path / "r.flac")])
    assert (tmp_path / "r.flac").read_bytes() == b"fLaC"
    assert resolve_device("cpu") == torch.device("cpu")


def test_plain_word_fill_is_refused_on_cuda(monkeypatch):
    """FLAC_TPU_PACKER=xla serves the CPU tests only: a CUDA build refuses
    it (resolved before anything touches the card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = t_fe.EncoderConfig.from_level(5, 2, 16, 44100)
    monkeypatch.setenv("FLAC_TPU_PACKER", "xla")
    with pytest.raises(ValueError, match="CPU tests only"):
        t_fe.build_frame_encoder(cfg, device="cuda")
    with pytest.raises(ValueError, match="CPU tests only"):
        t_fe.build_frame_encoder_parts(cfg, device="cuda", packer_impl="xla")
    assert t_fe.resolve_packer_impl(None, torch.device("cpu")) == "xla"


def test_cpu_tensors_take_the_plain_fill_and_cuda_only_the_kernel():
    rng = np.random.default_rng(3)
    nbits = rng.integers(0, 34, size=(3, 50)).astype(np.int32)
    values = rng.integers(0, 1 << 62, size=(3, 50)) & ((1 << nbits.astype(np.int64)) - 1)
    v, n = torch.as_tensor(values), torch.as_tensor(nbits)
    before = pack_words.launches
    got = t_packer.pack_fields_kernel(v, n, 60)
    ref = t_packer.pack_fields(v, n, 60)
    assert pack_words.launches == before
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    # the kernel launcher refuses CPU tensors instead of computing anything
    with pytest.raises(ValueError, match="CUDA"):
        pack_words.pack_words(v, n, 60)


def _scan_inputs(B=2, T=8):
    words = torch.as_tensor(np.random.default_rng(5).integers(
        -2 ** 31, 2 ** 31, 64, dtype=np.int64).astype(np.int32))
    pos = torch.tensor([0, 300], dtype=torch.int64)[:B]
    return (words, pos, pos * 0 + 16, T, 4)


def test_cpu_tensors_leave_the_new_launch_counters_alone():
    rng = np.random.default_rng(4)
    nbits = rng.integers(0, 34, size=(3, 50)).astype(np.int32)
    values = rng.integers(0, 1 << 62, size=(3, 50)) & ((1 << nbits.astype(np.int64)) - 1)
    v, n = torch.as_tensor(values), torch.as_tensor(nbits)
    counts = (pack_words.pack_words_multi.launches, residual_scan.launches,
              restore_scan.launches, compact_stream.launches)
    got = t_packer.pack_fields_merged_kernel(v, n, 60)
    ref = t_packer.pack_fields_merged(v, n, 60)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    args = _scan_inputs()
    sub, res, pos, ovf = t_fd.subframe_scan_kernel(*args)
    ref = t_fd.subframe_scan(*args)
    assert all(torch.equal(sub[k], ref[0][k]) for k in ref[0])
    assert all(torch.equal(a, b) for a, b in zip((res, pos, ovf), ref[1:]))
    rargs = (res, *t_fd.restore_inputs(sub, 4), 8, 4)
    assert torch.equal(t_fd.restore_scan_kernel(*rargs), t_fd.restore_scan(*rargs))
    words = torch.as_tensor(np.random.default_rng(7).integers(
        -2 ** 31, 2 ** 31, (3, 6), dtype=np.int64).astype(np.int32))
    tbits = torch.tensor([96, 40, 184], dtype=torch.int32)
    got = t_packer.compact_stream_words_kernel(words, tbits)
    ref = t_packer.compact_stream_words(words, tbits)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    largs = (res, torch.ones((2, 4), dtype=torch.int32), torch.tensor([2, 4]),
             torch.tensor([1, 0]), torch.ones((2, 4), dtype=torch.int32), 4)
    assert torch.equal(t_lpc.lpc_restore(*largs), t_lpc.lpc_restore_plain(*largs))
    assert counts == (pack_words.pack_words_multi.launches, residual_scan.launches,
                      restore_scan.launches, compact_stream.launches)


def test_pack_stage_on_cpu_tensors_runs_the_plain_composition():
    """pack_frames_kernel and pack() on CPU tensors: the plain fill, CRC-16
    and insertion, no launch counter touched; the launchers refuse CPU
    tensors in the fused mode too."""
    rng = np.random.default_rng(6)
    nbits = rng.integers(0, 34, size=(3, 50)).astype(np.int32)
    nbits[:, -2:] = [[8 - int(s) % 8, 16] for s in nbits[:, :-2].sum(1) + 8]
    values = rng.integers(0, 1 << 62, size=(3, 50)) & ((1 << nbits.astype(np.int64)) - 1)
    values[:, -2:] = 0
    v, n = torch.as_tensor(values), torch.as_tensor(nbits)
    tbl, inv = (torch.as_tensor(t) for t in t_packer.crc16_word_tables(60))
    counts = (pack_words.launches, pack_words.pack_words_multi.launches,
              pack_words.crc_finish_launches)
    for merged in (False, True):
        got = t_packer.pack_frames_kernel(v, n, 60, tbl, inv, merged)
        ref = t_packer.pack_frames(v, n, 60, tbl, inv, merged)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        launch = pack_words.pack_words_multi if merged else pack_words.pack_words
        with pytest.raises(ValueError, match="CUDA"):
            launch(v, n, 60, tbl, inv)
    assert counts == (pack_words.launches, pack_words.pack_words_multi.launches,
                      pack_words.crc_finish_launches)


def test_new_launchers_refuse_cpu_tensors():
    v = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        pack_words.pack_words_multi(v, v.to(torch.int32), 4)
    args = _scan_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        residual_scan.subframe_scan(*args)
    res = torch.zeros((2, 8), dtype=torch.int32)
    c = torch.zeros((2, 4), dtype=torch.int64)
    i64 = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        restore_scan.restore_scan(res, c, i64, i64, c, i64 == 0, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        compact_stream.compact_stream(res, i64.to(torch.int32))
    x = torch.zeros((2, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        iir_scan.equal_loudness(x, t_rg.equalizer_taps(10))
    before = iir_scan.launches
    assert torch.equal(t_rg.equal_loudness(x, 10), x)  # the plain version on the CPU
    assert iir_scan.launches == before
