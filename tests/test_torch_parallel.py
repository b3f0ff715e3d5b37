"""The port's multi-process path (flac_tpu_torch.parallel.sharding) against
flac_tpu's mesh path: gloo ranks in worker processes on the CPU
(tests/_torch_dist_worker.py, which imports no JAX) against flac_tpu on a
2-device CPU mesh, with the same seeded PCM. Every worker has a deadline:
after it the workers are killed and the test fails, so a rank that raises
cannot leave the other waiting in a collective past it."""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import cpu_devices, make_signal
from test_ogg import _make_variable_blocksize_flac

from flac_tpu.encode.frame_encoder import EncoderConfig as JaxEncoderConfig
from flac_tpu.parallel import sharding as j_sharding

from flac_tpu_torch.encode.encoder import encode_file as t_encode_file
from flac_tpu_torch.encode.frame_encoder import EncoderConfig
from flac_tpu_torch.parallel import sharding as t_sharding

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_dist_worker.py"
BS = 256
STEP_FRAMES = 16
DEADLINE_S = 120


def _jax_cfg():
    return JaxEncoderConfig.from_level(5, channels=2, bits_per_sample=16,
                                       sample_rate=44100, blocksize=BS)


class _Workers:
    """Worker processes started together; `result` waits for all of them
    until the shared deadline, then kills any left and fails."""

    def __init__(self, tmp: Path, inputs: Path, runs: dict[str, tuple[int, list[str]]],
                 device: str = "cpu"):
        self.tmp, self.procs, self.outs = tmp, [], {}
        self.start = time.monotonic()
        for name, (world, tasks) in runs.items():
            init = tmp / f"init_{name}"
            for rank in range(world):
                out = tmp / f"{name}_{rank}.npz"
                self.outs[(name, rank)] = out
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(WORKER), str(rank), str(world), str(init),
                     str(inputs), str(out), device, *tasks],
                    cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        self.done = False

    def result(self, name: str, rank: int) -> dict:
        if not self.done:
            logs = []
            try:
                for p in self.procs:
                    left = max(DEADLINE_S - (time.monotonic() - self.start), 1)
                    logs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"a worker passed its {DEADLINE_S} s deadline")
            self.done = True
            bad = [(p.returncode, log[-3000:]) for p, log in zip(self.procs, logs)
                   if p.returncode]
            assert not bad, bad
        return dict(np.load(self.outs[(name, rank)]))

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def signals():
    corpus = make_signal(BS * 20 + 123, 2, 16, kind="quiet", seed=6)
    return dict(step_pcm=make_signal(BS * STEP_FRAMES, 2, 16, kind="quiet", seed=50),
                corpus=corpus, ragged=np.array(BS * 7 + 201),
                variable=np.frombuffer(
                    _make_variable_blocksize_flac([64] * 8 + [160] * 8)[0], np.uint8))


@pytest.fixture(scope="module")
def workers(tmp_path_factory, signals):
    """Two gloo ranks (every task) and one rank alone (the corpus tasks)."""
    tmp = tmp_path_factory.mktemp("dist")
    np.savez(tmp / "inputs.npz", **signals)
    w = _Workers(tmp, tmp / "inputs.npz", {"pair": (2, ["step", "audit", "corpus"]),
                                           "solo": (1, ["corpus"])})
    yield w
    w.kill()


@pytest.fixture(scope="module")
def mesh2():
    devs = cpu_devices()
    if len(devs) < 2:
        pytest.skip("needs 2 virtual devices")
    return j_sharding.make_mesh(devs[:2])


def test_encode_step_matches_flac_tpu_mesh_rows(signals, workers, mesh2):
    frames = signals["step_pcm"].reshape(STEP_FRAMES, BS, 2)
    step = j_sharding.build_sharded_encode_step(_jax_cfg(), mesh2, STEP_FRAMES // 2)
    ref = step(jnp.asarray(frames), jnp.asarray(np.arange(STEP_FRAMES, dtype=np.int64)))
    fpd = STEP_FRAMES // 2
    for rank in range(2):
        got = workers.result("pair", rank)
        rows = slice(rank * fpd, (rank + 1) * fpd)
        for k in ("words", "nbytes", "stream_offset", "assignment"):
            np.testing.assert_array_equal(got[f"step_{k}"], np.asarray(getattr(ref, k))[rows],
                                          err_msg=k)
        for k in ("min_framesize", "max_framesize", "total_bytes"):
            assert int(got[f"step_{k}"]) == int(getattr(ref, k)), k
        # the convenience form: the whole batch in, this rank's rows out
        np.testing.assert_array_equal(got["frames_sharded_words"], got["step_words"])


def test_corpus_stream_matches_flac_tpu_and_encode_file(signals, workers, mesh2, tmp_path):
    corpus, ragged = signals["corpus"], int(signals["ragged"])
    ref = j_sharding.encode_corpus_sharded([corpus[:ragged], corpus[ragged:]], _jax_cfg(),
                                           mesh2, frames_per_device=8)
    path = tmp_path / "one.flac"
    t_encode_file(corpus, 44100, 16, str(path), level=5, blocksize=BS, device="cpu")
    assert path.read_bytes() == ref
    for name, rank in (("pair", 0), ("pair", 1), ("solo", 0)):
        assert workers.result(name, rank)["corpus_stream"].tobytes() == ref, (name, rank)


def test_decode_corpus_returns_input_on_every_rank(signals, workers):
    for name, rank in (("pair", 0), ("pair", 1), ("solo", 0)):
        np.testing.assert_array_equal(workers.result(name, rank)["decoded"],
                                      signals["corpus"])


def test_decode_corpus_raises_as_flac_tpu_does(signals, workers, mesh2):
    stream = workers.result("pair", 0)["corpus_stream"].tobytes()
    bad = bytearray(stream)
    bad[len(bad) - 600] ^= 0x10
    with pytest.raises(Exception) as corrupt:
        j_sharding.decode_corpus_sharded(bytes(bad), mesh2, frames_per_device=2,
                                         max_lpc_order=12)
    with pytest.raises(Exception) as variable:
        j_sharding.decode_corpus_sharded(signals["variable"].tobytes(), mesh2,
                                         frames_per_device=2)
    assert corrupt.type.__name__ in ("DecodeError", "StreamDecodeError")
    assert variable.type.__name__ == "StreamDecodeError"
    for name, rank in (("pair", 0), ("pair", 1), ("solo", 0)):
        got = workers.result(name, rank)
        assert str(got["corrupt_error"]) == corrupt.type.__name__
        assert str(got["variable_error"]) == variable.type.__name__


def test_step_collectives_do_not_grow_with_frames_per_device(workers):
    """The port's counterpart of tests/test_parallel.py::TestCollectiveAudit:
    the statistics and the placement move O(mesh) bytes a step."""
    for rank in range(2):
        got = workers.result("pair", rank)
        calls, nbytes = got["audit_2"]
        assert calls > 0 and nbytes > 0
        np.testing.assert_array_equal(got["audit_2"], got["audit_8"])
        assert nbytes <= 64 * 2 * 8


def test_device_none_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EncoderConfig.from_level(5, 2, 16, 44100, blocksize=BS)
    pcm = np.zeros((BS * 2, 2), np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_sharding.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_sharding.encode_corpus_sharded(pcm, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_sharding.decode_corpus_sharded(b"fLaC")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_sharding.rank_device()


@pytest.mark.cuda
def test_two_ranks_on_the_card_match_the_cpu(signals, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    np.savez(tmp_path / "inputs.npz", **signals)
    w = _Workers(tmp_path, tmp_path / "inputs.npz", {"card": (2, ["corpus"])}, device="card")
    try:
        corpus, path = signals["corpus"], tmp_path / "one.flac"
        t_encode_file(corpus, 44100, 16, str(path), level=5, blocksize=BS, device="cpu")
        for rank in range(2):
            got = w.result("card", rank)
            assert got["corpus_stream"].tobytes() == path.read_bytes()
            np.testing.assert_array_equal(got["decoded"], corpus)
    finally:
        w.kill()
