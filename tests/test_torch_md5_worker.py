"""The stream encoder's MD5 worker, on the CPU: the STREAMINFO MD5 and the
whole stream are those of the synchronous hash and of flac_tpu's
encode_file, whatever the process() sizes, at 16, 24 and 8 bits; no
update is pending when process() returns; an update's exception surfaces
from the call that waited for it; no chunk handed to the worker, and no
input the caller wrote after process(), changes the stream; without MD5
no worker is made. On the card (`-m cuda`), a 24-bit -8 stream is the
CPU's bytes:

    python -m pytest tests/test_torch_md5_worker.py -m cuda -q -n 0
"""

from __future__ import annotations

import io
import time

import numpy as np
import pytest
import torch

from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.encode.encoder import StreamEncoder
from flac_tpu_torch.encode.frame_encoder import EncoderConfig
from flac_tpu_torch.md5 import MD5Context, md5_of_pcm

torch.set_num_threads(1)

BS, B = 256, 4
STEP = BS * B
N = 3 * STEP + 2 * BS + 100
# single samples, pieces below one batch, pieces above one step
UNEVEN = [1, 1, 7, 300, 1, STEP + 5, 3 * STEP, 2, 700]
LEVEL = 2  # flac_tpu's build at -2 (no LPC) compiles in a few seconds
MD5_FIELD = slice(26, 42)  # "fLaC", the block header, STREAMINFO's last 16 bytes


def _signal(n: int, channels: int, bps: int) -> np.ndarray:
    rng = np.random.default_rng(bps * 10 + channels)
    t = np.arange(n)[:, None]
    amp = (1 << (bps - 1)) - 1
    x = 0.5 * amp * np.sin(2 * np.pi * (331 + 97 * np.arange(channels)) * t / 44100)
    return np.clip(x + rng.normal(0, amp / 200, x.shape), -amp - 1, amp).astype(np.int32)


def _cfg(channels: int, bps: int, level: int = 5, blocksize: int = BS) -> EncoderConfig:
    return EncoderConfig.from_level(level, channels, bps, 44100, blocksize=blocksize)


def _pieces(n: int, sizes: list[int] | None) -> list[tuple[int, int]]:
    """[start, end) of each process() call: `sizes` in turn, then the rest."""
    out, s = [], 0
    for k in sizes or []:
        if s >= n:
            break
        out.append((s, min(s + k, n)))
        s = out[-1][1]
    return out + ([(s, n)] if s < n else [])


def _stream(cfg: EncoderConfig, pcm: np.ndarray, sizes=None, device="cpu", **kw) -> bytes:
    sink = io.BytesIO()
    enc = StreamEncoder(cfg, sink, batch_frames=B, total_samples_estimate=len(pcm),
                        device=device, **kw)
    for s, e in _pieces(len(pcm), sizes):
        enc.process(pcm[s:e])
    enc.finish()
    return sink.getvalue()


def _sync_hash(self, samples):
    """The hash on the calling thread, as before the worker."""
    self._md5.accumulate(samples, self.cfg.bits_per_sample)


@pytest.mark.parametrize("channels,bps,sizes", [
    (2, 16, UNEVEN),
    (2, 24, None),
    (1, 8, UNEVEN[::-1]),
], ids=["16-bit-stereo-uneven", "24-bit-stereo", "8-bit-mono"])
def test_stream_and_md5_are_the_synchronous_hash_and_flac_tpus(tmp_path, monkeypatch,
                                                               channels, bps, sizes):
    from flac_tpu.encode import encoder as j_enc

    pcm, cfg = _signal(N, channels, bps), _cfg(channels, bps, LEVEL)
    updates = t_enc.md5_updates
    got = _stream(cfg, pcm, sizes)
    assert t_enc.md5_updates > updates
    assert got[MD5_FIELD] == md5_of_pcm(pcm, bps)
    with monkeypatch.context() as m:
        m.setattr(StreamEncoder, "_hash", _sync_hash)
        assert _stream(cfg, pcm, sizes) == got
    path = tmp_path / "j.flac"
    j_enc.encode_file(pcm, 44100, bps, str(path), level=LEVEL, blocksize=BS, batch_frames=B)
    assert path.read_bytes() == got


def test_without_md5_no_worker_is_made(monkeypatch):
    pcm, cfg = _signal(N, 2, 16), _cfg(2, 16)
    taken = []
    monkeypatch.setattr(t_enc, "_md5_worker", lambda pid: taken.append(pid) or pytest.fail(
        "the MD5 worker was taken"))
    updates = t_enc.md5_updates
    got = _stream(cfg, pcm, UNEVEN, do_md5=False)
    assert taken == [] and t_enc.md5_updates == updates
    assert got[MD5_FIELD] == b"\x00" * 16
    monkeypatch.undo()
    want = _stream(cfg, pcm, UNEVEN)
    assert got[:MD5_FIELD.start] + got[MD5_FIELD.stop:] == (
        want[:MD5_FIELD.start] + want[MD5_FIELD.stop:])


@pytest.mark.parametrize("n", [N, 3 * STEP + 3 * BS], ids=["tail", "no-tail"])
def test_one_update_a_chunk_and_one_for_the_tail(monkeypatch, n):
    chunks = []
    real = StreamEncoder._encode_full_frames

    def counted(self, chunk):
        chunks.append(len(chunk))
        real(self, chunk)
    monkeypatch.setattr(StreamEncoder, "_encode_full_frames", counted)
    updates = t_enc.md5_updates
    _stream(_cfg(2, 16), _signal(n, 2, 16), UNEVEN)
    assert sum(chunks) == n // BS * BS
    assert t_enc.md5_updates - updates == len(chunks) + (n % BS > 0)


def test_no_update_is_pending_when_process_returns(monkeypatch):
    handed, done = [], []
    real_hash, real_acc = StreamEncoder._hash, MD5Context.accumulate

    def hand(self, samples):
        handed.append(len(samples))
        real_hash(self, samples)

    def slow(self, samples, bps):
        time.sleep(0.02)  # the worker lags the main thread
        real_acc(self, samples, bps)
        done.append(len(samples))
    monkeypatch.setattr(StreamEncoder, "_hash", hand)
    monkeypatch.setattr(MD5Context, "accumulate", slow)
    pcm, cfg = _signal(N, 2, 16), _cfg(2, 16)
    wait_ns = t_enc.md5_wait_ns
    sink = io.BytesIO()
    enc = StreamEncoder(cfg, sink, batch_frames=B, device="cpu")
    for s, e in _pieces(N, UNEVEN):
        enc.process(pcm[s:e])
        assert done == handed
    si = enc.finish()
    assert done == handed and len(handed) > 3
    assert si.md5sum == md5_of_pcm(pcm, 16)
    assert t_enc.md5_wait_ns > wait_ns


class Boom(Exception):
    pass


def _boom(self, samples, bps):
    raise Boom("in the worker")


@pytest.mark.parametrize("where", ["process", "finish"])
def test_an_update_exception_surfaces_where_it_was_waited_for(monkeypatch, where):
    pcm, cfg = _signal(N, 2, 16), _cfg(2, 16)
    enc = StreamEncoder(cfg, io.BytesIO(), batch_frames=B, device="cpu")
    monkeypatch.setattr(MD5Context, "accumulate", _boom)
    if where == "process":
        with pytest.raises(Boom, match="in the worker"):
            enc.process(pcm)
    else:
        enc.process(pcm[: BS - 1])  # nothing to hand over yet
        with pytest.raises(Boom, match="in the worker"):
            enc.finish()


@pytest.mark.parametrize("verify", [False, True], ids=["encode", "verify"])
def test_no_chunk_handed_over_is_written_afterwards(monkeypatch, verify):
    seen = []
    real = MD5Context.accumulate

    def keep(self, samples, bps):
        seen.append((samples, samples.copy()))
        real(self, samples, bps)
    monkeypatch.setattr(MD5Context, "accumulate", keep)
    pcm, cfg = _signal(N, 2, 16), _cfg(2, 16)
    _stream(cfg, pcm, UNEVEN, verify=verify)
    assert len(seen) > 3
    for samples, at_update in seen:
        np.testing.assert_array_equal(samples, at_update)
    np.testing.assert_array_equal(np.concatenate([s for s, _ in seen]), pcm)


def test_input_written_after_process_changes_nothing():
    pcm, cfg = _signal(N, 2, 16), _cfg(2, 16)
    want = _stream(cfg, pcm, UNEVEN)
    x = pcm.copy()
    sink = io.BytesIO()
    enc = StreamEncoder(cfg, sink, batch_frames=B, total_samples_estimate=N, device="cpu")
    for s, e in _pieces(N, UNEVEN):
        enc.process(x[s:e])
        x[s:e] = -x[s:e] + 5
    enc.finish()
    assert sink.getvalue() == want


@pytest.mark.cuda
def test_a_24_bit_level_8_stream_on_the_card_is_the_cpus():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the dense route and CUDA graphs run only there")
    cfg = EncoderConfig.from_level(8, 2, 24, 96000)
    pcm = _signal(3 * B * cfg.blocksize + 777, 2, 24)
    updates = t_enc.md5_updates
    got = _stream(cfg, pcm, [5000, 1, 3 * B * cfg.blocksize], device="cuda")
    assert t_enc.md5_updates > updates
    assert got[MD5_FIELD] == md5_of_pcm(pcm, 24)
    assert got == _stream(cfg, pcm, device="cpu")
