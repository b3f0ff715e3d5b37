"""The check's control and faults, at sizes a test run holds: a whole run
on the CPU (the harness's look for a card skipped) with the program fed
one bit less than the configuration states, or broken underneath the
timed path, must come out not correct. The same control runs on the card
at each cell's own size (`--control lsb`)."""

from __future__ import annotations

import pytest

from cardbench import harness
from flac_tpu_torch.decode import stream as stream_mod
from flac_tpu_torch.encode.encoder import StreamEncoder


def _run(root, cell, seed=2 ** 31 + 7, **kw):
    return harness.run(root, harness.load_cell(root, cell), seed, 0.5, False, "cpu", **kw)


@pytest.mark.parametrize("cell", ["tiny_album_encode", "tiny_album_decode",
                                  "tiny_clips_encode"])
def test_the_control_one_bit_below_is_not_correct(tiny_root, cell):
    r = _run(tiny_root, cell, control="lsb")
    assert not r["correct"]
    assert r["checks"]["samples_wrong"]["value"] > 0


def test_the_control_of_the_hires_cell_is_not_correct(tiny_root):
    r = _run(tiny_root, "tiny_hires_encode", control="lsb")
    assert not r["correct"]
    assert r["checks"]["samples_wrong"]["value"] > 0
    assert r["checks"]["streaminfo_wrong"]["value"] > 0  # the MD5 of other PCM


def _stale_step(monkeypatch):
    """Every frame-encoder call returns the first call's output."""
    init, first = StreamEncoder.__init__, []

    def patched(self, *a, **k):
        init(self, *a, **k)
        step = self._encode

        def stale(*args):
            out = step(*args)
            first.append(out) if not first else None
            return first[0]
        self._encode = stale
    monkeypatch.setattr(StreamEncoder, "__init__", patched)


def _half_batch(monkeypatch):
    """Each batch writes only the first half of its frames."""
    emit = StreamEncoder._emit
    monkeypatch.setattr(StreamEncoder, "_emit",
                        lambda self, w, t, n: emit(self, w, t, max(n // 2, 1)))


def _altered_answer(monkeypatch):
    """One bit in the middle of each batch's first frame flips where it is
    produced."""
    emit = StreamEncoder._emit

    def flipped(self, words, total_bits, n):
        words = words.copy()
        words[0, int(total_bits[0]) // 64] ^= 1 << 9
        emit(self, words, total_bits, n)
    monkeypatch.setattr(StreamEncoder, "_emit", flipped)


@pytest.mark.parametrize("fault", [_stale_step, _half_batch, _altered_answer])
def test_an_encode_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(tiny_root, "tiny_album_encode")
    assert not r["correct"], r["checks"]


def _decode_fault(kind):
    real = stream_mod.decode_bytes_device
    first = []

    def fake(data, **kw):
        pcm, si, info = real(data, **kw)
        if kind == "stale":
            first.append(pcm) if not first else None
            return first[0], si, info
        if kind == "half":
            return pcm[: len(pcm) // 2], si, info
        pcm = pcm.copy()
        pcm[len(pcm) // 2, 1] += 1
        return pcm, si, info
    return fake


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_a_decode_fault_is_not_correct(tiny_root, monkeypatch, kind):
    monkeypatch.setattr(stream_mod, "decode_bytes_device", _decode_fault(kind))
    r = _run(tiny_root, "tiny_album_decode", seed=11)
    assert not r["correct"], r["checks"]


def test_sound_runs_read_zero_on_several_seeds(tiny_root):
    for seed in (1, 2 ** 31 + 3, 2 ** 40 + 9):
        r = _run(tiny_root, "tiny_album_encode", seed=seed)
        assert r["correct"]
        assert all(c["value"] == 0 for k, c in r["checks"].items() if k != "files_checked")
        assert r["checks"]["files_checked"]["value"] >= 1
