"""The port's encoder end to end against flac_tpu's, on the CPU.

`build_frame_encoder` at level 5 stereo 16-bit on __graft_entry__'s tiny
geometry (B=4, T=1024) must give flac_tpu's words, bit counts and choices;
`encode_file` must write the
same bytes as flac_tpu's on the test signals, the final partial block
included, and pass its own verify; the port's output must decode losslessly
through the port's host decoder and through flac_tpu's (CRC-8, CRC-16 and
MD5 checked).
"""

from __future__ import annotations

import numpy as np
import pytest

from __graft_entry__ import _tiny_pcm
from conftest import make_signal
from flac_tpu.decode import host_decoder as j_hd
from flac_tpu.encode import encoder as j_enc
from flac_tpu.encode import frame_encoder as j_fe
from flac_tpu_torch.decode import host_decoder as t_hd
from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.encode import frame_encoder as t_fe

N_SAMPLES = 3 * 4096 + 777  # three full frames and a partial one


def test_frame_encoder_matches_entry_geometry():
    B, T = 4, 1024
    jc = j_fe.EncoderConfig.from_level(5, 2, 16, 44100, blocksize=T)
    tc = t_fe.EncoderConfig.from_level(5, 2, 16, 44100, blocksize=T)
    pcm, fnos = _tiny_pcm(B, T), np.arange(B, dtype=np.int64)
    jw, jt, jinfo = j_fe.build_frame_encoder(jc, packer_impl="xla")(pcm, fnos)
    tw, tt, tinfo = t_fe.build_frame_encoder(tc, device="cpu")(pcm, fnos)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)


def _both(tmp_path, sig, name, **kw):
    jp, tp = tmp_path / f"{name}_jax.flac", tmp_path / f"{name}_torch.flac"
    j_enc.encode_file(sig, 44100, 16, str(jp), **kw)
    stats = t_enc.encode_file(sig, 44100, 16, str(tp), device="cpu", **kw)
    return jp.read_bytes(), tp.read_bytes(), stats


def _stereo_signal(kind):
    if kind == "identical":  # left == right: the side channel is all zeros
        return np.repeat(make_signal(N_SAMPLES, 2, 16, kind="sine")[:, :1], 2, axis=1)
    return make_signal(N_SAMPLES, 2, 16, kind=kind)


@pytest.mark.parametrize("kind", ["sine", "quiet", "noise", "constant", "wasted",
                                  "identical"])
def test_encode_file_byte_identical_and_lossless(tmp_path, kind):
    sig = _stereo_signal(kind)
    ref, got, stats = _both(tmp_path, sig, kind, level=5, batch_frames=4)
    assert stats.frames == 4 and stats.batches == 2
    assert got == ref
    pcm, si, _ = t_hd.decode_bytes(got)
    assert si.md5sum != b"\x00" * 16
    np.testing.assert_array_equal(pcm, sig)
    pcm_j, _, _ = j_hd.decode_bytes(got)
    np.testing.assert_array_equal(pcm_j, sig)


@pytest.mark.parametrize("level,channels,n,kind", [
    (1, 2, 2 * 1152 + 100, "quiet"),   # loose mid-side, no LPC
    (3, 1, 2 * 4096 + 5, "sine"),      # mono, LPC order 6
])
def test_other_levels_byte_identical(tmp_path, level, channels, n, kind):
    sig = make_signal(n, channels, 16, kind=kind, seed=3)
    ref, got, _ = _both(tmp_path, sig, f"l{level}", level=level, batch_frames=4)
    assert got == ref
    np.testing.assert_array_equal(t_hd.decode_bytes(got)[0], sig)


def test_encode_file_verify_passes_and_packers_agree(tmp_path):
    """verify=True decodes every batch of full frames with the port's frame
    decoder and compares it with the input; the bytes are flac_tpu's."""
    sig = make_signal(2 * 1024 + 333, 2, 16, kind="quiet", seed=8)
    kw = dict(level=5, blocksize=1024, batch_frames=2, verify=True)
    j_enc.encode_file(sig, 44100, 16, str(tmp_path / "j.flac"), **kw)
    stats = t_enc.encode_file(sig, 44100, 16, str(tmp_path / "t.flac"),
                              device="cpu", **kw)
    assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    assert stats.batches == 2


def test_verify_raises_on_a_mismatch(tmp_path, monkeypatch):
    """A decoded sample that differs from the input raises VerifyError with
    flac_tpu's message, before the batch is written."""
    sig = make_signal(2 * 1024 + 5, 2, 16, kind="sine", seed=2)
    make = t_enc.make_verifier

    def corrupting(cfg, device):
        verify = make(cfg, device)

        def bad(rows):
            pcm, flagged = verify(rows)
            pcm = pcm.clone()
            pcm[1, 7, 1] += 1
            return pcm, flagged
        return bad

    monkeypatch.setattr(t_enc, "make_verifier", corrupting)
    with pytest.raises(t_enc.VerifyError,
                       match=r"verify mismatch at frame 1 sample 7 channel 1"):
        t_enc.encode_file(sig, 44100, 16, str(tmp_path / "v.flac"), level=5,
                          blocksize=1024, batch_frames=2, verify=True, device="cpu")


@pytest.mark.parametrize("what,kw", [
    ("exhaustive", dict(level=8)),
    ("precision search", dict(level=5, do_qlp_coeff_prec_search=True)),
    ("escape", dict(level=5, do_escape_coding=True)),
    ("wide", dict(level=5, bits_per_sample=24)),
])
def test_unported_paths_raise(tmp_path, what, kw):
    """The four paths that raised NotImplementedError before they were
    ported (the exhaustive search, -p, escape coding, the wide datapath)
    now encode, verify and decode losslessly through the port alone; their
    streams are held against flac_tpu's in test_torch_hires.py,
    test_torch_escape.py and test_torch_wide*.py."""
    bps = kw.pop("bits_per_sample", 16)
    sig = make_signal(5000, 2, bps, kind="quiet", seed=len(what))
    t_enc.encode_file(sig, 44100, bps, str(tmp_path / "x.flac"), blocksize=1024,
                      batch_frames=4, verify=True, device="cpu", **kw)
    pcm, si, _ = t_hd.decode_bytes((tmp_path / "x.flac").read_bytes())
    assert si.md5sum != b"\x00" * 16
    np.testing.assert_array_equal(pcm, sig)
