"""The port's wide residual scan against flac_tpu's, on the CPU.

`build_frame_decoder(device="cpu")` with the wide scan (flac_tpu's
`_decode_subframe` wide branch: four 64-bit limbs, U=4, 3 refills a step)
must give flac_tpu's pcm, end bits and every meta array, `unary_overflow`
frame by frame: on a level-5 16-bit stream and a level-8 24-bit stream read
with scan_impl="wide", on a 32-bit stream (which takes the wide scan on its
own), and on test_torch_decoder.py's corrupt frames (wasted-bit runs longer
than the sample width, negative bit positions). Then flac_tpu's rule for
choosing the scan. The wide CUDA kernel is held against the plain version
on the card (`-m cuda`, and chip_smoke.py).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flac_tpu.decode import frame_decoder as j_fd
from flac_tpu_torch.decode import frame_decoder as t_fd
from flac_tpu_torch.decode.stream import index_frames
from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.kernels import residual_scan, restore_scan
from flac_tpu_torch.kernels.residual_scan import SUBFRAME_FIELDS
from flac_tpu_torch.metadata import parse_metadata
from test_torch_decoder import corrupt_frames, fold_guard_bit_strings, GUARD_SUBFRAME_HEADER
from test_torch_wide import _tonal

T = 1024
GEOM = dict(blocksize=T, channels=2, sample_rate=44100, max_lpc_order=12)


def _stream(tmp_path, sig, bps, level):
    """A stream of the port's encoder (flac_tpu's bytes, test_torch_encoder
    and test_torch_hires show) and its words and frame starts."""
    path = tmp_path / f"s{bps}.flac"
    t_enc.encode_file(sig, 44100, bps, str(path), level=level, blocksize=T,
                      batch_frames=4, device="cpu")
    data = path.read_bytes()
    d = np.frombuffer(data, np.uint8)
    blocks, ao = parse_metadata(data)
    return t_fd.bytes_to_words(d, bucket=True), index_frames(d, ao, blocks[0]) * 8


def _decode_both(words, starts, **geom):
    jg = j_fd.DecoderGeometry(**geom)
    jp, je, jm = j_fd.build_frame_decoder(jg)(jnp.asarray(words), jnp.asarray(starts))
    tg = t_fd.DecoderGeometry.from_dict(dataclasses.asdict(jg))
    tp, te, tm = t_fd.build_frame_decoder(tg, device="cpu")(words, starts)
    assert set(tm) == set(jm)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    return tp.numpy(), {k: v.numpy() for k, v in tm.items()}


@pytest.mark.parametrize("bps,level,scan", [(16, 5, "wide"), (24, 8, "wide"),
                                            (32, 5, "auto")])
def test_wide_scan_decoder_matches_flac_tpu(tmp_path, bps, level, scan):
    """Frame 1 is noise, so VERBATIM: at 32 bits its 128 bits a step outrun
    the scan's 96-bit refill, and the scan flags it (flac_tpu's too); every
    other frame decodes to the input."""
    sig = _tonal(bps, seed=bps).reshape(-1, 2)
    words, starts = _stream(tmp_path, sig, bps, level)
    pcm, meta = _decode_both(words, starts, bits_per_sample=bps, scan_impl=scan, **GEOM)
    flagged = meta["unary_overflow"]
    assert list(flagged) == [False, bps == 32, False, False]
    np.testing.assert_array_equal(pcm[~flagged], sig.reshape(4, T, 2)[~flagged])


def test_corrupt_frames_match_flac_tpu_with_the_wide_scan():
    """test_torch_decoder.py's corrupt frames (flac_tpu's narrow scan holds
    them there) through the wide scan."""
    words, starts = corrupt_frames()
    _, meta = _decode_both(words, starts, bits_per_sample=16, scan_impl="wide", **GEOM)
    assert (meta["wasted"] > 17).any() and meta["unary_overflow"].any()


def test_scan_rule_matches_flac_tpu(monkeypatch):
    """Above 26 bits the wide scan; then scan_impl; then FLAC_TPU_SCAN;
    else the narrow one."""
    cases = [(dict(bits_per_sample=27), None), (dict(bits_per_sample=26), None),
             (dict(bits_per_sample=16, scan_impl="wide"), "narrow"),
             (dict(bits_per_sample=16, scan_impl="narrow"), "wide"),
             (dict(bits_per_sample=16), "wide"), (dict(bits_per_sample=16), "narrow"),
             (dict(bits_per_sample=32, scan_impl="narrow"), None)]
    for geom, env in cases:
        if env:
            monkeypatch.setenv("FLAC_TPU_SCAN", env)
        else:
            monkeypatch.delenv("FLAC_TPU_SCAN", raising=False)
        jg = j_fd.DecoderGeometry(**geom, **GEOM)
        tg = t_fd.DecoderGeometry(**geom, **GEOM)
        assert t_fd._use_narrow_scan(tg) == j_fd._use_narrow_scan(jg), (geom, env)


@pytest.mark.cuda
def test_cuda_wide_scan_matches_plain_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cases = [_stream(tmp_path, _tonal(32, seed=32).reshape(-1, 2), 32, 5), corrupt_frames()]
    for (words, starts), bps in zip(cases, (32, 16)):
        geom = t_fd.DecoderGeometry(bits_per_sample=bps, **GEOM)
        words = torch.as_tensor(words, device="cuda")
        pos, assignment, _ = t_fd.read_frame_header(
            words, torch.as_tensor(starts, device="cuda"), geom.header_ext_bits, 2)
        rows = []
        for c in range(2):
            cbps = t_fd.side_channel_bps(assignment, c, bps, 2)
            before = residual_scan.wide_launches
            sub, res, end, ovf = t_fd.subframe_scan_kernel(words, pos, cbps, T, 12, True)
            assert residual_scan.wide_launches == before + 1
            ref = t_fd.subframe_scan(words, pos, cbps, T, 12, True)
            for name, _ in SUBFRAME_FIELDS:
                assert torch.equal(sub[name], ref[0][name]), name
            for g, r in zip((res, end, ovf), ref[1:]):
                assert g.dtype == r.dtype and torch.equal(g, r)
            rows.append((res, *t_fd.restore_inputs(sub, 12)))
            pos = end
        stacked = [torch.cat(p) for p in zip(*rows)]
        before = restore_scan.launches
        x = t_fd.restore_scan_kernel(*stacked, T, 12)
        assert restore_scan.launches == before + 1
        assert torch.equal(x, t_fd.restore_scan(*stacked, T, 12))
    for name, w in fold_guard_bit_strings(prefix=GUARD_SUBFRAME_HEADER).items():
        w = torch.as_tensor(w, device="cuda")
        args = (w, torch.zeros(1, dtype=torch.int64, device="cuda"),
                torch.full((1,), 16, dtype=torch.int64, device="cuda"), 8, 12, True)
        got, ref = t_fd.subframe_scan_kernel(*args), t_fd.subframe_scan(*args)
        for k in ref[0]:
            assert torch.equal(got[0][k], ref[0][k]), (name, k)
        for g, r in zip(got[1:], ref[1:]):
            assert torch.equal(g, r), name
