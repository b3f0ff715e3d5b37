"""The port's wide residual scan against flac_tpu's, on the CPU.

`build_frame_decoder(device="cpu")` with the wide scan (flac_tpu's
`_decode_subframe` wide branch: four 64-bit limbs, U=4, 3 refills a step)
must give flac_tpu's pcm, end bits and every meta array, `unary_overflow`
frame by frame: on a level-5 16-bit stream and a level-8 24-bit stream read
with scan_impl="wide", on a 32-bit stream (which takes the wide scan on its
own), and on test_torch_decoder.py's corrupt frames (wasted-bit runs longer
than the sample width, negative bit positions). Then flac_tpu's rule for
choosing the scan.

The CUDA kernel splits the scan into phase A (one lane walks each sample's
first bit), phase B (the lanes extract the values) and a replay of flac_tpu's
window bookkeeping that flags what the window would flag; other frames take
its exact path, flac_tpu's window scan step for step. `_model_wide_scan`
below is a plain model of that decomposition, held against flac_tpu's wide
branch through the decoder on the streams, the corrupt frames, the guard
strings and random frame starts. The wide CUDA kernel is held against the
plain version on the card (`-m cuda`, and chip_smoke.py).
"""

from __future__ import annotations

import dataclasses
import functools
import tempfile
from pathlib import Path

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
from test_torch_decoder import (corrupt_frames, fold_guard_bit_strings, GUARD_SUBFRAME_HEADER,
                                _bit_string_words, _put_bits)
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


def _flac_tpu_decode(words, starts, **geom):
    """flac_tpu's decoder over the starts in batches of 4 (the shape its
    other calls here compile)."""
    dec = j_fd.build_frame_decoder(j_fd.DecoderGeometry(**geom))
    parts = [dec(jnp.asarray(words), jnp.asarray(starts[i:i + 4]))
             for i in range(0, len(starts), 4)]
    return (np.concatenate([np.asarray(p[0]) for p in parts]),
            np.concatenate([np.asarray(p[1]) for p in parts]),
            {k: np.concatenate([np.asarray(p[2][k]) for p in parts]) for k in parts[0][2]})


def _port_decode(words, starts, **geom):
    tg = t_fd.DecoderGeometry.from_dict(dataclasses.asdict(j_fd.DecoderGeometry(**geom)))
    tp, te, tm = t_fd.build_frame_decoder(tg, device="cpu")(words, starts)
    return tp.numpy(), te.numpy(), {k: v.numpy() for k, v in tm.items()}


STREAM_CASES = {"16": (16, 5, "wide"), "24": (24, 8, "wide"), "32": (32, 5, "auto")}


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(words, starts, geometry, flac_tpu's (pcm, end, meta)) of a named
    case, computed once a process: the streams (by bits), "corrupt" and the
    cases built below."""
    if name in STREAM_CASES:
        bps, level, scan = STREAM_CASES[name]
        with tempfile.TemporaryDirectory() as d:
            words, starts = _stream(Path(d), _tonal(bps, seed=bps).reshape(-1, 2), bps, level)
        geom = dict(bits_per_sample=bps, scan_impl=scan, **GEOM)
    elif name == "corrupt":
        words, starts = corrupt_frames()
        geom = dict(bits_per_sample=16, scan_impl="wide", **GEOM)
    else:
        words, starts, geom = _BUILT[name]()
    return words, starts, geom, _flac_tpu_decode(words, starts, **geom)


def _decode_both(name):
    """The port's plain decode of a case, held against flac_tpu's on every
    output; returns the port's (pcm, meta)."""
    words, starts, geom, (jp, je, jm) = _case(name)
    tp, te, tm = _port_decode(words, starts, **geom)
    assert set(tm) == set(jm)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(te, je)
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    return tp, tm


# ---------------------------------------------------------------------------
# a plain model of the wide kernel's decomposition
# ---------------------------------------------------------------------------

MAX_FAST_T = 1 << 16     # blocks above it take the kernel's exact path
FAST, FLAGGED, EXACT = 0, 1, 2


def _peek64_reader(words: np.ndarray):
    """peek64(p): the 64 stream bits at bit p >= 0, MSB first, each word
    read as flac_tpu reads it (words[min(i, n - 1)])."""
    u = words.view(np.uint32).tolist()
    n = len(u)

    def peek64(p):
        wi, r = p >> 5, p & 31
        v = (u[min(wi, n - 1)] << 64) | (u[min(wi + 1, n - 1)] << 32) | u[min(wi + 2, n - 1)]
        return (v >> (32 - r)) & 0xFFFFFFFFFFFFFFFF
    return peek64


def _walk(peek64, pos, T, is_coded, is_verb, ebps, order, plen, pesc, ps):
    """Phase A of one frame, with the flag replay: (entries, end, flagged).
    entries[t] is (kind, value bit, width, unary run) for each sample that
    reads a value: kind "rice" (its k LSBs at the value bit) or "raw" (an
    escaped or verbatim sample). The replay follows flac_tpu's window: each
    step of 4 samples flags when it spends more bits than `navail`, then
    refills up to 3 words; a Rice run of >= 48 zeros flags too."""
    r, navail = pos, 256 - (pos & 31)
    tmod = k = rawlen = 0
    ps = ps or 1        # t mod 0 is 0, as flac_tpu's jnp.mod gives it
    entries = [None] * T
    for s0 in range(0, T, 4):
        r_step, flagged = r, False
        for t in range(s0, min(s0 + 4, T)):
            if is_coded:
                if tmod == 0:
                    k = peek64(r) >> (64 - plen)
                    r += plen
                    if k == pesc:
                        rawlen = peek64(r) >> 59
                        r += 5
                tmod = 0 if tmod + 1 == ps else tmod + 1
                if t >= order:
                    if k == pesc:
                        entries[t] = ("raw", r, rawlen, 0)
                        r += rawlen
                    else:
                        z = 64 - peek64(r).bit_length()
                        flagged |= z >= 48
                        entries[t] = ("rice", r + z + 1, k, z)
                        r += z + 1 + k
            elif is_verb:
                entries[t] = ("raw", r, ebps, 0)
                r += ebps
        spent = r - r_step
        if flagged or spent > navail:
            return entries, r, True
        navail = max(navail - spent, 0)
        for _ in range(3):
            navail += 32 if navail <= 256 - 32 else 0
    return entries, r, False


def _extract(peek64, entries, T):
    """Phase B of one frame: each sample's value from its entry alone."""
    res = np.zeros(T, np.int64)
    for t, e in enumerate(entries):
        if e is None:
            continue
        kind, p, n, z = e
        bits = peek64(p) >> (64 - n) if n > 0 else 0
        if kind == "raw":
            res[t] = bits - (1 << n) if n > 0 and bits >> (n - 1) else bits
        else:
            folded = (z << n) | bits
            res[t] = (folded >> 1) ^ -(folded & 1)
    return res


def _model_wide_scan(words, pos, T, is_coded, is_verb, ebps, order, plen, pesc, ps):
    """The kernel's routing, phase A, the flag replay and phase B, frame by
    frame, with wide_residual_scan's arguments. Returns (res [B, T] int64,
    end [B] int64, route [B]): FAST frames' res and end are the kernel's;
    FLAGGED ones the kernel sends to its exact path and flac_tpu flags; EXACT
    ones go there for their shape (a negative position, a VERBATIM width
    outside [1, 33], T > 65536), and the model says nothing about them."""
    peek64 = _peek64_reader(np.asarray(words))
    cols = [x.tolist() for x in (pos, is_coded, is_verb, ebps, order, plen, pesc, ps)]
    B = len(cols[0])
    res = np.zeros((B, T), np.int64)
    end = np.array(cols[0], np.int64)
    route = np.full(B, EXACT)
    for b, (p, coded, verb, eb, od, pl, pe, pz) in enumerate(zip(*cols)):
        if p < 0 or T > MAX_FAST_T or (verb and not 1 <= eb <= 33):
            continue
        entries, stop, flagged = _walk(peek64, p, T, coded, verb, eb, od, pl, pe, pz)
        route[b] = FLAGGED if flagged else FAST
        if not flagged:
            res[b], end[b] = _extract(peek64, entries, T), stop
    return res, end, route


def _frame_status(routes):
    """Each frame's status from its channels' routes, in channel order: the
    first channel that is not FAST decides (a later channel starts where
    that one ended, which only the exact path knows)."""
    status = np.full(len(routes[0]), FAST)
    for route in routes:
        status = np.where(status == FAST, route, status)
    return status


def _header_bits(words, at):
    """The 48 frame-header bits at bit `at` (a one-byte frame number and no
    extension fields at T=1024 / 44.1 kHz)."""
    u = words.view(np.uint32)
    return "".join(format(int(u[(at + i) >> 5]) >> (31 - ((at + i) & 31)) & 1, "b")
                   for i in range(48))


def _rice_guard(name):
    """FIXED order-0 channel-0 subframes in RICE2 partitions of 8 samples:
    partition 0 holds k=26 and test_torch_decoder's guard codeword first
    (a run of 47 zeros, 15, or 60); the 127 others k=0 and eight 1s."""
    run = {"fold_trips": "0" * 47 + "1" + format(0x155AA55 & ((1 << 26) - 1), "026b"),
           "fold_exact": "0" * 15 + "1" + format(123, "026b"),
           "unary_60": "0" * 60 + "1"}[name]
    return ("00010000" + "01" + "0111" + format(26, "05b") + run
            + ("1" + "0" * 26) * 7 + ("00000" + "1" * 8) * 127)


def _verbatim(bits, seed, wasted=0):
    """A VERBATIM subframe of T random samples of `bits` bits, after a
    wasted-bits run of `wasted` bits when it is not 0."""
    rng = np.random.default_rng(seed)
    hdr = "00000011" + "0" * (wasted - 1) + "1" if wasted else "00000010"
    return hdr + "".join(format(int(v), f"0{bits}b")
                         for v in rng.integers(0, 1 << bits, T, dtype=np.uint64))


def _frames_of(name, subframes, every):
    """4 frames, frame i at word every * i: the first header of the named
    stream case, then subframes[i] as channel 0; channel 1 reads the zeros
    after it (a CONSTANT subframe)."""
    words, starts, geom, _ = _case(name)
    header = _header_bits(words, int(starts[0]))
    out = np.zeros_like(words)
    at = np.arange(4, dtype=np.int64) * every * 32
    for a, sub in zip(at, subframes):
        _put_bits(out, int(a), header + sub)
    return out, at, geom


def _random_frames(n=64, seed=5):
    """n frame starts at random bit positions of random words with zero
    runs (chip_smoke.py's random_subframes' generator): a one-byte frame
    number at each, and a quarter of the channel-0 subframes with the
    wasted-bits flag and a zero run of up to 600 bits (negative widths and
    positions)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    for s in rng.integers(0, 4096 - 40, 20):
        u[s:s + rng.integers(1, 41)] = 0
    words = u.view(np.int32)
    starts = rng.integers(0, 3000 * 32, n)
    for i, s in enumerate(starts):
        _put_bits(words, int(s) + 32, "00000000")
        if i % 4 == 0:
            hdr = format(((1 if i % 3 == 0 else int(rng.integers(0, 64))) << 1) | 1, "08b")
            _put_bits(words, int(s) + 48, hdr + "0" * int(rng.integers(0, 601)) + "1")
    return words, starts.astype(np.int64), dict(bits_per_sample=16, scan_impl="wide", **GEOM)


_BUILT = {
    # fold strings (the wide scan has no fold guard), a 60-zero run, and a
    # VERBATIM frame whose 64 bits a step the refill keeps up with
    "guards16": lambda: _frames_of("16", [_rice_guard("fold_trips"), _rice_guard("fold_exact"),
                                          _rice_guard("unary_60"), _verbatim(16, 1)], 1024),
    # VERBATIM 32-bit samples that outrun the 96-bit refill, a fold string,
    # VERBATIM samples behind 12 wasted bits, a 60-zero run
    "guards32": lambda: _frames_of("32", [_verbatim(32, 2), _rice_guard("fold_exact"),
                                          _verbatim(20, 3, wasted=12), _rice_guard("unary_60")],
                                   1100),
    "random": _random_frames,
}

@pytest.mark.parametrize("bps,level,scan", [(16, 5, "wide"), (24, 8, "wide"),
                                            (32, 5, "auto")])
def test_wide_scan_decoder_matches_flac_tpu(bps, level, scan):
    """Frame 1 is noise, so VERBATIM: at 32 bits its 128 bits a step outrun
    the scan's 96-bit refill, and the scan flags it (flac_tpu's too); every
    other frame decodes to the input. Then the model of the CUDA kernel
    (`_hold_model`) on the stream, and at 16 bits on the guard frames and
    64 random frame starts, at 32 bits on the 32-bit guard frames."""
    assert STREAM_CASES[str(bps)] == (bps, level, scan)
    sig = _tonal(bps, seed=bps).reshape(-1, 2)
    pcm, meta = _decode_both(str(bps))
    flagged = meta["unary_overflow"]
    assert list(flagged) == [False, bps == 32, False, False]
    np.testing.assert_array_equal(pcm[~flagged], sig.reshape(4, T, 2)[~flagged])
    # the kernel's decomposition (the model) on this stream, and on the
    # cases built in the same geometry (flac_tpu's decoder compiled once)
    assert list(_hold_model(str(bps))) == [FAST, FLAGGED if bps == 32 else FAST, FAST, FAST]
    if bps == 16:
        assert list(_hold_model("guards16")) == [FAST, FAST, FLAGGED, FAST]
        status = _hold_model("random")
        assert {FAST, FLAGGED, EXACT} <= set(status) and (status == FAST).sum() >= 8
    if bps == 32:
        assert list(_hold_model("guards32")) == [FLAGGED, FAST, FAST, FLAGGED]


def test_corrupt_frames_match_flac_tpu_with_the_wide_scan():
    """test_torch_decoder.py's corrupt frames (flac_tpu's narrow scan holds
    them there) through the wide scan, then through the model of the CUDA
    kernel."""
    _, meta = _decode_both("corrupt")
    assert (meta["wasted"] > 17).any() and meta["unary_overflow"].any()
    # the model: the two wasted-run subframes go to the kernel's exact path
    status = _hold_model("corrupt")
    assert list(status[[0, 3]]) == [EXACT, EXACT] and (status == FAST).any()


def test_scan_rule_matches_flac_tpu(monkeypatch):
    """Above 26 bits the wide scan; then scan_impl; else the narrow one:
    flac_tpu's rule with FLAC_TPU_SCAN unset. The port does not read that
    variable, which flac_tpu obeys after scan_impl."""
    cases = [(dict(bits_per_sample=27), None), (dict(bits_per_sample=26), None),
             (dict(bits_per_sample=16, scan_impl="wide"), "narrow"),
             (dict(bits_per_sample=16, scan_impl="narrow"), "wide"),
             (dict(bits_per_sample=16), "wide"), (dict(bits_per_sample=16), "narrow"),
             (dict(bits_per_sample=32, scan_impl="narrow"), None)]
    for geom, env in cases:
        monkeypatch.delenv("FLAC_TPU_SCAN", raising=False)
        jg = j_fd.DecoderGeometry(**geom, **GEOM)
        tg = t_fd.DecoderGeometry(**geom, **GEOM)
        want = j_fd._use_narrow_scan(jg)
        if env:
            monkeypatch.setenv("FLAC_TPU_SCAN", env)
        assert t_fd._use_narrow_scan(tg) == want, (geom, env)


def _hold_model(name):
    """The port's decoder with the model in place of the plain wide scan,
    on a case: a frame the model flags is flagged by flac_tpu, and a frame
    it decodes on the fast path is unflagged with flac_tpu's pcm and end
    position. Returns each frame's status."""
    words, starts, geom, (jp, je, jm) = _case(name)
    routes = []

    def scan(*args):
        res, end, route = _model_wide_scan(*args)
        routes.append(route)
        return torch.as_tensor(res), torch.as_tensor(end), torch.as_tensor(route != FAST)
    saved = t_fd.wide_residual_scan
    t_fd.wide_residual_scan = scan
    try:
        tp, te, _ = _port_decode(words, starts, **geom)
    finally:
        t_fd.wide_residual_scan = saved
    assert len(routes) == 2
    status = _frame_status(routes)
    flagged = jm["unary_overflow"]
    fast = status == FAST
    assert flagged[status == FLAGGED].all(), name
    assert not flagged[fast].any(), name
    np.testing.assert_array_equal(tp[fast], jp[fast], err_msg=name)
    np.testing.assert_array_equal(te[fast], je[fast], err_msg=name)
    return status


def test_wide_scan_model_walk_matches_a_bit_serial_read():
    """Phase A's positions against a reader that takes one field after
    another off the stream (the reference decoder's order): the guard
    string fold_exact, whose parameter, run and LSBs are known."""
    words = _bit_string_words(_rice_guard("fold_exact"))
    peek64 = _peek64_reader(words)
    p0 = len("00010000" + "01" + "0111")      # the subframe and coding headers
    entries, end, flagged = _walk(peek64, p0, T, True, False, 16, 0, 5, 31, 8)
    assert not flagged
    first = p0 + 5 + 16                       # k, then 15 zeros and the stop bit
    assert entries[0] == ("rice", first, 26, 15)
    assert entries[1] == ("rice", first + 26 + 1, 26, 0)
    assert entries[8] == ("rice", first + 26 + 7 * 27 + 5 + 1, 0, 0)
    assert end == len(_rice_guard("fold_exact"))
    res = _extract(peek64, entries, T)
    assert res[0] == ((15 << 26) | 123) >> 1 ^ -(((15 << 26) | 123) & 1)
    assert not res[1:].any()



@pytest.mark.parametrize("pos,verb,ebps,T_", [(-3, False, 16, 8), (0, True, 0, 8),
                                               (0, True, 34, 8), (0, False, 16, MAX_FAST_T + 4)])
def test_wide_scan_model_routes_odd_shapes_to_the_exact_path(pos, verb, ebps, T_):
    """A negative position, a VERBATIM width outside [1, 33] and a block
    longer than 65536 samples take the kernel's exact path without a walk;
    a well-shaped subframe of the same words takes the fast path."""
    words = _bit_string_words("1" * 64)
    one = lambda v: torch.tensor([v])  # noqa: E731
    args = (one(True), one(verb), one(ebps), one(0), one(4), one(15), one(T_))
    _, end, route = _model_wide_scan(words, one(pos), T_, *args[:1], *args[1:])
    assert list(route) == [EXACT] and list(end) == [pos]
    _, _, route = _model_wide_scan(words, one(0), 8, one(not verb), one(verb), one(16),
                                   one(0), one(4), one(15), one(8))
    assert list(route) == [FAST]

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
    guards = fold_guard_bit_strings(prefix=GUARD_SUBFRAME_HEADER)
    for name, w in guards.items():
        w = torch.as_tensor(w, device="cuda")
        args = (w, torch.zeros(1, dtype=torch.int64, device="cuda"),
                torch.full((1,), 16, dtype=torch.int64, device="cuda"), 8, 12, True)
        got, ref = t_fd.subframe_scan_kernel(*args), t_fd.subframe_scan(*args)
        for k in ref[0]:
            assert torch.equal(got[0][k], ref[0][k]), (name, k)
        for g, r in zip(got[1:], ref[1:]):
            assert torch.equal(g, r), name
    # one launch mixing both paths: the 32-bit stream's channel-0 subframes
    # interleaved with the guard strings, then the corrupt frames' subframes
    parts, subframes = [], []   # words laid end to end; (pos, cbps) by case
    for (words, starts), bps in zip(cases, (32, 16)):
        geom = t_fd.DecoderGeometry(bits_per_sample=bps, **GEOM)
        p, assignment, _ = t_fd.read_frame_header(
            torch.as_tensor(words), torch.as_tensor(starts), geom.header_ext_bits, 2)
        base = 32 * sum(len(w) for w in parts)
        subframes.append(list(zip((p + base).tolist(),
                                  t_fd.side_channel_bps(assignment, 0, bps, 2).tolist())))
        parts.append(words)
    guard_subframes = []
    for w in guards.values():
        guard_subframes.append((32 * sum(len(x) for x in parts), 16))
        parts.append(w)
    stream, corrupt = subframes
    pos, cbps = zip(*[x for pair in zip(stream, guard_subframes) for x in pair],
                    *stream[len(guard_subframes):], *corrupt)
    mixed = [torch.as_tensor(np.concatenate(parts), device="cuda"),
             torch.as_tensor(pos, device="cuda"), torch.as_tensor(cbps, device="cuda")]
    residual_scan.exact_path_frames()
    got = t_fd.subframe_scan_kernel(*mixed, T, 12, True)
    exact = residual_scan.exact_path_frames()
    ref = t_fd.subframe_scan(*mixed, T, 12, True)
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), ("mixed", k)
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == r.dtype and torch.equal(g, r), "mixed"
    assert int(ref[3].sum()) <= exact < len(pos) and exact > 0
