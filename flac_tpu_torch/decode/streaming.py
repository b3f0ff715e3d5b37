"""Callback-fed streaming decode with bounded COMPRESSED-side memory — the
port of flac_tpu.decode.streaming.

The reference decoder consumes bytes incrementally through a client read
callback that refills a small word buffer (bitreader.c:138-257; the pull
state machine in stream_decoder.c:1034-1160) and can decode an unbounded
pipe in O(blocksize) memory. `StreamDecoder`'s decoded side is already
bounded (`iter_blocks`), but it holds the whole compressed stream.

This module closes that gap with batches: instead of a bit-serial refill
loop, a REFILLABLE WINDOW of compressed bytes rides through the existing
batched machinery —

  1. `ByteFeed` pulls from a read callback / file object into a fixed-size
     window (the batch analog of the reference's word-buffer refill),
  2. frames inside the window are indexed with the same vectorized sync
     scan + CRC-8 chain validation as the whole-stream index
     (decode/stream.py), restarted per window at a known frame boundary,
  3. indexed frames decode in device batches (on `device`, None: CUDA)
     against the window's word view, zero-padded to the window's size,
     CRC-16-checked, MD5-accumulated, delivered as bounded blocks,
  4. consumed bytes drop out of the window; anything the window index
     can't pin down (final partial frame, pathological frames, variable
     blocksize) decodes sequentially via the host decoder over the
     window — still O(window) memory.

Memory: O(window + batch PCM), independent of stream length on both the
compressed and decoded sides.
"""

from __future__ import annotations

import numpy as np
import torch

from flac_tpu_torch import constants as C
from flac_tpu_torch import crc as crc_mod
from flac_tpu_torch.decode import host_decoder as hd
from flac_tpu_torch.decode.frame_decoder import (DecoderGeometry, _HeaderCfg,
                                                 build_frame_decoder,
                                                 bytes_to_words)
from flac_tpu_torch.decode.stream import StreamDecodeError, check_frame_crc16
from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.encode.frame_encoder import _header_static_codes
from flac_tpu_torch.md5 import MD5Context
from flac_tpu_torch.metadata import StreamInfo, parse_metadata


class ByteFeed:
    """Bounded pull-buffer over a `read(n) -> bytes` callable or file-like.

    The batch analog of the reference's client read callback
    (FLAC__StreamDecoderReadCallback, stream_decoder.h:433-470): `read`
    may return fewer bytes than asked; empty means end of stream.
    """

    def __init__(self, source) -> None:
        if callable(source):
            self._read = source
        elif hasattr(source, "read"):
            self._read = source.read
        else:
            raise TypeError("source must be a read(n) callable or file-like")
        self._buf = bytearray()
        self.base = 0          # absolute stream offset of _buf[0]
        self.eof = False

    def ensure(self, n: int) -> int:
        """Refill until >= n bytes buffered or EOF; returns buffered count."""
        while len(self._buf) < n and not self.eof:
            chunk = self._read(n - len(self._buf))
            if not chunk:
                self.eof = True
                break
            self._buf += chunk
        return len(self._buf)

    def view(self) -> memoryview:
        return memoryview(self._buf)

    def consume(self, k: int) -> None:
        assert 0 <= k <= len(self._buf)
        del self._buf[:k]
        self.base += k

    def read(self, n: int) -> bytes:
        """Pull-and-consume, so a ByteFeed is itself a read(n) source, for
        chaining adapters."""
        self.ensure(n)
        out = bytes(self.view()[:n])
        self.consume(len(out))
        return out

    def __len__(self) -> int:
        return len(self._buf)


def _read_stream_header(feed: ByteFeed) -> tuple[bytes, list]:
    """Incrementally read [ID3v2] + fLaC + all metadata blocks.

    Returns (meta_prefix, metadata): `meta_prefix` is the byte-exact
    fLaC+metadata section (kept resident — it is bounded and re-seeds the
    host fallback decoder), `metadata` the parsed block list. Consumes
    through the end of the metadata section."""
    if feed.ensure(10) < 4:
        raise hd.DecodeError("stream too short for fLaC marker")
    head = bytes(feed.view()[:10])
    if head[:3] == b"ID3":
        size = 0
        for b in head[6:10]:
            size = (size << 7) | (b & 0x7F)
        feed.consume(10 + size - max(10 + size - feed.ensure(10 + size), 0))
        if feed.ensure(4) < 4:
            raise hd.DecodeError("stream ends inside ID3v2 tag")
    if bytes(feed.view()[:4]) != C.STREAM_SYNC_STRING:
        raise hd.DecodeError("missing fLaC stream marker")
    prefix = bytearray(feed.view()[:4])
    feed.consume(4)
    last = False
    while not last:
        if feed.ensure(4) < 4:
            raise hd.DecodeError("truncated metadata block header")
        bh = bytes(feed.view()[:4])
        last = bool(bh[0] & 0x80)
        blen = int.from_bytes(bh[1:4], "big")
        if feed.ensure(4 + blen) < 4 + blen:
            raise hd.DecodeError("truncated metadata block")
        prefix += feed.view()[: 4 + blen]
        feed.consume(4 + blen)
    metadata, audio_off = parse_metadata(bytes(prefix), 4)
    assert audio_off == len(prefix)
    return bytes(prefix), metadata


def _index_window(d: np.ndarray, si: StreamInfo, first_fno: int):
    """Frame index over one WINDOW of a fixed-blocksize stream.

    Same candidate machinery as stream.index_frames (sync+geometry byte
    match, bps/assignment checks, UTF-8 number decode, CRC-8), but chain
    validation is windowed: the window starts AT a frame boundary carrying
    number `first_fno`, and candidates must chain consecutively from it.

    Returns relative byte offsets of the chained frames (>=1 entries,
    offsets[0] == 0), or None when the window prefix doesn't validate
    (caller advances one frame via the host decoder)."""
    n = len(d)
    if n < 6:
        return None
    (bs_code, bs_ext_bits, bs_ext_val, sr_code, sr_ext_bits, sr_ext_val,
     bps_code) = _header_static_codes(_HeaderCfg(si.sample_rate, si.bits_per_sample),
                                      si.min_blocksize)
    cand = np.flatnonzero(
        (d[: n - 5] == 0xFF) & (d[1: n - 4] == 0xF8)
        & (d[2: n - 3] == ((bs_code << 4) | sr_code)))
    if len(cand) == 0 or cand[0] != 0:
        return None
    b3 = d[cand + 3]
    ca = b3 >> 4
    ok = ((b3 & 0x0F) == (bps_code << 1)) \
        & (ca <= (10 if si.channels == 2 else si.channels - 1))
    if si.channels == 2:
        ok &= (ca == 1) | (ca >= 8)
    else:
        ok &= ca == si.channels - 1
    cand = cand[ok]
    if len(cand) == 0 or cand[0] != 0:
        return None
    lead = d[cand + 4].astype(np.int64)
    ulen = (1 + (lead >= 0xC0) + (lead >= 0xE0) + (lead >= 0xF0)
            + (lead >= 0xF8) + (lead >= 0xFC) + (lead >= 0xFE)).astype(np.int64)
    number = np.where(ulen == 1, lead, lead & (0x7F >> np.minimum(ulen, 7)))
    for j in range(1, int(ulen.max())):
        cont = d[np.minimum(cand + 4 + j, n - 1)].astype(np.int64)
        number = np.where(j < ulen, (number << 6) | (cont & 0x3F), number)
    ext_ok = np.ones(len(cand), bool)
    ext_off = cand + 4 + ulen
    for nbits, want in ((bs_ext_bits, bs_ext_val), (sr_ext_bits, sr_ext_val)):
        if nbits:
            val = np.zeros(len(cand), np.int64)
            for j in range(nbits // 8):
                val = (val << 8) | d[np.minimum(ext_off + j, n - 1)]
            ext_ok &= val == want
            ext_off = ext_off + nbits // 8
    cand, ulen, number = cand[ext_ok], ulen[ext_ok], number[ext_ok]
    if len(cand) == 0 or cand[0] != 0:
        return None
    hdr_len = 4 + ulen + (bs_ext_bits + sr_ext_bits) // 8
    maxh = int(hdr_len.max())
    rows = np.zeros((len(cand), maxh), np.uint8)
    for j in range(maxh):
        rows[:, j] = d[np.minimum(cand + j, n - 1)]
    good = crc_mod.crc8_batch(rows, hdr_len) == d[np.minimum(cand + hdr_len, n - 1)]
    cand, number = cand[good], number[good]
    if len(cand) == 0 or cand[0] != 0 or number[0] != first_fno:
        return None
    # greedy consecutive chain from the window start; duplicate numbers for
    # a needed link = ambiguity (false sync that survived CRC-8) -> let the
    # sequential host step resolve that frame bit-exactly
    offsets = [0]
    want = first_fno + 1
    for off, num in zip(cand[1:], number[1:]):
        if num < want or off <= offsets[-1]:
            continue  # stale candidate inside an already-chained frame
        if num > want:
            break     # gap: chain ends here
        dup = np.sum((number == want) & (cand > offsets[-1]))
        if dup > 1:
            break
        offsets.append(int(off))
        want += 1
    return np.asarray(offsets, np.int64)


class ChunkedStreamDecoder:
    """Strict streaming decoder over a read callback: bounded compressed
    window + bounded decoded blocks, the batches decoded on `device` (None:
    CUDA, which raises without a GPU).

    `source`: a `read(n)` callable or binary file-like (e.g. a pipe).
    After construction, `streaminfo`/`metadata` are parsed (the metadata
    section is read eagerly — it is bounded). `iter_blocks()` yields int32
    [n, channels] blocks; the MD5 verdict raises at exhaustion. Strict
    only: corrupt streams raise (concealment/resync semantics live in the
    assembled paths, matching iter_blocks' contract)."""

    def __init__(self, source, check_md5: bool = True, batch_frames: int = 64,
                 max_lpc_order: int = 32, window_bytes: int | None = None,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self.feed = source if isinstance(source, ByteFeed) else ByteFeed(source)
        self.meta_prefix, self.metadata = _read_stream_header(self.feed)
        self.streaminfo = self.metadata[0]
        if not isinstance(self.streaminfo, StreamInfo):
            raise hd.DecodeError("first metadata block is not STREAMINFO")
        si = self.streaminfo
        # window >= several worst-case frames of this stream's geometry
        frame_bound = (si.max_framesize
                       or (si.max_blocksize * si.channels
                           * (si.bits_per_sample + 10)) // 8 + 4096)
        self.window = max(window_bytes or (4 << 20), 8 * frame_bound)
        self.check_md5 = check_md5
        self.batch_frames = batch_frames
        self.max_lpc_order = max_lpc_order
        self.decode_info: dict | None = None

    # -- host fallback over the current window ------------------------------

    def _host_decoder(self) -> hd.HostDecoder:
        """A sequential decoder over meta_prefix + current window; frame
        offsets shift by (len(meta_prefix) - feed.base)."""
        return hd.HostDecoder(self.meta_prefix + bytes(self.feed.view()),
                              check_md5=False)

    def _host_step(self):
        """Decode ONE frame at the window start via the host decoder,
        growing the window if the frame is truncated mid-window. Returns
        (pcm, FrameInfo) or None at a clean end of stream. Does NOT
        consume — the caller advances the feed by fi.size."""
        grow = self.window
        while True:
            avail = self.feed.ensure(grow)
            if avail < 3:
                return None
            host = self._host_decoder()
            try:
                pcm, fi = host.decode_frame_at(len(self.meta_prefix))
                return pcm, fi
            except (EOFError, IndexError):
                if self.feed.eof:
                    return None  # trailing garbage / truncated tail
                grow *= 2  # frame crosses the window end: refill more
            except hd.DecodeError as e:
                if self.feed.eof and avail < 16:
                    return None  # trailing padding bytes
                raise hd.DecodeError(
                    f"at byte {self.feed.base}: {e}") from e

    def resync(self) -> bool:
        """After a corrupt frame: advance the feed to the next plausible
        frame sync (frame_sync_, stream_decoder.c:1941). Returns False at
        end of stream."""
        while True:
            avail = self.feed.ensure(self.window)
            if avail < 2:
                return False
            d = np.frombuffer(bytes(self.feed.view()), np.uint8)
            hits = np.flatnonzero((d[:-1] == 0xFF) & ((d[1:] & 0xFE) == 0xF8))
            hits = hits[hits > 0]
            if len(hits):
                self.feed.consume(int(hits[0]))
                return True
            self.feed.consume(len(d) - 1)
            if self.feed.eof:
                return False

    def next_frame(self):
        """Sequential per-frame pull (the OO `process_single` contract,
        stream_decoder.c:1285): decode + consume ONE frame; returns
        (pcm [T, ch] int32, FrameInfo with ABSOLUTE stream offset) or
        None at end of stream. Independent of iter_blocks — use one or
        the other."""
        step = self._host_step()
        if step is None:
            return None
        pcm, fi = step
        fi.offset = self.feed.base + fi.offset - len(self.meta_prefix)
        self.feed.consume(fi.size)
        return pcm, fi

    # -- the streaming core --------------------------------------------------

    def iter_blocks(self, check_crc: bool = True):
        si = self.streaminfo
        fixed_bs = si.min_blocksize == si.max_blocksize
        md5 = (MD5Context() if self.check_md5 and si.md5sum != b"\x00" * 16
               else None)
        total_cap = si.total_samples or None
        emitted = 0
        frames = 0

        def clip(block: np.ndarray) -> np.ndarray:
            nonlocal emitted
            block = block.reshape(-1, si.channels)
            if total_cap is not None and emitted + len(block) > total_cap:
                block = block[: max(total_cap - emitted, 0)]
            emitted += len(block)
            if md5 is not None and len(block):
                md5.accumulate(block, si.bits_per_sample)
            return block

        dec = geom = None
        if fixed_bs:
            geom = DecoderGeometry(blocksize=si.min_blocksize,
                                   channels=si.channels,
                                   bits_per_sample=si.bits_per_sample,
                                   sample_rate=si.sample_rate,
                                   max_lpc_order=self.max_lpc_order)
            dec = build_frame_decoder(geom, self.device)
        next_fno = 0
        B = self.batch_frames

        while True:
            avail = self.feed.ensure(self.window)
            if avail < 3:
                break
            # snapshot: a live view of the bytearray would pin it against
            # the consume() resize at the end of the round
            d = np.frombuffer(bytes(self.feed.view()), np.uint8)
            offsets = _index_window(d, si, next_fno) if fixed_bs else None
            # the LAST indexed frame's end is unbounded unless EOF closed
            # the window — hold it back for the next round
            n_ready = (len(offsets) if offsets is not None and self.feed.eof
                       else len(offsets) - 1 if offsets is not None else 0)
            if n_ready <= 0:
                step = self._host_step()
                if step is None:
                    break
                pcm, fi = step
                frames += 1
                next_fno += 1
                self.feed.consume(fi.size)
                block = clip(pcm)
                if len(block):
                    yield block
                continue
            # device-decode the ready frames in batches against the window,
            # its words zero-padded to the window's size as flac_tpu's are
            # (so that reads past the data stop at the same limit)
            wbuf = d
            if len(wbuf) < self.window:
                wbuf = np.concatenate(
                    [wbuf, np.zeros(self.window - len(wbuf), np.uint8)])
            words = torch.as_tensor(bytes_to_words(wbuf), device=self.device)
            host = None
            consumed = 0
            ready = offsets[:n_ready]
            for s in range(0, n_ready, B):
                batch_off = ready[s: s + B]
                nb = len(batch_off)
                if nb < B:
                    batch_off = np.concatenate(
                        [batch_off, np.repeat(batch_off[-1:], B - nb)])
                pcm, ends, meta = dec(words, batch_off * 8)
                pcm = pcm.cpu().numpy()[:nb].astype(np.int32)
                ends_np = ends.cpu().numpy()[:nb] // 8
                ovf = meta["unary_overflow"].cpu().numpy()[:nb]
                if ovf.any():
                    if host is None:
                        host = self._host_decoder()
                    shift = len(self.meta_prefix)
                    for i in np.flatnonzero(ovf):
                        try:
                            fpcm, fi = host.decode_frame_at(
                                int(batch_off[i]) + shift)
                        except (hd.DecodeError, EOFError, ValueError,
                                KeyError) as e:
                            raise hd.DecodeError(
                                f"at byte {self.feed.base + int(batch_off[i])}:"
                                f" {e}") from e
                        pcm[i] = fpcm.reshape(pcm[i].shape)
                        ends_np[i] = fi.offset + fi.size - shift
                # frame k must end at or before frame k+1's start
                ks = s + np.arange(nb)
                lim = np.where(ks < len(offsets) - 1,
                               offsets[np.minimum(ks + 1, len(offsets) - 1)],
                               avail)
                if np.any(ends_np > lim):
                    raise StreamDecodeError(
                        "frame length overrun — corrupt stream?")
                if check_crc:
                    bad = check_frame_crc16(bytes(), d, offsets[s: s + nb],
                                            ends_np)
                    if len(bad):
                        raise hd.DecodeError(
                            "frame CRC-16 mismatch in frame(s) "
                            f"{(next_fno + s + bad)[:5].tolist()}")
                frames += nb
                consumed = int(ends_np[-1])
                block = clip(pcm)
                if len(block):
                    yield block
            next_fno += n_ready
            self.feed.consume(consumed)
        if md5 is not None:
            if md5.digest() != si.md5sum:
                raise hd.DecodeError("MD5 signature mismatch")
        self.decode_info = dict(
            frames=frames, samples=emitted,
            path="chunked-device" if fixed_bs else "chunked-host")

    def decode_all(self):
        parts = list(self.iter_blocks())
        pcm = (np.concatenate(parts, axis=0) if parts
               else np.zeros((0, self.streaminfo.channels), np.int32))
        return pcm, dict(self.decode_info or {})


def decode_chunked(source, **kw):
    """One-call chunked decode: (pcm, streaminfo, info)."""
    dec = ChunkedStreamDecoder(source, **kw)
    pcm, info = dec.decode_all()
    return pcm, dec.streaminfo, info
