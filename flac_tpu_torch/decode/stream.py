"""Stream-level decoding: vectorized frame indexing + batched device decode —
the port of flac_tpu.decode.stream.

The reference discovers frame boundaries bit-serially (frame_sync_,
stream_decoder.c:1941); frame lengths are not recorded in the format, so a
parallel decoder indexes the frames first:

1. a numpy sync scan over the whole byte stream for positions matching the
   14-bit sync + reserved bit + geometry codes from STREAMINFO,
2. vectorized header validation: CRC-8 over the variable-length header,
3. chain validation by the UTF-8-coded frame numbers: frame k's header
   carries k, so candidates assemble into an index without a sequential
   parse; an ambiguous index goes to the sequential host decoder,
4. equal-geometry frames decode in device batches (decode.frame_decoder);
   the final partial frame and the frames the scan flags go through the host
   decoder. Those host frames are flac_tpu's semantics, and are counted in
   `decode_info` (`host_frames`, `overflow_frames`).

Variable-blocksize streams (blocking strategy 1, from foreign encoders) are
indexed by their sample numbers (`index_frames_variable`) and decode in
groups of one blocksize, each frame's header width given to the decoder;
small groups go to the host decoder (path "device-variable").

MD5 of the assembled PCM is the end-to-end verdict (stream_decoder.h:797).
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from flac_tpu_torch import constants as C
from flac_tpu_torch import crc as crc_mod
from flac_tpu_torch.decode import host_decoder as hd
from flac_tpu_torch.decode.frame_decoder import (
    DecoderGeometry, _HeaderCfg, build_frame_decoder, bytes_to_words)
from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.encode.frame_encoder import _header_static_codes
from flac_tpu_torch.md5 import MD5Context
from flac_tpu_torch.metadata import StreamInfo, parse_metadata

try:  # the native host runtime is optional (see _native/__init__.py)
    from flac_tpu_torch import _native
    _HAVE_NATIVE = _native.available
except Exception:  # pragma: no cover
    _native = None
    _HAVE_NATIVE = False


class StreamDecodeError(Exception):
    pass


def index_frames(data: np.ndarray, audio_offset: int, si: StreamInfo) -> np.ndarray | None:
    """Byte offsets of all frames with the stream's standard geometry,
    sorted by frame number, or None if the index is ambiguous (the caller
    decodes sequentially instead). The final partial frame (if any) is NOT
    included: its blocksize code differs."""
    d = data
    n = len(d)
    if n < audio_offset + 2:
        return np.zeros(0, np.int64)
    (bs_code, bs_ext_bits, bs_ext_val, sr_code, sr_ext_bits, sr_ext_val,
     bps_code) = _header_static_codes(_HeaderCfg(si.sample_rate, si.bits_per_sample),
                                      si.min_blocksize)
    b2 = (bs_code << 4) | sr_code
    cand = np.flatnonzero(
        (d[audio_offset:n - 5] == 0xFF)
        & (d[audio_offset + 1:n - 4] == 0xF8)   # sync + fixed blocksize strategy
        & (d[audio_offset + 2:n - 3] == b2)
    ) + audio_offset
    if len(cand) == 0:
        return np.zeros(0, np.int64)
    # byte 3: ca(4) | bps(3) | pad(1): validate bps code + reserved pad bit
    b3 = d[cand + 3]
    ca = b3 >> 4
    ok = ((b3 & 0x0F) == (bps_code << 1)) & (ca <= (10 if si.channels == 2 else si.channels - 1))
    if si.channels == 2:
        ok &= (ca == 1) | (ca >= 8)
    else:
        ok &= ca == si.channels - 1
    cand = cand[ok]
    if len(cand) == 0:
        return np.zeros(0, np.int64)
    # UTF-8 frame number: length from the lead byte, then the continuations
    lead = d[cand + 4].astype(np.int64)
    ulen = (1 + (lead >= 0xC0) + (lead >= 0xE0) + (lead >= 0xF0)
            + (lead >= 0xF8) + (lead >= 0xFC) + (lead >= 0xFE)).astype(np.int64)
    number = np.where(ulen == 1, lead, lead & (0x7F >> np.minimum(ulen, 7)))
    for j in range(1, int(ulen.max())):
        cont = d[np.minimum(cand + 4 + j, n - 1)].astype(np.int64)
        number = np.where(j < ulen, (number << 6) | (cont & 0x3F), number)
    # the stored extension VALUES must match too: the final partial frame
    # shares code 6/7 with the standard frames (stream_decoder.c:2197-2225)
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
    if len(cand) == 0:
        return np.zeros(0, np.int64)
    hdr_len = 4 + ulen + (bs_ext_bits + sr_ext_bits) // 8  # bytes before CRC-8
    maxh = int(hdr_len.max())
    rows = np.zeros((len(cand), maxh), np.uint8)
    for j in range(maxh):
        rows[:, j] = d[np.minimum(cand + j, n - 1)]
    good = crc_mod.crc8_batch(rows, hdr_len) == d[np.minimum(cand + hdr_len, n - 1)]
    cand, number = cand[good], number[good]
    if len(cand) == 0:
        return np.zeros(0, np.int64)
    # chain validation: frame numbers must be a permutation 0..N-1, unique
    order = np.argsort(number, kind="stable")
    number, cand = number[order], cand[order]
    nframes = int(number[-1]) + 1
    if len(number) != nframes or not np.array_equal(number, np.arange(nframes)):
        return None  # duplicates or gaps: ambiguous, sequential fallback
    if np.any(np.diff(cand) <= 0):
        return None
    return cand.astype(np.int64)


def index_frames_variable(data: np.ndarray, audio_offset: int, si: StreamInfo):
    """Frame index of a variable-blocksize (blocking_strategy=1) stream.

    Each frame carries its own blocksize code and a UTF-8-coded SAMPLE
    number (stream_decoder.c:2197-2240), so the geometry is parsed per
    candidate. The chain check: sample numbers start at 0 and each frame's
    is the previous frame's plus its parsed blocksize.

    Returns (offsets, blocksizes, sample_numbers, hdr_ext_bits) sorted by
    sample number (hdr_ext_bits: each header's bits between the UTF-8
    number and the CRC-8, for DecoderGeometry(dynamic_header_ext)), or None
    when the index is ambiguous or a frame uses a sample-rate code other
    than the canonical one (the caller decodes on the host instead).
    """
    d = data
    n = len(d)
    if n < audio_offset + 2:
        return None
    (_bs, _bse, _bsv, sr_code, sr_ext_bits, sr_ext_val,
     bps_code) = _header_static_codes(_HeaderCfg(si.sample_rate, si.bits_per_sample),
                                      max(si.max_blocksize, 16))
    cand = np.flatnonzero(
        (d[audio_offset:n - 5] == 0xFF)
        & (d[audio_offset + 1:n - 4] == 0xF9)       # sync + variable strategy
        & ((d[audio_offset + 2:n - 3] & 0x0F) == sr_code)
        & ((d[audio_offset + 2:n - 3] >> 4) >= 1)   # blocksize code 0 reserved
    ) + audio_offset
    if len(cand) == 0:
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
    if len(cand) == 0:
        return None
    # UTF-8 sample number (up to 36 bits: up to 7 bytes)
    lead = d[cand + 4].astype(np.int64)
    ulen = (1 + (lead >= 0xC0) + (lead >= 0xE0) + (lead >= 0xF0)
            + (lead >= 0xF8) + (lead >= 0xFC) + (lead >= 0xFE)).astype(np.int64)
    number = np.where(ulen == 1, lead, lead & (0x7F >> np.minimum(ulen, 7)))
    for j in range(1, int(ulen.max())):
        cont = d[np.minimum(cand + 4 + j, n - 1)].astype(np.int64)
        number = np.where(j < ulen, (number << 6) | (cont & 0x3F), number)
    # each candidate's blocksize from its code (+ 8/16-bit end-of-header value)
    bs_code = (d[cand + 2] >> 4).astype(np.int64)
    bs_ext_bits = np.where(bs_code == 6, 8, np.where(bs_code == 7, 16, 0))
    ext_off = cand + 4 + ulen
    ext_val = d[np.minimum(ext_off, n - 1)].astype(np.int64)
    ext_val = np.where(bs_code == 7,
                       (ext_val << 8) | d[np.minimum(ext_off + 1, n - 1)],
                       ext_val)
    blocksize = np.select(
        [bs_code == 1, (bs_code >= 2) & (bs_code <= 5), (bs_code >= 6) & (bs_code <= 7)],
        [np.int64(192), np.int64(576) << np.maximum(bs_code - 2, 0), ext_val + 1],
        default=np.int64(256) << np.maximum(bs_code - 8, 0))
    # the static sample-rate extension (if the canonical code has one)
    ok = np.ones(len(cand), bool)
    sr_off = ext_off + bs_ext_bits // 8
    if sr_ext_bits:
        val = np.zeros(len(cand), np.int64)
        for j in range(sr_ext_bits // 8):
            val = (val << 8) | d[np.minimum(sr_off + j, n - 1)]
        ok &= val == sr_ext_val
    hdr_len = 4 + ulen + bs_ext_bits // 8 + sr_ext_bits // 8
    cand, number, blocksize, bs_ext_bits, hdr_len = \
        cand[ok], number[ok], blocksize[ok], bs_ext_bits[ok], hdr_len[ok]
    if len(cand) == 0:
        return None
    maxh = int(hdr_len.max())
    rows = np.zeros((len(cand), maxh), np.uint8)
    for j in range(maxh):
        rows[:, j] = d[np.minimum(cand + j, n - 1)]
    good = crc_mod.crc8_batch(rows, hdr_len) == d[np.minimum(cand + hdr_len, n - 1)]
    cand, number, blocksize, bs_ext_bits = \
        cand[good], number[good], blocksize[good], bs_ext_bits[good]
    if len(cand) == 0:
        return None
    order = np.argsort(number, kind="stable")
    cand, number, blocksize, bs_ext_bits = \
        cand[order], number[order], blocksize[order], bs_ext_bits[order]
    # chain validation: contiguous sample coverage from 0, increasing offsets
    if number[0] != 0 or np.any(np.diff(cand) <= 0):
        return None
    if np.any(number[1:] != number[:-1] + blocksize[:-1]):
        return None
    if si.total_samples and int(number[-1] + blocksize[-1]) != si.total_samples:
        return None
    return (cand.astype(np.int64), blocksize.astype(np.int64),
            number.astype(np.int64), (bs_ext_bits + sr_ext_bits).astype(np.int64))


def check_frame_crc16(data_bytes: bytes, d: np.ndarray, offsets: np.ndarray,
                      ends: np.ndarray) -> np.ndarray:
    """CRC-16 validation of every frame (stream_decoder.c:2061). Returns the
    indices of mismatching frames."""
    lengths = ends - offsets
    stored = (d[np.minimum(offsets + lengths - 2, len(d) - 1)].astype(np.uint16) << 8) \
        | d[np.minimum(offsets + lengths - 1, len(d) - 1)]
    if _HAVE_NATIVE:  # one native call over the stream buffer
        crcs = _native.crc16_many(d, offsets, np.maximum(lengths - 2, 0))
    else:
        maxlen = int(lengths.max())
        idx = np.minimum(offsets[:, None] + np.arange(maxlen)[None, :], len(d) - 1)
        crcs = crc_mod.crc16_batch(d[idx], lengths - 2)
    return np.flatnonzero(crcs != stored)


class StreamDecoder:
    """Whole-stream decoder using the device (None: CUDA, which raises
    without a GPU) for the bulk of the frames."""

    def __init__(self, data: bytes, check_md5: bool = True, batch_frames: int = 64,
                 max_lpc_order: int = 32, continue_on_error: bool = False,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.data_bytes = bytes(data)
        self.continue_on_error = continue_on_error
        self.errors: list[str] = []
        self.d = np.frombuffer(self.data_bytes, np.uint8)
        pos = hd.skip_id3v2(self.data_bytes, 0)
        if self.data_bytes[pos:pos + 4] != C.STREAM_SYNC_STRING:
            raise hd.DecodeError("missing fLaC stream marker")
        self.metadata, self.audio_offset = parse_metadata(self.data_bytes, pos + 4)
        self.streaminfo = self.metadata[0]
        if not isinstance(self.streaminfo, StreamInfo):
            raise hd.DecodeError("first metadata block is not STREAMINFO")
        self.check_md5 = check_md5
        self.batch_frames = batch_frames
        self.max_lpc_order = max_lpc_order

    def _host_fallback(self, path: str) -> tuple[np.ndarray, dict]:
        host = hd.HostDecoder(self.data_bytes, check_md5=self.check_md5,
                              continue_on_error=self.continue_on_error)
        pcm, frames = host.decode_all()
        self.errors.extend(host.errors)
        return pcm, dict(frames=len(frames), path=path, host_frames=len(frames),
                         overflow_frames=0)

    def _device_setup(self):
        """(words on the device, frame offsets or None, batch decoder, B)."""
        si = self.streaminfo
        words = torch.as_tensor(bytes_to_words(self.d, bucket=True), device=self.device)
        offsets = index_frames(self.d, self.audio_offset, si)
        geom = DecoderGeometry(blocksize=si.min_blocksize, channels=si.channels,
                               bits_per_sample=si.bits_per_sample,
                               sample_rate=si.sample_rate,
                               max_lpc_order=self.max_lpc_order)
        dec = build_frame_decoder(geom, self.device)
        # one big batch for long streams, small ones for short streams
        B = 512 if offsets is not None and len(offsets) >= 256 else self.batch_frames
        return words, offsets, dec, B

    def _decode_batch(self, dec, words, batch_off: np.ndarray, B: int):
        """Decode the frames at `batch_off` (padded to B): (pcm [nb, T, Ch]
        int32, end bytes [nb], overflow flags [nb]) on the host."""
        nb = len(batch_off)
        if nb < B:
            batch_off = np.concatenate([batch_off, np.repeat(batch_off[-1:], B - nb)])
        pcm, ends, meta = dec(words, batch_off * 8)
        return (pcm.cpu().numpy()[:nb].astype(np.int32, copy=False),
                ends.cpu().numpy()[:nb] // 8,
                meta["unary_overflow"].cpu().numpy()[:nb])

    def iter_blocks(self, check_crc: bool = True, lookahead: int = 3):
        """Stream the decoded PCM as bounded-size int32 [n, channels] blocks.

        The strict-mode streaming core: at most `lookahead` device batches
        are decoded ahead of the consumer. It performs exactly the checks of
        strict decode_all (frame-length overrun, CRC-16, host reroute of the
        frames the scan flags, the final partial frame, total_samples
        clipping, incremental MD5 with the verdict raised at exhaustion, as
        the reference's decoder delivers all blocks before it,
        stream_decoder.h:797). Yielded blocks are read-shared with the MD5
        worker thread: treat them as immutable.

        A stream the device path cannot index goes to the host decoder, and
        a variable-blocksize stream to its grouped decode; both yield one
        block. After exhaustion `self.decode_info` carries the
        decode_all info dict. Not valid with continue_on_error: concealment
        rewrites delivered history and stays on the assembled paths.
        """
        if self.continue_on_error:
            raise ValueError("iter_blocks is the strict path; -F decoding "
                             "owns resync/concealment and assembles")
        si = self.streaminfo
        if si.min_blocksize != si.max_blocksize:
            pcm, info = self._decode_variable(check_crc)
            self.decode_info = info
            if len(pcm):
                yield pcm
            return
        words, offsets, dec, B = self._device_setup()
        if offsets is None:
            pcm, info = self._host_fallback("host-ambiguous")
            self.decode_info = info
            if len(pcm):
                yield pcm
            return
        nfr = len(offsets)
        md5 = (MD5Context() if self.check_md5 and si.md5sum != b"\x00" * 16
               else None)
        # MD5 runs on one worker thread, in submission order: the native
        # update releases the GIL, so hashing overlaps the next batch
        md5_pool = ThreadPoolExecutor(max_workers=1) if md5 is not None else None
        md5_fut = None
        total_cap = si.total_samples or None
        emitted = 0
        host = None
        frames = nfr
        host_frames = overflow_frames = 0
        last_end = self.audio_offset

        def clip(block: np.ndarray) -> np.ndarray:
            nonlocal emitted, md5_fut
            if total_cap is not None and emitted + len(block) > total_cap:
                block = block[: max(total_cap - emitted, 0)]
            emitted += len(block)
            if md5 is not None and len(block):
                md5_fut = md5_pool.submit(md5.accumulate, block, si.bits_per_sample)
            return block

        try:
            pending = collections.deque()

            def submit(s: int) -> None:
                batch_off = offsets[s:s + B]
                pending.append((s, batch_off,
                                self._decode_batch(dec, words, batch_off, B)))

            starts = list(range(0, nfr, B))
            for s in starts[:lookahead]:
                submit(s)
            next_i = min(lookahead, len(starts))
            while pending:
                s, batch_off, (pcm, ends_np, ovf) = pending.popleft()
                nb = len(batch_off)
                if next_i < len(starts):
                    submit(starts[next_i])
                    next_i += 1
                if ovf.any():
                    # unary runs beyond the decoder's bit window (legal but
                    # pathological streams): those frames decode on the host
                    if host is None:
                        host = hd.HostDecoder(self.data_bytes, check_md5=False)
                    for i in np.flatnonzero(ovf):
                        try:
                            fpcm, fi = host.decode_frame_at(int(batch_off[i]))
                        except (hd.DecodeError, EOFError, ValueError, KeyError) as e:
                            raise hd.DecodeError(
                                f"at byte {int(batch_off[i])}: {e}") from e
                        pcm[i] = fpcm.reshape(pcm[i].shape)
                        ends_np[i] = fi.offset + fi.size
                        host_frames += 1
                        overflow_frames += 1
                # frame k must end at or before frame k+1's start
                ks = np.arange(s, s + nb)
                lim = np.where(ks < nfr - 1, offsets[np.minimum(ks + 1, nfr - 1)],
                               len(self.d))
                if np.any(ends_np > lim):
                    raise StreamDecodeError("frame length overrun — corrupt stream?")
                if check_crc:
                    bad = self._check_crc16(offsets[s:s + nb], ends_np)
                    if len(bad):
                        raise hd.DecodeError(
                            "frame CRC-16 mismatch in frame(s) "
                            f"{(s + bad)[:5].tolist()}")
                last_end = int(ends_np[-1])
                block = clip(pcm.reshape(-1, si.channels))
                if len(block):
                    yield block
            # the final partial frame (not in the index) decodes on the host
            if last_end < len(self.d) - 2:
                host = hd.HostDecoder(self.data_bytes, check_md5=False)
                try:
                    tail_pcm, _fi = host.decode_frame_at(last_end)
                except hd.CrcMismatchError as e:
                    raise hd.DecodeError(f"at byte {last_end}: {e}") from e
                except (hd.DecodeError, EOFError):
                    tail_pcm = None  # trailing garbage/padding
                if tail_pcm is not None:
                    frames += 1
                    host_frames += 1
                    block = clip(tail_pcm)
                    if len(block):
                        yield block
            if md5 is not None:
                if md5_fut is not None:
                    md5_fut.result()  # barrier: all ordered updates done
                md5_pool.shutdown()
                if md5.digest() != si.md5sum:
                    raise hd.DecodeError("MD5 signature mismatch")
            self.decode_info = dict(frames=frames, path="device", errors=self.errors,
                                    host_frames=host_frames,
                                    overflow_frames=overflow_frames)
        finally:
            if md5_pool is not None:
                md5_pool.shutdown(wait=False)  # frees the worker when the
                # consumer abandons the generator mid-stream

    def decode_all(self, check_crc: bool = True) -> tuple[np.ndarray, dict]:
        si = self.streaminfo
        if si.min_blocksize != si.max_blocksize:
            return self._decode_variable(check_crc)
        if not self.continue_on_error:
            # strict mode: assemble from the streaming core (the same checks)
            parts = list(self.iter_blocks(check_crc))
            pcm = (np.concatenate(parts, axis=0) if parts
                   else np.zeros((0, si.channels), np.int32))
            return pcm, dict(self.decode_info)
        words, offsets, dec, B = self._device_setup()
        if offsets is None:
            return self._host_fallback("host-ambiguous")
        nfr = len(offsets)
        pcm_parts = []
        ends_all = np.zeros(nfr, np.int64)
        host = None
        host_frames = overflow_frames = 0
        for s in range(0, nfr, B):
            batch_off = offsets[s:s + B]
            pcm, ends_np, ovf = self._decode_batch(dec, words, batch_off, B)
            if ovf.any():
                if host is None:
                    host = hd.HostDecoder(self.data_bytes, check_md5=False)
                for i in np.flatnonzero(ovf):
                    overflow_frames += 1
                    try:
                        fpcm, fi = host.decode_frame_at(int(batch_off[i]))
                        pcm[i] = fpcm.reshape(pcm[i].shape)
                        ends_np[i] = fi.offset + fi.size
                        host_frames += 1
                    except (hd.DecodeError, EOFError, ValueError, KeyError) as e:
                        # conceal: zero the block, trust the index for length
                        self.errors.append(f"at byte {int(batch_off[i])}: {e}")
                        pcm[i] = 0
                        k = s + i
                        ends_np[i] = offsets[k + 1] if k + 1 < nfr else len(self.d)
            ends_all[s:s + len(batch_off)] = ends_np
            pcm_parts.append(pcm.reshape(-1, si.channels))
        pcm = (np.concatenate(pcm_parts, axis=0) if pcm_parts
               else np.zeros((0, si.channels), np.int32))
        if nfr:
            if np.any(ends_all[:-1] > offsets[1:]) or ends_all[-1] > len(self.d):
                # index unreliable: redo the whole stream sequentially with
                # the reference's concealment
                self.errors.append("frame length overrun — sequential redecode")
                return self._host_fallback("host-overrun")
            if check_crc:
                # conceal like the reference (stream_decoder.c:2106-2113):
                # zero the affected blocks, keep decoding
                for k in self._check_crc16(offsets, ends_all):
                    self.errors.append(
                        f"at byte {int(offsets[k])}: frame CRC-16 mismatch")
                    pcm[k * si.min_blocksize:(k + 1) * si.min_blocksize] = 0
        # the final partial frame (not in the index) decodes on the host
        tail_start = int(ends_all[-1]) if nfr else self.audio_offset
        frames = nfr
        if tail_start < len(self.d) - 2:
            host = hd.HostDecoder(self.data_bytes, check_md5=False)
            try:
                tail_pcm, _fi = host.decode_frame_at(tail_start)
                pcm = np.concatenate([pcm, tail_pcm], axis=0)
                frames += 1
                host_frames += 1
            except hd.CrcMismatchError as e:
                if e.frame.channels == si.channels:
                    self.errors.append(f"at byte {tail_start}: {e}")
                    pcm = np.concatenate(
                        [pcm, np.zeros((e.frame.blocksize, si.channels), np.int32)],
                        axis=0)
                    frames += 1
                    host_frames += 1
            except (hd.DecodeError, EOFError):
                pass  # trailing garbage/padding
        if si.total_samples and len(pcm) > si.total_samples:
            pcm = pcm[: si.total_samples]
        if self.check_md5 and si.md5sum != b"\x00" * 16:
            md5 = MD5Context()
            md5.accumulate(pcm, si.bits_per_sample)
            if md5.digest() != si.md5sum:
                self.errors.append("MD5 signature mismatch")
        return pcm, dict(frames=frames, path="device", errors=self.errors,
                         host_frames=host_frames, overflow_frames=overflow_frames)

    def _check_crc16(self, offsets: np.ndarray, ends: np.ndarray) -> np.ndarray:
        return check_frame_crc16(self.data_bytes, self.d, offsets, ends)

    # -- variable-blocksize streams (blocking_strategy=1) ---------------------
    # Foreign encoders only: neither this encoder nor the reference's emits
    # them. Frames group by blocksize: each group is a batch of one geometry
    # for the device decoder; small groups (and anything the index cannot pin
    # down) go to the sequential host decoder.

    _VAR_MIN_GROUP = 4    # smaller groups decode on the host
    _VAR_MAX_GROUPS = 8   # distinct device geometries a stream

    def _decode_variable(self, check_crc: bool) -> tuple[np.ndarray, dict]:
        si = self.streaminfo
        if self.continue_on_error:
            # concealment and resync are the sequential path's
            return self._host_fallback("host")
        words = torch.as_tensor(bytes_to_words(self.d, bucket=True), device=self.device)
        idx = index_frames_variable(self.d, self.audio_offset, si)
        if idx is None:
            return self._host_fallback("host")
        offsets, bss, snos, exts = idx
        nfr = len(offsets)
        total = int(snos[-1] + bss[-1]) if nfr else 0
        pcm = np.zeros((total, si.channels), np.int32)
        ends_all = np.zeros(nfr, np.int64)
        host = None
        host_frames = overflow_frames = 0
        # device groups: the most frequent blocksizes, large groups only
        uniq, counts = np.unique(bss, return_counts=True)
        top = np.argsort(-counts)[: self._VAR_MAX_GROUPS]
        dev_bs = {int(b) for b, c in zip(uniq[top], counts[top])
                  if c >= self._VAR_MIN_GROUP}
        host_idx = [i for i in range(nfr) if int(bss[i]) not in dev_bs]
        for bs in sorted(dev_bs):
            sel = np.flatnonzero(bss == bs)
            geom = DecoderGeometry(blocksize=int(bs), channels=si.channels,
                                   bits_per_sample=si.bits_per_sample,
                                   sample_rate=si.sample_rate,
                                   max_lpc_order=self.max_lpc_order,
                                   dynamic_header_ext=True)
            dec = build_frame_decoder(geom, self.device)
            B = min(self.batch_frames, len(sel))
            for s in range(0, len(sel), B):
                g = sel[s:s + B]
                nb = len(g)
                gg = np.concatenate([g, np.repeat(g[-1:], B - nb)]) if nb < B else g
                gp, ge, gm = dec(words, offsets[gg] * 8, exts[gg])
                gp = gp.cpu().numpy()[:nb].astype(np.int32)
                ge_np = ge.cpu().numpy()[:nb] // 8
                ovf = gm["unary_overflow"].cpu().numpy()[:nb]
                for j in np.flatnonzero(ovf):
                    if host is None:
                        host = hd.HostDecoder(self.data_bytes, check_md5=False)
                    fpcm, fi = host.decode_frame_at(int(offsets[g[j]]))
                    gp[j] = fpcm.reshape(gp[j].shape)
                    ge_np[j] = fi.offset + fi.size
                    host_frames += 1
                    overflow_frames += 1
                for j in range(nb):
                    k = g[j]
                    pcm[snos[k]: snos[k] + bs] = gp[j].reshape(-1, si.channels)
                    ends_all[k] = ge_np[j]
        for k in host_idx:
            if host is None:
                host = hd.HostDecoder(self.data_bytes, check_md5=False)
            fpcm, fi = host.decode_frame_at(int(offsets[k]))
            pcm[snos[k]: snos[k] + bss[k]] = fpcm
            ends_all[k] = fi.offset + fi.size
            host_frames += 1
        if nfr:
            if np.any(ends_all[:-1] > offsets[1:]) or ends_all[-1] > len(self.d):
                raise StreamDecodeError("frame length overrun — corrupt stream?")
            if check_crc:
                bad = self._check_crc16(offsets, ends_all)
                if len(bad):
                    raise hd.DecodeError(
                        f"frame CRC-16 mismatch in frame(s) {bad[:5].tolist()}")
        if si.total_samples and len(pcm) > si.total_samples:
            pcm = pcm[: si.total_samples]
        if self.check_md5 and si.md5sum != b"\x00" * 16:
            md5 = MD5Context()
            md5.accumulate(pcm, si.bits_per_sample)
            if md5.digest() != si.md5sum:
                raise hd.DecodeError("MD5 signature mismatch")
        return pcm, dict(frames=nfr, path="device-variable", errors=self.errors,
                         host_frames=host_frames, overflow_frames=overflow_frames)


def decode_bytes_device(data: bytes, check_md5: bool = True, batch_frames: int = 64,
                        max_lpc_order: int = 32, continue_on_error: bool = False,
                        device: str | torch.device | None = None):
    """Decode a whole FLAC stream on `device` (None: CUDA). Returns (pcm
    [n, channels] int32, streaminfo, info dict)."""
    dec = StreamDecoder(data, check_md5=check_md5, batch_frames=batch_frames,
                        max_lpc_order=max_lpc_order,
                        continue_on_error=continue_on_error, device=device)
    pcm, info = dec.decode_all()
    return pcm, dec.streaminfo, info
