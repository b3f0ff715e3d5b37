"""Random access: the analog of FLAC__stream_decoder_seek_absolute — the port
of flac_tpu.decode.seek.

Reference algorithm (src/libFLAC/stream_decoder.c:1163 →
seek_to_absolute_sample_ :2973): establish byte bounds
[first_frame_offset, stream_length], refine them from SEEKTABLE points
(:3031-3073), then run a linear-interpolated bisection — jump to a guessed
byte position, scan for the next frame sync, parse the header (CRC-8
validated, so payload false-syncs are rejected) to learn that frame's first
sample number, and narrow the interval until the frame containing the target
is found. The delivered block is trimmed to start exactly at the target
sample (write_audio_frame_to_client_ trimming).

The search runs on the host. Bulk reads after a seek decode in device
batches (decode.frame_decoder, on `device`) when the stream has one
geometry, and frame by frame on the host decoder otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from flac_tpu_torch.bitio import BitReader
from flac_tpu_torch.decode import host_decoder as hd
from flac_tpu_torch.decode.frame_decoder import (DecoderGeometry,
                                                 build_frame_decoder,
                                                 bytes_to_words)
from flac_tpu_torch.decode.stream import index_frames
from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.metadata import SeekTable, StreamInfo


class SeekError(Exception):
    pass


class SeekableDecoder:
    """Positioned decoding over an in-memory FLAC stream, on `device` (None:
    CUDA, which raises without a GPU).

    Usage:
        dec = SeekableDecoder(flac_bytes)
        dec.seek_absolute(123456)
        pcm = dec.read(44100)          # [n, channels] int32

    or one-shot:
        pcm = dec.decode_range(123456, 44100)
    """

    def __init__(self, data: bytes, check_crc: bool = True,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        data = bytes(data)
        if data[:4] == b"OggS":
            raise NotImplementedError(
                "Ogg FLAC input is not ported to flac_tpu_torch yet "
                "(ROADMAP queue 1 item 11b)")
        self._host = hd.HostDecoder(data, check_md5=False)
        self.data = self._host.data
        self.streaminfo: StreamInfo = self._host.streaminfo
        self.metadata = self._host.metadata
        self.audio_offset = self._host.audio_offset
        self.check_crc = check_crc
        self.seektable: SeekTable | None = next(
            (b for b in self.metadata if isinstance(b, SeekTable)), None)
        # decode position state
        self._byte_pos = self.audio_offset
        self._pending: np.ndarray | None = None  # leftover PCM of the current frame
        self._skip_into_frame = 0
        self._findex: np.ndarray | None | bool = False  # False: not built yet
        self._words: torch.Tensor | None = None

    # -- header-only probing ---------------------------------------------------

    def _probe_frame(self, pos: int, limit: int | None = None):
        """Scan forward from byte `pos` for a valid frame header; return
        (offset, first_sample, blocksize) without decoding the payload.
        CRC-8 rejects false syncs inside subframe payloads."""
        end = len(self.data) if limit is None else min(limit, len(self.data))
        while True:
            try:
                pos = self._host.find_sync(pos)
            except EOFError:
                raise SeekError("no frame sync found") from None
            if pos >= end:
                raise SeekError("no frame sync found in range")
            r = BitReader(self.data, pos * 8)
            try:
                bs, _sr, _ch, _ca, _bps, strat, number = self._host.read_frame_header(r)
            except (hd.DecodeError, EOFError, KeyError, ValueError):
                # a false sync inside payload bytes: CRC-8 mismatch, reserved
                # codes, or malformed UTF-8 numbers — scan on
                pos += 1
                continue
            first_sample = number if strat else number * self.streaminfo.min_blocksize
            return pos, first_sample, bs

    def _total_samples_estimate(self) -> int:
        si = self.streaminfo
        if si.total_samples:
            return si.total_samples
        # unknown length: estimate from stream size and a probed frame's density
        pos, first_sample, bs = self._probe_frame(self.audio_offset)
        audio_bytes = len(self.data) - self.audio_offset
        _pcm, fi = self._host.decode_frame_at(pos)
        return max(1, audio_bytes * bs // max(fi.size, 1))

    # -- seeking ---------------------------------------------------------------

    def seek_absolute(self, target_sample: int) -> None:
        """Position the decoder so the next read() returns samples starting
        at `target_sample` (seek_to_absolute_sample_, stream_decoder.c:2973)."""
        si = self.streaminfo
        total = self._total_samples_estimate()
        if target_sample < 0:
            raise SeekError("negative target sample")
        if si.total_samples and target_sample >= si.total_samples:
            raise SeekError("seek past end of stream")

        lower_pos, lower_sample = self.audio_offset, 0
        upper_pos, upper_sample = len(self.data), max(total, 1)

        # refine bounds from the seektable (stream_decoder.c:3031-3073)
        if self.seektable is not None:
            for p in self.seektable.points:
                if p.is_placeholder:
                    continue
                s = p.sample_number
                off = self.audio_offset + p.stream_offset
                if s <= target_sample and s >= lower_sample and off >= self.audio_offset:
                    lower_pos, lower_sample = off, s
                elif s > target_sample and (s < upper_sample or upper_pos == len(self.data)):
                    upper_pos, upper_sample = min(off, len(self.data)), s

        # linear-interpolated bisection on sample position
        for _ in range(64):  # convergence guard
            span_samples = max(upper_sample - lower_sample, 1)
            frac = (target_sample - lower_sample) / span_samples
            guess = int(lower_pos + frac * (upper_pos - lower_pos))
            # back off about one frame so the sync scan lands at or before
            # the target frame
            approx_frame_bytes = max(
                (upper_pos - lower_pos) * si.min_blocksize // span_samples, 64)
            guess = max(lower_pos, min(guess - approx_frame_bytes, upper_pos - 1))
            try:
                fpos, fsample, fbs = self._probe_frame(guess, limit=upper_pos)
            except SeekError:
                # overshot into the last partial region: bisect down
                upper_pos = guess
                if upper_pos <= lower_pos:
                    raise
                continue
            if fsample <= target_sample < fsample + fbs:
                self._byte_pos = fpos
                self._pending = None
                self._skip_into_frame = target_sample - fsample
                return
            if fsample > target_sample:
                if (fpos, fsample) == (upper_pos, upper_sample):
                    # degenerate: scan linearly backward by shrinking upper
                    upper_pos = max(lower_pos + 1, fpos - 1)
                else:
                    upper_pos, upper_sample = fpos, fsample
            else:
                if (fpos, fsample) == (lower_pos, lower_sample) and fpos >= guess:
                    # degenerate: walk forward frame by frame
                    _pcm, fi = self._host.decode_frame_at(fpos)
                    lower_pos, lower_sample = fpos + fi.size, fsample + fbs
                else:
                    lower_pos, lower_sample = fpos, fsample
        raise SeekError("seek did not converge")

    # -- reading ---------------------------------------------------------------

    _DEVICE_MIN_FRAMES = 8  # below this, frame-by-frame host decode

    def _frame_index(self) -> np.ndarray | None:
        """The whole stream's frame index (stream.index_frames), built at
        first use, for bulk reads; None when the stream has more than one
        geometry or its index is ambiguous."""
        if self._findex is False:
            self._findex = None
            si = self.streaminfo
            if si.min_blocksize == si.max_blocksize:
                d = np.frombuffer(self.data, np.uint8)
                idx = index_frames(d, self.audio_offset, si)
                if idx is not None and len(idx):
                    self._findex = np.asarray(idx, np.int64)
        return self._findex

    def _device_decode_frames(self, offs: np.ndarray):
        """Batched device decode of the full frames at `offs`: (pcm
        [m*blocksize, ch], end byte of the last frame), or None when a frame
        overruns the next indexed offset (a corrupt index: the caller decodes
        on the host). A CUDA failure raises."""
        si = self.streaminfo
        geom = DecoderGeometry(blocksize=si.min_blocksize, channels=si.channels,
                               bits_per_sample=si.bits_per_sample,
                               sample_rate=si.sample_rate)
        dec = build_frame_decoder(geom, self.device)
        if self._words is None:
            self._words = torch.as_tensor(bytes_to_words(self.data, bucket=True),
                                          device=self.device)
        B = 64
        parts: list[np.ndarray] = []
        end = 0
        m = len(offs)
        for s in range(0, m, B):
            bo = offs[s:s + B]
            nb = len(bo)
            if nb < B:
                bo = np.concatenate([bo, np.repeat(bo[-1:], B - nb)])
            pcm, ends, meta = dec(self._words, bo * 8)
            pcm = pcm.cpu().numpy()[:nb].astype(np.int32)
            ends_np = ends.cpu().numpy()[:nb] // 8
            ovf = meta["unary_overflow"].cpu().numpy()[:nb]
            for j in np.flatnonzero(ovf):  # frames the scan flags: the host's
                fpcm, fi = self._host.decode_frame_at(int(bo[j]))
                pcm[j] = fpcm.reshape(pcm[j].shape)
                ends_np[j] = fi.offset + fi.size
            # frame-length sanity against the next indexed offsets
            nxt = offs[s + 1:s + nb]
            if (len(nxt) and np.any(ends_np[:len(nxt)] > nxt)) \
                    or ends_np[nb - 1] > len(self.data):
                return None
            parts.append(pcm.reshape(-1, si.channels))
            end = int(ends_np[nb - 1])
        return np.concatenate(parts, axis=0), end

    def read(self, nsamples: int) -> np.ndarray:
        """Decode `nsamples` samples from the current position (fewer at EOF).

        Bulk reads over one-geometry streams run through the batched device
        decoder; the tail, partial frames and other streams through the
        sequential host decoder."""
        parts: list[np.ndarray] = []
        got = 0
        skip = self._skip_into_frame
        self._skip_into_frame = 0
        if self._pending is not None and len(self._pending):
            take = self._pending[:nsamples]
            self._pending = self._pending[len(take):]
            parts.append(take)
            got += len(take)
        bs = max(self.streaminfo.min_blocksize, 1)
        while got < nsamples and self._byte_pos < len(self.data) - 2:
            need_frames = (nsamples - got + skip) // bs
            if need_frames >= self._DEVICE_MIN_FRAMES:
                idx = self._frame_index()
                if idx is not None:
                    i = int(np.searchsorted(idx, self._byte_pos))
                    if i < len(idx) and idx[i] == self._byte_pos:
                        m = min(need_frames, len(idx) - i)
                        if m >= self._DEVICE_MIN_FRAMES:
                            res = self._device_decode_frames(idx[i:i + m])
                            if res is not None:
                                block, end_byte = res
                                self._byte_pos = end_byte
                                if skip:
                                    block = block[skip:]
                                    skip = 0
                                take = block[:nsamples - got]
                                if len(take) < len(block):
                                    self._pending = block[len(take):]
                                parts.append(take)
                                got += len(take)
                                continue
            try:
                pcm, fi = self._host.decode_frame_at(self._byte_pos)
            except (hd.DecodeError, EOFError, ValueError, KeyError):
                break  # trailing garbage / end of audio
            self._byte_pos += fi.size
            if skip:
                pcm = pcm[skip:]
                skip = 0
            take = pcm[:nsamples - got]
            if len(take) < len(pcm):
                self._pending = pcm[len(take):]
            parts.append(take)
            got += len(take)
        if not parts:
            return np.zeros((0, self.streaminfo.channels), np.int32)
        return np.concatenate(parts, axis=0)

    def decode_range(self, start_sample: int, nsamples: int) -> np.ndarray:
        """One-shot positioned decode: seek + read."""
        self.seek_absolute(start_sample)
        return self.read(nsamples)

    def tell(self) -> int:
        """Current byte position in the stream (diagnostic)."""
        return self._byte_pos
