"""Sequential host decoder — the robustness/fallback path and test oracle.

Behavioral analog of src/libFLAC/stream_decoder.c: metadata parse
(:1423-1917), ID3v2 skip (:1919), frame sync scan (:1941), frame/subframe/
residual parsing (:1996-2776), channel-decorrelation undo (:2067-2103),
CRC-8/CRC-16 checks, and MD5 verification. Corrupted frames raise or (with
`continue_on_error`) are zeroed and reported, like the reference's error
callback + resync behavior (:2106-2113).

numpy vectorization is used where it doesn't complicate the logic (fixed
restore via cumsum). It is the port's own lossless check.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from flac_tpu_torch import constants as C
from flac_tpu_torch import crc as crc_mod
from flac_tpu_torch.bitio import BitReader, utf8_decode
from flac_tpu_torch.md5 import MD5Context
from flac_tpu_torch.metadata import StreamInfo, parse_metadata

try:  # native C++ host runtime (flac_tpu_torch/_native/runtime.cpp); optional
    from flac_tpu_torch import _native
    _HAVE_NATIVE = _native.available
except Exception:  # pragma: no cover
    _native = None
    _HAVE_NATIVE = False

BLOCKSIZE_FROM_CODE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608, 8: 256, 9: 512,
                       10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768}
SAMPLE_RATE_FROM_CODE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
                         7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}


class DecodeError(Exception):
    pass


class CrcMismatchError(DecodeError):
    """Frame parsed cleanly but its CRC-16 footer didn't match: the reference
    delivers a ZEROED block via the error callback and keeps going
    (stream_decoder.c:2106-2113), preserving stream-position alignment —
    unlike parse/sync errors, where the frame is dropped and the decoder
    rescans. `frame` carries the parsed geometry so callers can conceal."""

    def __init__(self, msg: str, frame: "FrameInfo") -> None:
        super().__init__(msg)
        self.frame = frame


@dataclass
class FrameInfo:
    """Per-frame structure, the analog of FLAC__Frame + analysis data
    (what `flac -a` prints, src/flac/analyze.c)."""

    offset: int  # byte offset in stream
    size: int
    blocksize: int
    sample_rate: int
    channels: int
    channel_assignment: int
    bits_per_sample: int
    frame_number: int
    sample_number: int
    subframes: list = field(default_factory=list)
    concealed: bool = False  # delivered as a zeroed block after CRC mismatch


@dataclass
class SubframeInfo:
    type: int
    order: int
    wasted_bits: int
    partition_order: int = 0
    rice_params: list = field(default_factory=list)  # escaped partitions hold -1
    raw_bits: list = field(default_factory=list)  # per partition; 0 unless escaped
    qlp_precision: int = 0
    quantization_level: int = 0
    qlp_coeff: list = field(default_factory=list)
    warmup: list = field(default_factory=list)
    constant_value: int = 0
    is_rice2: bool = False
    residual: "np.ndarray | None" = None  # kept when keep_residuals is set


def skip_id3v2(data: bytes, pos: int) -> int:
    """ID3v2 tag skip (stream_decoder.c:1919)."""
    if data[pos : pos + 3] == b"ID3":
        size = 0
        for b in data[pos + 6 : pos + 10]:
            size = (size << 7) | (b & 0x7F)
        return pos + 10 + size
    return pos


class HostDecoder:
    """Decode a whole FLAC stream held in memory."""

    def __init__(self, data: bytes, check_md5: bool = True,
                 continue_on_error: bool = False,
                 keep_residuals: bool = False) -> None:
        self.data = bytes(data)
        self.check_md5 = check_md5
        self.continue_on_error = continue_on_error
        self.keep_residuals = keep_residuals
        self._nb = _native.NativeBytes(self.data) if _HAVE_NATIVE else None
        self.errors: list[str] = []
        pos = skip_id3v2(self.data, 0)
        if self.data[pos : pos + 4] != C.STREAM_SYNC_STRING:
            raise DecodeError("missing fLaC stream marker")
        self.metadata, self.audio_offset = parse_metadata(self.data, pos + 4)
        si = self.metadata[0]
        if not isinstance(si, StreamInfo):
            raise DecodeError("first metadata block is not STREAMINFO")
        self.streaminfo = si

    # -- frame-level parsing --------------------------------------------------

    def read_frame_header(self, r: BitReader):
        """Parse + validate one frame header at a byte-aligned position.

        Returns (blocksize, sample_rate, channels, assignment, bps,
        number_is_sample, number) or raises DecodeError
        (read_frame_header_, stream_decoder.c:2141)."""
        start_byte = r.pos >> 3
        if r.read_bits(14) != C.FRAME_HEADER_SYNC:
            raise DecodeError("lost sync")
        if r.read_bits(1):
            raise DecodeError("reserved bit set")
        blocking_strategy = r.read_bits(1)
        bs_code = r.read_bits(4)
        sr_code = r.read_bits(4)
        ca_code = r.read_bits(4)
        bps_code = r.read_bits(3)
        if r.read_bits(1):
            raise DecodeError("reserved bit set")
        number = utf8_decode(r)
        if bs_code == 0:
            raise DecodeError("reserved blocksize code")
        elif bs_code == 6:
            blocksize = r.read_bits(8) + 1
        elif bs_code == 7:
            blocksize = r.read_bits(16) + 1
        else:
            blocksize = BLOCKSIZE_FROM_CODE[bs_code]
        if sr_code == 0:
            sample_rate = self.streaminfo.sample_rate
        elif sr_code == 12:
            sample_rate = r.read_bits(8) * 1000
        elif sr_code == 13:
            sample_rate = r.read_bits(16)
        elif sr_code == 14:
            sample_rate = r.read_bits(16) * 10
        elif sr_code == 15:
            raise DecodeError("invalid sample rate code")
        else:
            sample_rate = SAMPLE_RATE_FROM_CODE[sr_code]
        if ca_code < 8:
            channels, assignment = ca_code + 1, C.CHANNEL_ASSIGNMENT_INDEPENDENT
        elif ca_code == 8:
            channels, assignment = 2, C.CHANNEL_ASSIGNMENT_LEFT_SIDE
        elif ca_code == 9:
            channels, assignment = 2, C.CHANNEL_ASSIGNMENT_RIGHT_SIDE
        elif ca_code == 10:
            channels, assignment = 2, C.CHANNEL_ASSIGNMENT_MID_SIDE
        else:
            raise DecodeError("reserved channel assignment")
        if bps_code == 0:
            bps = self.streaminfo.bits_per_sample
        elif bps_code in C.FRAME_HEADER_BPS_FROM_CODE:
            bps = C.FRAME_HEADER_BPS_FROM_CODE[bps_code]
        else:
            raise DecodeError("reserved bits-per-sample code")
        crc_stored = r.read_bits(8)
        hdr_bytes = self.data[start_byte : r.pos >> 3]
        if crc_mod.crc8(hdr_bytes[:-1]) != crc_stored:
            raise DecodeError("frame header CRC-8 mismatch")
        return blocksize, sample_rate, channels, assignment, bps, blocking_strategy, number

    def read_subframe(self, r: BitReader, blocksize: int, bps: int) -> tuple[np.ndarray, SubframeInfo]:
        """read_subframe_ (stream_decoder.c:2450)."""
        if r.read_bits(1):
            raise DecodeError("subframe sync bit set")
        stype = r.read_bits(6)
        wasted = 0
        if r.read_bits(1):
            wasted = 1
            while r.read_bits(1) == 0:
                wasted += 1
        ebps = bps - wasted
        if stype == 0:
            info = SubframeInfo(C.SUBFRAME_TYPE_CONSTANT, 0, wasted)
            val = _sign_extend(r.read_bits(ebps), ebps)
            info.constant_value = val
            x = np.full(blocksize, val, np.int64)
        elif stype == 1:
            info = SubframeInfo(C.SUBFRAME_TYPE_VERBATIM, 0, wasted)
            if self._nb is not None:
                x, r.pos = self._nb.read_signed_array(r.pos, blocksize, ebps)
            else:
                x = np.array([_sign_extend(r.read_bits(ebps), ebps)
                              for _ in range(blocksize)], np.int64)
        elif (stype & 0b111000) == 0b001000:
            order = stype & 7
            if order > 4:
                raise DecodeError("invalid fixed order")
            info = SubframeInfo(C.SUBFRAME_TYPE_FIXED, order, wasted)
            warmup = [_sign_extend(r.read_bits(ebps), ebps) for _ in range(order)]
            info.warmup = warmup
            res = self.read_residual(r, blocksize, order, info)
            x = (_native.fixed_restore(res, warmup, order) if self._nb is not None
                 else _fixed_restore_np(res, warmup, order))
        elif stype & 0b100000:
            order = (stype & 0b011111) + 1
            info = SubframeInfo(C.SUBFRAME_TYPE_LPC, order, wasted)
            warmup = [_sign_extend(r.read_bits(ebps), ebps) for _ in range(order)]
            info.warmup = warmup
            prec = r.read_bits(4) + 1
            if prec == 16:
                raise DecodeError("invalid qlp precision")
            shift = _sign_extend(r.read_bits(5), 5)
            if shift < 0:
                raise DecodeError("negative qlp shift")
            qlp = [_sign_extend(r.read_bits(prec), prec) for _ in range(order)]
            info.qlp_precision = prec
            info.quantization_level = shift
            info.qlp_coeff = qlp
            res = self.read_residual(r, blocksize, order, info)
            x = (_native.lpc_restore(res, warmup, qlp, shift) if self._nb is not None
                 else _lpc_restore_np(res, warmup, qlp, shift))
        else:
            raise DecodeError(f"reserved subframe type {stype:06b}")
        if wasted:
            x = x << wasted
        return x, info

    def read_residual(self, r: BitReader, blocksize: int, order: int,
                      info: SubframeInfo) -> np.ndarray:
        """read_residual_partitioned_rice_ (stream_decoder.c:2715), with
        RICE/RICE2 and escape-code support."""
        method = r.read_bits(2)
        if method > 1:
            raise DecodeError("reserved entropy coding method")
        info.is_rice2 = method == 1
        plen = 5 if method == 1 else 4
        pesc = 31 if method == 1 else 15
        po = r.read_bits(4)
        info.partition_order = po
        nparts = 1 << po
        if blocksize >> po <= order and po > 0:
            raise DecodeError("invalid partition order")
        if blocksize % nparts:
            raise DecodeError("blocksize not divisible by partition count")
        out = np.empty(blocksize - order, np.int64)
        pos = 0
        for p in range(nparts):
            n = (blocksize >> po) - (order if p == 0 else 0)
            param = r.read_bits(plen)
            if param == pesc:
                raw = r.read_bits(5)
                info.rice_params.append(-1)
                info.raw_bits.append(raw)
                if self._nb is not None:
                    out[pos:pos + n], r.pos = self._nb.read_signed_array(r.pos, n, raw)
                else:
                    for i in range(n):
                        out[pos + i] = _sign_extend(r.read_bits(raw), raw) if raw else 0
            else:
                info.rice_params.append(param)
                info.raw_bits.append(0)
                if self._nb is not None:
                    out[pos:pos + n], r.pos = self._nb.rice_read_block(r.pos, n, param)
                else:
                    for i in range(n):
                        out[pos + i] = r.read_rice_signed(param)
            pos += n
        if self.keep_residuals:
            info.residual = out.copy()
        return out

    # -- stream-level decoding ------------------------------------------------

    def decode_frame_at(self, byte_offset: int) -> tuple[np.ndarray, FrameInfo]:
        r = BitReader(self.data, byte_offset * 8)
        bs, sr, ch, ca, bps, strat, number = self.read_frame_header(r)
        frame = FrameInfo(offset=byte_offset, size=0, blocksize=bs, sample_rate=sr,
                          channels=ch, channel_assignment=ca, bits_per_sample=bps,
                          frame_number=0 if strat else number,
                          sample_number=number if strat else -1)
        chans = []
        for c in range(ch):
            cbps = bps
            # the side channel carries one extra bit (stream_decoder.c:2022-2044)
            if ca == C.CHANNEL_ASSIGNMENT_LEFT_SIDE and c == 1:
                cbps += 1
            elif ca == C.CHANNEL_ASSIGNMENT_RIGHT_SIDE and c == 0:
                cbps += 1
            elif ca == C.CHANNEL_ASSIGNMENT_MID_SIDE and c == 1:
                cbps += 1
            x, sinfo = self.read_subframe(r, bs, cbps)
            frame.subframes.append(sinfo)
            chans.append(x)
        r.align_to_byte()
        crc_stored = r.read_bits(16)
        nbytes = (r.pos >> 3) - byte_offset
        frame.size = nbytes
        if crc_mod.crc16(self.data[byte_offset : byte_offset + nbytes - 2]) != crc_stored:
            raise CrcMismatchError("frame CRC-16 mismatch", frame)
        # undo inter-channel decorrelation (stream_decoder.c:2067-2103)
        if ca == C.CHANNEL_ASSIGNMENT_LEFT_SIDE:
            chans[1] = chans[0] - chans[1]
        elif ca == C.CHANNEL_ASSIGNMENT_RIGHT_SIDE:
            chans[0] = chans[0] + chans[1]
        elif ca == C.CHANNEL_ASSIGNMENT_MID_SIDE:
            mid2 = (chans[0] << 1) | (chans[1] & 1)
            left = (mid2 + chans[1]) >> 1
            right = (mid2 - chans[1]) >> 1
            chans = [left, right]
        pcm = np.stack(chans, axis=1).astype(np.int32)
        return pcm, frame

    def find_sync(self, pos: int) -> int:
        """Scan forward for the next plausible frame sync (frame_sync_,
        stream_decoder.c:1941). Byte-aligned scan (our encoder and libFLAC
        both emit byte-aligned frames)."""
        if self._nb is not None:
            return self._nb.find_sync(pos)
        data = self.data
        while pos < len(data) - 1:
            if data[pos] == 0xFF and (data[pos + 1] & 0xFE) == 0xF8:
                return pos
            pos += 1
        raise EOFError

    def decode_all(self) -> tuple[np.ndarray, list[FrameInfo]]:
        """Decode the whole stream; returns (pcm [n, channels] int32, frames)."""
        pos = self.audio_offset
        pcm_parts: list[np.ndarray] = []
        frames: list[FrameInfo] = []
        md5 = MD5Context()
        nbytes = len(self.data)
        while pos < nbytes - 2:
            try:
                pcm, frame = self.decode_frame_at(pos)
            except CrcMismatchError as e:
                if not self.continue_on_error:
                    raise DecodeError(f"at byte {pos}: {e}") from e
                # concealment: deliver a zeroed block and keep alignment
                # (stream_decoder.c:2106-2113); the frame's channel count must
                # match the stream's for the block to slot into the output
                frame = e.frame
                frame.concealed = True
                self.errors.append(f"at byte {pos}: {e}")
                if frame.channels == self.streaminfo.channels:
                    pcm_parts.append(
                        np.zeros((frame.blocksize, frame.channels), np.int32))
                    frames.append(frame)
                pos += frame.size
                continue
            except (DecodeError, EOFError, ValueError, KeyError) as e:
                if not self.continue_on_error:
                    raise DecodeError(f"at byte {pos}: {e}") from e
                self.errors.append(f"at byte {pos}: {e}")
                try:
                    pos = self.find_sync(pos + 1)
                    continue
                except EOFError:
                    break
            pcm_parts.append(pcm)
            frames.append(frame)
            pos += frame.size
        pcm = (np.concatenate(pcm_parts, axis=0) if pcm_parts
               else np.zeros((0, self.streaminfo.channels), np.int32))
        if self.streaminfo.total_samples and len(pcm) > self.streaminfo.total_samples:
            pcm = pcm[: self.streaminfo.total_samples]
        if self.check_md5 and self.streaminfo.md5sum != b"\x00" * 16:
            md5.accumulate(pcm, self.streaminfo.bits_per_sample)
            if md5.digest() != self.streaminfo.md5sum:
                msg = "MD5 signature mismatch"
                if not self.continue_on_error:
                    raise DecodeError(msg)
                self.errors.append(msg)
        return pcm, frames


def _sign_extend(v: int, nbits: int) -> int:
    if nbits == 0:
        return 0
    return v - (1 << nbits) if v >= (1 << (nbits - 1)) else v


def _fixed_restore_np(res: np.ndarray, warmup: list[int], order: int) -> np.ndarray:
    if order == 0:
        return res
    seeds = []
    cur = np.asarray(warmup, np.int64)
    for _ in range(order):
        seeds.append(cur[0:1])
        cur = np.diff(cur)
    out = res
    for k in range(order - 1, -1, -1):
        out = np.cumsum(np.concatenate([seeds[k], out]))
    return out


def _lpc_restore_np(res: np.ndarray, warmup: list[int], qlp: list[int], shift: int) -> np.ndarray:
    order = len(qlp)
    x = np.empty(order + len(res), np.int64)
    x[:order] = warmup
    q = qlp
    for t in range(order, len(x)):
        acc = 0
        for j in range(order):
            acc += q[j] * x[t - 1 - j]
        x[t] = res[t - order] + (acc >> shift)
    return x


def decode_bytes(data: bytes, check_md5: bool = True,
                 continue_on_error: bool = False):
    """Convenience: full in-memory decode. Returns (pcm, streaminfo, frames)."""
    dec = HostDecoder(data, check_md5=check_md5, continue_on_error=continue_on_error)
    pcm, frames = dec.decode_all()
    return pcm, dec.streaminfo, frames
