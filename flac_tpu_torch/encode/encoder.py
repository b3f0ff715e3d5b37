"""Host-side stream encoder — the port of flac_tpu.encode.encoder.

Stream header emission ("fLaC" + STREAMINFO + VORBIS_COMMENT + user
metadata, init_stream_internal_ stream_encoder.c:1029-1128), frame batching
onto the frame encoder, MD5 accumulation, STREAMINFO/seektable statistics
and the seek-back rewrite at finish (update_metadata_ :2516).

Frames are encoded in batches by encode.frame_encoder on the chosen device
(None: CUDA). Two routes, flac_tpu's: on the card (or under
FLAC_TPU_PACKER=pallas) the dense one, where each batch of full frames is
compacted on the device into one word stream, of which only the valid
prefix comes back and is written in one piece (`_emit_dense`); on the CPU
the padded word matrix comes back and is written frame by frame (`_emit`).
The final partial frame takes the second route in both. With `verify=True`
every batch of full frames is decoded where it was packed (decode.
frame_decoder's verifier) and compared with its input before it is
written; the final partial frame is not verified, as in flac_tpu.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from flac_tpu_torch import constants as C
from flac_tpu_torch.decode.frame_decoder import make_verifier
from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.encode import packer
from flac_tpu_torch.encode.frame_encoder import (
    EncoderConfig, build_frame_encoder, build_frame_encoder_dense,
    resolve_packer_impl, use_dense_packer)
from flac_tpu_torch.md5 import MD5Context
from flac_tpu_torch.metadata import (
    MetadataBlock,
    SeekPoint,
    SeekTable,
    StreamInfo,
    VorbisComment,
    serialize_metadata,
)
from flac_tpu_torch.version import VENDOR_STRING


class VerifyError(Exception):
    pass


@dataclass
class EncodeStats:
    frames: int = 0
    samples: int = 0
    bytes_written: int = 0
    min_framesize: int = (1 << 31) - 1
    max_framesize: int = 0
    assignments: list = field(default_factory=list)
    batches: int = 0  # frame-encoder calls, the final partial frame included


class StreamEncoder:
    """Streaming FLAC encoder with the reference's process()/finish() shape.

    Usage:
        enc = StreamEncoder(config, out_stream, metadata=[...])
        enc.process(samples)   # [n, channels] int32, any chunking
        enc.finish()
    """

    def __init__(self, config: EncoderConfig, out, metadata: list[MetadataBlock] | None = None,
                 batch_frames: int = 64, total_samples_estimate: int = 0,
                 do_md5: bool = True, seekpoints: list[int] | None = None,
                 verify: bool = False, device: str | torch.device | None = None):
        self.cfg = config.resolve()
        self.device = resolve_device(device)
        # the word fill is chosen once (FLAC_TPU_PACKER), for every build
        self._packer_impl = resolve_packer_impl(None, self.device)
        self.out = out
        self.batch_frames = batch_frames
        self.do_md5 = do_md5
        self.verify = verify
        self._md5 = MD5Context()
        self._buf = np.zeros((0, self.cfg.channels), np.int32)
        self._frame_no = 0
        # the dense route compacts each batch on the device, so that only
        # the compressed bytes cross to the host
        self._dense = use_dense_packer(self.device)
        build = build_frame_encoder_dense if self._dense else build_frame_encoder
        self._encode = build(self.cfg, device=self.device,
                             packer_impl=self._packer_impl)
        self._finish_encoders: dict[int, object] = {}
        self.stats = EncodeStats()
        self._finished = False

        # loose mid-side reuses assignment state across a cycle; batches must
        # start at cycle boundaries (frame_encoder handles in-batch reuse)
        if self.cfg.loose_mid_side:
            q = self.cfg.loose_mid_side_frames
            self.batch_frames = max(q, (batch_frames // q) * q)

        # --- stream header -------------------------------------------------
        self._streaminfo = StreamInfo(
            min_blocksize=self.cfg.blocksize, max_blocksize=self.cfg.blocksize,
            min_framesize=0, max_framesize=0, sample_rate=self.cfg.sample_rate,
            channels=self.cfg.channels, bits_per_sample=self.cfg.bits_per_sample,
            total_samples=total_samples_estimate, md5sum=b"\x00" * 16)
        blocks: list[MetadataBlock] = [self._streaminfo]
        self._seektable: SeekTable | None = None
        user_blocks = list(metadata or [])
        if seekpoints:
            self._seektable = SeekTable(points=[
                SeekPoint(sp, 0, 0) if sp != SeekPoint.PLACEHOLDER
                else SeekPoint(SeekPoint.PLACEHOLDER, 0, 0) for sp in seekpoints])
            blocks.append(self._seektable)
        for b in user_blocks:
            if isinstance(b, SeekTable) and self._seektable is None:
                self._seektable = b
            if isinstance(b, VorbisComment):
                # the stream encoder stamps its own vendor string on every
                # VORBIS_COMMENT it writes (stream_encoder_framing.c:53-68)
                b = replace(b, vendor_string=VENDOR_STRING)
            blocks.append(b)
        # libFLAC always emits a VORBIS_COMMENT with its vendor string when the
        # caller didn't supply one (init_stream_internal_, stream_encoder.c:1068)
        if not any(isinstance(b, VorbisComment) for b in blocks):
            blocks.insert(1, VorbisComment(vendor_string=VENDOR_STRING))
        self._blocks = blocks
        out.write(C.STREAM_SYNC_STRING)
        self._metadata_offset = 4
        header = serialize_metadata(blocks)
        out.write(header)
        self._audio_offset = 4 + len(header)
        self._pending_seekpoints = (
            sorted(p.sample_number for p in self._seektable.points
                   if not p.is_placeholder) if self._seektable else [])
        self._seek_fill: dict[int, tuple[int, int]] = {}
        self._verifier = make_verifier(self.cfg, self.device) if verify else None

    # -- processing ---------------------------------------------------------

    def process(self, samples: np.ndarray) -> None:
        assert not self._finished
        if samples.ndim == 1:
            samples = samples[:, None]
        assert samples.shape[1] == self.cfg.channels
        self._buf = np.concatenate([self._buf, samples.astype(np.int32)], axis=0)
        bs = self.cfg.blocksize
        # keep one sample of lookahead so the final (possibly partial) block is
        # always flushed by finish(), mirroring the reference's OVERREAD_
        # (stream_encoder.c:515)
        while self._buf.shape[0] > bs * self.batch_frames:
            chunk = self._buf[: bs * self.batch_frames]
            self._buf = self._buf[bs * self.batch_frames:]
            self._encode_full_frames(chunk)
        nfull = self._buf.shape[0] // bs
        if self._buf.shape[0] % bs == 0 and nfull > 0:
            nfull -= 1  # retain the last full block until finish()
        if nfull > 0:
            chunk = self._buf[: bs * nfull]
            self._buf = self._buf[bs * nfull:]
            self._encode_full_frames(chunk)

    def _encode_full_frames(self, chunk: np.ndarray) -> None:
        bs = self.cfg.blocksize
        nframes = chunk.shape[0] // bs
        frames = chunk.reshape(nframes, bs, self.cfg.channels)
        if self.do_md5:
            self._md5.accumulate(chunk, self.cfg.bits_per_sample)
        B = self.batch_frames
        for start in range(0, nframes, B):
            batch = frames[start : start + B]
            nb = batch.shape[0]
            if nb < B:  # pad to the static batch size; padded outputs dropped
                batch = np.concatenate(
                    [batch, np.repeat(batch[-1:], B - nb, axis=0)], axis=0)
            fnos = np.arange(self._frame_no, self._frame_no + B, dtype=np.int64)
            if self._dense:
                stream, total, total_bits, _info = self._encode(batch, fnos)
                self.stats.batches += 1
                total_bits = total_bits.cpu().numpy()
                if self.verify:
                    self._run_verify(self._dense_rows(stream, total_bits, nb), nb, batch)
                total = int(total)
                host = stream[: (total + 3) // 4].cpu().numpy()
                self._emit_dense(host, total, total_bits, nb)
            else:
                words, total_bits, _info = self._encode(batch, fnos)
                self.stats.batches += 1
                if self.verify:
                    self._run_verify(words, nb, batch)
                self._emit(words.cpu().numpy(), total_bits.cpu().numpy(), nb)
            self._frame_no += nb
            self.stats.samples += nb * bs

    def _frame_written(self, i: int, n: int) -> None:
        """Stats and the seektable fill-in of the batch's frame i, of n
        bytes, as it streams out (write_frame_, stream_encoder.c:2453-2470):
        claim the pending points inside the frame."""
        bs = self.cfg.blocksize
        sample_pos = (self._frame_no + i) * bs
        while self._pending_seekpoints and self._pending_seekpoints[0] < sample_pos + bs:
            target = self._pending_seekpoints[0]
            if target < sample_pos:
                self._pending_seekpoints.pop(0)
                continue
            if target < sample_pos + bs:
                self._seek_fill[target] = (sample_pos, self.stats.bytes_written)
                self._pending_seekpoints.pop(0)
        self.stats.bytes_written += n
        self.stats.frames += 1
        self.stats.min_framesize = min(self.stats.min_framesize, n)
        self.stats.max_framesize = max(self.stats.max_framesize, n)

    def _emit(self, words: np.ndarray, total_bits: np.ndarray,
              nframes: int) -> None:
        """Write the batch's first `nframes` frames from the padded word
        matrix, one write a frame."""
        byte_view = words.astype(">u4").view(np.uint8).reshape(words.shape[0], -1)
        lengths = (total_bits + 7) // 8
        for i in range(nframes):
            n = int(lengths[i])
            assert total_bits[i] % 8 == 0
            assert n <= byte_view.shape[1], "frame overflowed static pack buffer"
            self.out.write(byte_view[i, :n].tobytes())
            self._frame_written(i, n)

    def _emit_dense(self, host_words: np.ndarray, total: int,
                    total_bits: np.ndarray, nframes: int) -> None:
        """Write the batch's first `nframes` frames from the compacted
        stream's valid words (fetched from the device in one copy): they
        are a contiguous prefix (the padding frames come after them), so
        one write."""
        lengths = (total_bits + 7) // 8
        want = int(lengths[:nframes].sum())
        assert want <= total <= 4 * len(host_words)
        for i in range(nframes):
            self._frame_written(i, int(lengths[i]))
        # big-endian bytes in one copy (stream_words_to_bytes' serialization),
        # written without another
        self.out.write(host_words.view(np.uint32).astype(">u4").view(np.uint8)[:want])

    def _dense_rows(self, stream: torch.Tensor, total_bits: np.ndarray,
                    nframes: int) -> torch.Tensor:
        """flac_tpu's dense verify input, built on the device from the
        compacted stream: the first `nframes` frames, each a row of maxb
        bytes (the batch's largest frame), zero past its frame."""
        lengths = (total_bits[:nframes].astype(np.int64) + 7) // 8
        maxb = int(lengths.max())
        starts = np.cumsum(lengths) - lengths
        dev = stream.device
        data = packer.big_endian_bytes(stream[: (int(lengths.sum()) + 3) // 4])
        col = torch.arange(maxb, dtype=torch.int64, device=dev)
        idx = torch.as_tensor(starts, device=dev)[:, None] + col
        inside = col < torch.as_tensor(lengths, device=dev)[:, None]
        return torch.where(inside, data[torch.clamp(idx, max=data.numel() - 1)], 0)

    def _run_verify(self, rows: torch.Tensor, nframes: int,
                    pcm_batch: np.ndarray) -> None:
        """Verify-while-encoding (the reference's decoder-in-the-loop,
        stream_encoder.c:314,977-1006): decode the frames where they were
        packed and compare them with the input PCM. `rows` are the padded
        word rows (int32 [B, W]) or the dense route's byte rows (uint8
        [nframes, maxb])."""
        got = self._verifier(rows)[:nframes].to(torch.int32)
        want = torch.as_tensor(pcm_batch[:nframes], device=self.device)
        if torch.equal(got, want):
            return
        got, want = got.cpu().numpy(), pcm_batch[:nframes]
        f, s, ch = np.argwhere(got != want)[0]
        raise VerifyError(
            f"verify mismatch at frame {int(f) + self._frame_no} sample {int(s)} "
            f"channel {int(ch)}: expected {int(want[f, s, ch])}, "
            f"got {int(got[f, s, ch])}")

    # -- finish -------------------------------------------------------------

    def finish(self) -> StreamInfo:
        assert not self._finished
        bs = self.cfg.blocksize
        # flush whole frames first, then the final partial frame
        nfull = self._buf.shape[0] // bs
        if nfull:
            chunk = self._buf[: bs * nfull]
            self._buf = self._buf[bs * nfull:]
            self._encode_full_frames(chunk)
        rem = self._buf.shape[0]
        if rem:
            tail = self._buf
            self._buf = self._buf[:0]
            if self.do_md5:
                self._md5.accumulate(tail, self.cfg.bits_per_sample)
            enc = self._finish_encoders.get(rem)
            if enc is None:
                enc = build_frame_encoder(self.cfg, blocksize=rem,
                                          device=self.device,
                                          packer_impl=self._packer_impl)
                self._finish_encoders[rem] = enc
            words, total_bits, _info = enc(
                tail[None, :, :], np.asarray([self._frame_no], np.int64))
            self.stats.batches += 1
            self._emit_partial(words[0].cpu().numpy(), int(total_bits[0]))
            self._frame_no += 1
            self.stats.samples += rem
        self._finished = True
        # rewrite STREAMINFO (+ seektable) with final statistics
        si = self._streaminfo
        si.min_framesize = 0 if self.stats.frames == 0 else self.stats.min_framesize
        si.max_framesize = self.stats.max_framesize
        si.total_samples = self.stats.samples
        si.md5sum = self._md5.digest() if self.do_md5 else b"\x00" * 16
        if self._seektable:
            for p in self._seektable.points:
                if p.is_placeholder:
                    continue
                fill = self._seek_fill.get(p.sample_number)
                if fill is None:
                    # point beyond the stream: becomes a placeholder
                    p.sample_number = SeekPoint.PLACEHOLDER
                    p.stream_offset = 0
                    p.frame_samples = 0
                else:
                    p.sample_number, p.stream_offset = fill[0], fill[1]
                    p.frame_samples = bs
        if self.out.seekable():
            self.out.seek(self._metadata_offset)
            self.out.write(serialize_metadata(self._blocks))
            self.out.seek(0, io.SEEK_END)
        return si

    def _emit_partial(self, words: np.ndarray, total_bits: int) -> None:
        data = words.astype(">u4").view(np.uint8).tobytes()[: total_bits // 8]
        self.out.write(data)
        n = len(data)
        self.stats.bytes_written += n
        self.stats.frames += 1
        self.stats.min_framesize = min(self.stats.min_framesize, n)
        self.stats.max_framesize = max(self.stats.max_framesize, n)


def encode_file(in_samples: np.ndarray, sample_rate: int, bits_per_sample: int,
                out_path: str, level: int = 5, blocksize: int | None = None,
                metadata: list[MetadataBlock] | None = None,
                seekpoints: list[int] | None = None, batch_frames: int = 64,
                verify: bool = False, do_md5: bool = True,
                device: str | torch.device | None = None,
                **overrides) -> EncodeStats:
    """Encode an int32 [n, channels] PCM array to a FLAC file on `device`
    (None: CUDA; raises without a GPU unless device="cpu").

    `in_samples` may also be an array-like that materializes on slicing: the
    input is fed to the stream encoder in bounded chunks. `verify=True`
    decodes every batch of full frames on the device and raises VerifyError
    on the first sample that differs from the input."""
    device = resolve_device(device)  # raise before the output file is opened
    if in_samples.ndim == 1:
        in_samples = in_samples[:, None]
    cfg = EncoderConfig.from_level(level, in_samples.shape[1], bits_per_sample,
                                   sample_rate, blocksize=blocksize, **overrides)
    n = in_samples.shape[0]
    with open(out_path, "wb") as f:
        enc = StreamEncoder(cfg, f, metadata=metadata, seekpoints=seekpoints,
                            batch_frames=batch_frames,
                            total_samples_estimate=n,
                            verify=verify, do_md5=do_md5, device=device)
        # feed in encoder-batch multiples: ndarray inputs pass through as
        # views; lazy inputs convert one chunk at a time
        step = max(enc.cfg.blocksize * enc.batch_frames, 1 << 20)
        for s in range(0, n, step):
            enc.process(np.asarray(in_samples[s : s + step]))
        enc.finish()
    return enc.stats
