"""Host-side stream encoder — the port of flac_tpu.encode.encoder.

Stream header emission ("fLaC" + STREAMINFO + VORBIS_COMMENT + user
metadata, init_stream_internal_ stream_encoder.c:1029-1128), frame batching
onto the frame encoder, MD5 accumulation, STREAMINFO/seektable statistics
and the seek-back rewrite at finish (update_metadata_ :2516).

Frames are encoded in batches by encode.frame_encoder on the chosen device
(None: CUDA), on every device by flac_tpu's dense route: each batch of full
frames is compacted on the device into one word stream, of which only the
valid prefix comes back and is written in one piece (`_emit_dense`). The
final partial frame comes back as its own word row, through
frame_encoder.encode_tail: one length-generic step, replayed from its third
call on, for every length at which the step's static choices are those of
the full blocksize (at -5 16-bit, every length from 41 samples), and a step
built for the length below that.

On CUDA the batches of full frames run two deep: batch k+1's step is
launched (its host inputs through graphs.GraphedStep's page-locked
staging, its outputs started towards page-locked host buffers behind it,
with one event) before batch k is copied back, verified and written, so
the card runs one batch's step while the host finishes the one before.
The batch still in flight is carried across process() calls and drained
by finish(): the remaining full frames' batch is launched, then the final
partial frame's step, then every earlier batch is written, then the tail.
So on CUDA process() may return with one batch's bytes not yet written;
they, and its VerifyError if any, come by the next process() or by
finish(). The stats and the progress they feed count what was written.
On the CPU the step is synchronous and the depth is 1: each batch is
written before the next is launched. The pipeline's counters, over the
process: `pipeline_batches` (batches of full frames launched),
`pipelined_batches` (those launched while an earlier batch of the same
stream was unfinished) and `pipeline_wait_ns` (main-thread host-clock
nanoseconds spent waiting for a batch's event, inside its first
`encoder.copy_back`).

With `verify=True` (flac -V) every frame is decoded and compared with its
input before it is written. A batch of full frames is decoded where it was
packed (decode.frame_decoder's verifier); the frames its scan flags
(`unary_overflow`), whose device samples are not the frame's, and the final
partial frame are decoded on the host from their own bytes
(decode.host_decoder, the route decode.stream takes for them). flac_tpu
compares the flagged frames' device samples, and so raises on some valid
streams, and leaves the final partial frame unverified; the port does
neither, and writes the same bytes.

Each StreamEncoder is one request of flac_tpu_torch.trace, from its
construction to finish(); its stages are the spans `encoder.open`,
`encoder.process`, `encoder.buffer`, `encoder.batch` (one a step call),
`encoder.copy_back`, `encoder.verify` (child `encoder.verify_host`, a host
decode), `encoder.emit` (the last three a batch's finish: on CUDA inside
the next batch's `encoder.batch`, or inside the `encoder.tail` or
`encoder.finish` that drains it), `encoder.md5_wait`, `encoder.finish`,
`encoder.tail` and `encoder.streaminfo`, and `encoder.md5` on the MD5
worker thread, its parent the span that handed the update over. Verify's
counters, over the process: `verified_frames` (frames compared with their
input, the final partial ones included), `verify_host_frames` (those of
them decoded on the host) and `verify_ns` (host-clock nanoseconds inside
verify).

The STREAMINFO MD5 is accumulated on the process's MD5 worker, one thread
made at the first update, in the order the samples were handed over: each
chunk of full frames before its batches are stepped, the final partial
frame before its step. The hash overlaps the main thread's step, copy back,
verify and emit of the same chunk (the native update releases the GIL).
Every process() and finish() waits for the updates it handed over before
it returns (`encoder.md5_wait`), and raises there an update's exception;
no chunk handed over is written afterwards (the buffer is only ever
replaced, never written in place). The MD5 counters, over the process:
`md5_updates` (updates run on the worker, counted when waited for) and
`md5_wait_ns` (main-thread host-clock nanoseconds spent waiting for them).
"""

from __future__ import annotations

import contextlib
import functools
import io
import os
import time
from collections import deque
from concurrent import futures
from dataclasses import dataclass, replace

import numpy as np
import torch

from flac_tpu_torch import constants as C
from flac_tpu_torch import trace
from flac_tpu_torch.decode import host_decoder as hd
from flac_tpu_torch.decode.frame_decoder import make_verifier
from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.encode import packer
from flac_tpu_torch.encode.frame_encoder import (
    EncoderConfig, build_frame_encoder_dense, encode_tail)
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


# verify's counters, over the process (module docstring)
verified_frames = 0
verify_host_frames = 0
verify_ns = 0

# the MD5 worker's counters, over the process (module docstring)
md5_updates = 0
md5_wait_ns = 0

# the pipeline's counters, over the process (module docstring)
pipeline_batches = 0
pipelined_batches = 0
pipeline_wait_ns = 0


@dataclass
class EncodeStats:
    frames: int = 0
    samples: int = 0
    bytes_written: int = 0
    min_framesize: int = (1 << 31) - 1
    max_framesize: int = 0
    batches: int = 0  # frame-encoder calls, the final partial frame included


@dataclass
class _Launched:
    """A batch of full frames whose step has been called: its padded input
    (verify compares with it), how many of its frames are real, the
    compacted stream on the device, the host copies of (stream, total,
    total_bits), and the event after those copies (None where the step ran
    synchronously, on the CPU)."""

    pcm: np.ndarray
    nframes: int
    stream: torch.Tensor
    host: tuple
    ready: torch.cuda.Event | None


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
        # one request from here to finish(): every span of this stream
        # carries its id
        self._stream = trace.new_stream()
        with trace.span("encoder.open", stream=self._stream):
            self.cfg = config.resolve()
            self.device = resolve_device(device)
            self.out = out
            self.batch_frames = batch_frames
            self.do_md5 = do_md5
            self.verify = verify
            self._md5 = MD5Context()
            self._md5_worker: futures.ThreadPoolExecutor | None = None
            self._md5_pending: list[futures.Future] = []
            self._buf = np.zeros((0, self.cfg.channels), np.int32)
            self._frame_no = 0  # frames written
            self._launched_frames = 0  # frames whose step was called
            # batches launched and not yet written, oldest first; at most
            # pipeline_depth - 1 of them between two calls
            self._in_flight: deque[_Launched] = deque()
            self.pipeline_depth = 2 if self.device.type == "cuda" else 1
            # each batch is compacted on the device, so that only the
            # compressed bytes cross to the host
            self._encode = build_frame_encoder_dense(self.cfg, device=self.device)
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
            # a host decode reads a frame's header against this STREAMINFO
            self._verify_header = (C.STREAM_SYNC_STRING + serialize_metadata([self._streaminfo])
                                   if verify else None)

    # -- processing ---------------------------------------------------------

    def process(self, samples: np.ndarray) -> None:
        assert not self._finished
        if samples.ndim == 1:
            samples = samples[:, None]
        assert samples.shape[1] == self.cfg.channels
        with trace.span("encoder.process", stream=self._stream):
            try:
                for chunk in self._take_full_frames(samples):
                    self._encode_full_frames(chunk)
            finally:
                self._md5_barrier()

    def _take_full_frames(self, samples: np.ndarray) -> list[np.ndarray]:
        """Append `samples` to the buffer and take from it the chunks of
        full frames that can be encoded now."""
        bs, step = self.cfg.blocksize, self.cfg.blocksize * self.batch_frames
        chunks = []
        with trace.span("encoder.buffer"):
            self._buf = np.concatenate([self._buf, samples.astype(np.int32)], axis=0)
            # keep one sample of lookahead so the final (possibly partial)
            # block is always flushed by finish(), mirroring the reference's
            # OVERREAD_ (stream_encoder.c:515)
            while self._buf.shape[0] > step:
                chunks.append(self._buf[:step])
                self._buf = self._buf[step:]
            nfull = self._buf.shape[0] // bs
            if self._buf.shape[0] % bs == 0 and nfull > 0:
                nfull -= 1  # retain the last full block until finish()
            if nfull > 0:
                chunks.append(self._buf[: bs * nfull])
                self._buf = self._buf[bs * nfull:]
        return chunks

    def _encode_full_frames(self, chunk: np.ndarray) -> None:
        bs = self.cfg.blocksize
        nframes = chunk.shape[0] // bs
        frames = chunk.reshape(nframes, bs, self.cfg.channels)
        if self.do_md5:
            self._hash(chunk)
        B = self.batch_frames
        for start in range(0, nframes, B):
            with trace.span("encoder.batch"):
                self._launch_batch(frames[start : start + B])
                if len(self._in_flight) >= self.pipeline_depth:
                    self._finish_batch()

    def _hash(self, samples: np.ndarray) -> None:
        """Hand the MD5 update over `samples` to the process's MD5 worker,
        which runs the updates in the order they were handed over; the
        stream keeps the worker it first took."""
        if self._md5_worker is None:
            self._md5_worker = _md5_worker(os.getpid())
        self._md5_pending.append(self._md5_worker.submit(
            _md5_update, self._md5, samples, self.cfg.bits_per_sample, trace.current()))

    def _md5_barrier(self) -> None:
        """Wait until every MD5 update handed over has run; raise the first
        exception one of them raised. The counters are kept here, on the
        calling thread, as verify's are."""
        global md5_updates, md5_wait_ns
        if not self._md5_pending:
            return
        pending, self._md5_pending = self._md5_pending, []
        t0 = time.perf_counter_ns()
        with trace.span("encoder.md5_wait"):
            futures.wait(pending)
        md5_wait_ns += time.perf_counter_ns() - t0
        for f in pending:
            f.result()
        md5_updates += len(pending)

    def _launch_batch(self, batch: np.ndarray) -> None:
        """The launch half of a batch of full frames: one step call (padded
        to the static batch size), its outputs started towards the host,
        the batch queued for _finish_batch."""
        global pipeline_batches, pipelined_batches
        B = self.batch_frames
        nb = batch.shape[0]
        if nb < B:
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], B - nb, axis=0)], axis=0)
        fnos = np.arange(self._launched_frames, self._launched_frames + B, dtype=np.int64)
        stream, total, total_bits, _info = self._encode(batch, fnos)
        pipeline_batches += 1
        pipelined_batches += bool(self._in_flight)
        self._launched_frames += nb
        # the whole stream (a bound on its valid prefix), so that nothing
        # waits for `total` before the next launch
        host, ready = self._start_copy_back((stream, total, total_bits))
        self._in_flight.append(_Launched(batch, nb, stream, host, ready))

    def _start_copy_back(self, tensors: tuple) -> tuple:
        """(host copies of `tensors`, the event after them): on CUDA
        non-blocking copies into page-locked buffers behind the step on the
        stream; on the CPU the tensors themselves and no event."""
        if self.device.type != "cuda":
            return tensors, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return host, ready

    def _finish_batch(self) -> None:
        """The finish half of the oldest batch launched: wait for its copy
        back, verify it (the padded outputs dropped) and write it."""
        global pipeline_wait_ns
        launched = self._in_flight.popleft()
        nb = launched.nframes
        host_stream, total, total_bits = launched.host
        self.stats.batches += 1
        with trace.span("encoder.copy_back"):
            if launched.ready is not None:
                t0 = time.perf_counter_ns()
                launched.ready.synchronize()
                pipeline_wait_ns += time.perf_counter_ns() - t0
            total_bits = total_bits.numpy()
        if self.verify:
            with self._verifying(nb):
                self._run_verify(self._dense_rows(launched.stream, total_bits, nb), nb,
                                 launched.pcm, total_bits)
        with trace.span("encoder.copy_back"):
            total = int(total)
            host = host_stream[: (total + 3) // 4].numpy()
        with trace.span("encoder.emit"):
            self._emit_dense(host, total, total_bits, nb)
        self._frame_no += nb
        self.stats.samples += nb * self.cfg.blocksize

    def _drain(self) -> None:
        """Write every batch still in flight, oldest first."""
        while self._in_flight:
            self._finish_batch()

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

    def _run_verify(self, rows: torch.Tensor, nframes: int, pcm_batch: np.ndarray,
                    total_bits) -> None:
        """Verify-while-encoding (the reference's decoder-in-the-loop,
        stream_encoder.c:314,977-1006): decode the frames where they were
        packed and compare them with the input PCM; a frame the scan flags
        is decoded on the host from its own bytes and compared instead.
        `rows` are the batch's byte rows (uint8 [nframes, maxb],
        `_dense_rows`); `total_bits` each frame's length in bits. Raises
        VerifyError at the first frame that differs."""
        got, flagged = self._verifier(rows)
        got = got[:nframes].to(torch.int32)
        want = torch.as_tensor(pcm_batch[:nframes], device=self.device)
        # one copy back: a frame's device samples differ, the scan flagged it
        differs, flagged = torch.stack(
            [(got != want).flatten(1).any(1), flagged[:nframes]]).cpu().numpy()
        for f in np.flatnonzero(differs | flagged):
            if flagged[f]:
                self._verify_on_host(self._frame_bytes(rows, f, total_bits), pcm_batch[f],
                                     self._frame_no + int(f))
            else:
                self._raise_mismatch(got[f].cpu().numpy(), pcm_batch[f],
                                     self._frame_no + int(f))

    @contextlib.contextmanager
    def _verifying(self, nframes: int):
        """The span and counters of verifying `nframes` frames."""
        global verified_frames, verify_ns
        t0 = time.perf_counter_ns()
        try:
            with trace.span("encoder.verify"):
                yield
            verified_frames += nframes
        finally:
            verify_ns += time.perf_counter_ns() - t0

    @staticmethod
    def _frame_bytes(rows: torch.Tensor, f: int, total_bits) -> bytes:
        """Frame f's bytes, from its byte row."""
        return rows[f, : (int(total_bits[f]) + 7) // 8].cpu().numpy().tobytes()

    def _verify_on_host(self, data: bytes, want: np.ndarray, frame: int) -> None:
        """Decode frame number `frame` from its own bytes on the host (the
        frames the scan flags, the final partial frame) and compare it with
        its input `want` [n, channels]."""
        global verify_host_frames
        with trace.span("encoder.verify_host"):
            host = hd.HostDecoder(self._verify_header + data, check_md5=False)
            try:
                got, _info = host.decode_frame_at(len(self._verify_header))
            except (hd.DecodeError, EOFError, ValueError, KeyError) as e:
                raise VerifyError(f"verify: frame {frame} does not decode: {e}") from e
        verify_host_frames += 1
        if got.shape != want.shape:
            raise VerifyError(f"verify mismatch at frame {frame}: "
                              f"{got.shape[0]} samples decoded of {want.shape[0]}")
        if not np.array_equal(got, want):
            self._raise_mismatch(got, want, frame)

    @staticmethod
    def _raise_mismatch(got: np.ndarray, want: np.ndarray, frame: int) -> None:
        """VerifyError naming the first sample of the frame that differs."""
        s, ch = np.argwhere(got != want)[0]
        raise VerifyError(
            f"verify mismatch at frame {frame} sample {int(s)} channel {int(ch)}: "
            f"expected {int(want[s, ch])}, got {int(got[s, ch])}")

    # -- finish -------------------------------------------------------------

    def finish(self) -> StreamInfo:
        assert not self._finished
        with trace.span("encoder.finish", stream=self._stream):
            bs = self.cfg.blocksize
            try:
                # launch the whole frames first, then the final partial
                # frame, then write them in that order
                nfull = self._buf.shape[0] // bs
                if nfull:
                    chunk = self._buf[: bs * nfull]
                    self._buf = self._buf[bs * nfull:]
                    self._encode_full_frames(chunk)
                if self._buf.shape[0]:
                    tail = self._buf
                    self._buf = self._buf[:0]
                    if self.do_md5:
                        self._hash(tail)
                    with trace.span("encoder.tail"):
                        self._encode_tail(tail)
                self._drain()
            finally:
                self._md5_barrier()  # the digest is read below
            self._finished = True
            with trace.span("encoder.streaminfo"):
                return self._rewrite_metadata()

    def _encode_tail(self, tail: np.ndarray) -> None:
        """The final partial frame, by frame_encoder.encode_tail: the
        length-generic tail step, or a step built for its length. Its step
        is launched before the batches still in flight are written, and it
        is written after them."""
        rem = tail.shape[0]
        words, total_bits, _info = encode_tail(self.cfg, tail, self._launched_frames,
                                               self.device)
        self._launched_frames += 1
        self._drain()
        self.stats.batches += 1
        with trace.span("encoder.copy_back"):
            words, total_bits = words[0].cpu().numpy(), int(total_bits[0])
        data = words.astype(">u4").view(np.uint8).tobytes()[: total_bits // 8]
        if self.verify:
            with self._verifying(1):
                self._verify_on_host(data, tail, self._frame_no)
        with trace.span("encoder.emit"):
            self._emit_partial(data)
        self._frame_no += 1
        self.stats.samples += rem

    def _rewrite_metadata(self) -> StreamInfo:
        """Rewrite STREAMINFO (+ seektable) with the final statistics."""
        bs = self.cfg.blocksize
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

    def _emit_partial(self, data: bytes) -> None:
        self.out.write(data)
        n = len(data)
        self.stats.bytes_written += n
        self.stats.frames += 1
        self.stats.min_framesize = min(self.stats.min_framesize, n)
        self.stats.max_framesize = max(self.stats.max_framesize, n)


@functools.cache
def _md5_worker(pid: int) -> futures.ThreadPoolExecutor:
    """Process `pid`'s MD5 worker: one thread for every stream, made at the
    first update (a thread made and joined for each stream costs a short
    file more than its hash hides). A forked child, whose copy of the
    parent's worker has no thread, makes its own."""
    return futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="encoder-md5")


def _md5_update(md5: MD5Context, samples: np.ndarray, bits: int,
                cause: tuple | None) -> None:
    """One ordered MD5 update on the MD5 worker thread, a span caused by the
    span that handed it over."""
    with trace.span("encoder.md5", parent=cause):
        md5.accumulate(samples, bits)


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
    decodes every frame before it is written (StreamEncoder) and raises
    VerifyError on the first sample that differs from the input."""
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
