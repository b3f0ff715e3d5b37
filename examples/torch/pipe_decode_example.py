"""Bounded-memory pipe decode example on the PyTorch/CUDA port.

Decode an unbounded FLAC (or Ogg FLAC) pipe — e.g. `cat big.flac |
python examples/torch/pipe_decode_example.py > out.raw` — holding only a
fixed compressed window plus one PCM batch in memory, however long the
stream is. The analog of a reference client using
FLAC__stream_decoder_init_stream with a read callback
(stream_decoder.h:433-470). The device is FLAC_TPU_DEVICE's (unset: CUDA,
which raises without a GPU; `cpu` runs the plain versions).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from flac_tpu_torch.decode.streaming import ByteFeed, ChunkedStreamDecoder


def main() -> int:
    device = os.environ.get("FLAC_TPU_DEVICE") or None
    feed = ByteFeed(sys.stdin.buffer)
    feed.ensure(4)
    src = feed
    if bytes(feed.view()[:4]) == b"OggS":
        from flac_tpu_torch.ogg import OggToNativeReader
        src = OggToNativeReader(feed.read)  # incremental page demux
    dec = ChunkedStreamDecoder(src, device=device)  # raises on CRC/MD5 errors
    si = dec.streaminfo
    print(f"{si.channels}ch {si.bits_per_sample}-bit {si.sample_rate} Hz, "
          f"{si.total_samples or '?'} samples", file=sys.stderr)
    out = sys.stdout.buffer
    for block in dec.iter_blocks():       # int32 [n, channels]
        out.write(block.astype("<i4").tobytes())
    print(f"done: {dec.decode_info}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
