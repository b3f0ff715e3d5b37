"""Streaming decode example on the PyTorch/CUDA port — decode a FLAC file of
ANY length to WAV in constant memory: container headers first, PCM blocks
as the batched device decoder produces them (StreamDecoder.iter_blocks
keeps a bounded number of device batches in flight). The analog of the
reference's callback-driven decode loop (examples/c/decode/file/main.c) at
production scale. The device is FLAC_TPU_DEVICE's (unset: CUDA, which
raises without a GPU; `cpu` runs the plain versions)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from flac_tpu_torch.containers import AudioBuffer, wav_header_bytes, wav_trailer_bytes
from flac_tpu_torch.containers.wav import _wav_pcm_bytes
from flac_tpu_torch.decode.stream import StreamDecoder


def main() -> int:
    if len(sys.argv) != 3:
        print("usage: stream_decode_example.py <in.flac> <out.wav>")
        return 1
    device = os.environ.get("FLAC_TPU_DEVICE") or None
    with open(sys.argv[1], "rb") as f:
        data = f.read()
    dec = StreamDecoder(data, device=device)
    si = dec.streaminfo
    n = 0
    with open(sys.argv[2], "wb") as out:
        out.write(wav_header_bytes(si.total_samples, si.channels,
                                   si.bits_per_sample, si.sample_rate))
        for block in dec.iter_blocks():  # raises on CRC error; MD5 at the end
            out.write(_wav_pcm_bytes(AudioBuffer(
                samples=block, sample_rate=si.sample_rate,
                bits_per_sample=si.bits_per_sample)))
            n += len(block)
        out.write(wav_trailer_bytes(n, si.channels, si.bits_per_sample))
        if n != si.total_samples:  # short stream: fix the header sizes up
            out.seek(0)
            out.write(wav_header_bytes(n, si.channels, si.bits_per_sample,
                                       si.sample_rate))
    print(f"streamed {n} samples x {si.channels} channels "
          f"({dec.decode_info['frames']} frames); MD5 verified")
    return 0


if __name__ == "__main__":
    sys.exit(main())
