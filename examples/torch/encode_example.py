"""Minimal encode example on the PyTorch/CUDA port — the analog of
examples/c/encode/file/main.c: read a WAV file, encode it to FLAC with
verify-while-encoding and a couple of tags, print progress statistics. The
device is FLAC_TPU_DEVICE's (unset: CUDA, which raises without a GPU;
`cpu` runs the plain versions)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from flac_tpu_torch.containers import read_audio
from flac_tpu_torch.encode.encoder import encode_file
from flac_tpu_torch.metadata import Padding, VorbisComment


def main() -> int:
    if len(sys.argv) != 3:
        print("usage: encode_example.py <in.wav> <out.flac>")
        return 1
    device = os.environ.get("FLAC_TPU_DEVICE") or None
    buf = read_audio(sys.argv[1])
    tags = VorbisComment(vendor_string="", comments=["ARTIST=example",
                                                     "TITLE=example"])
    stats = encode_file(buf.samples, buf.sample_rate, buf.bits_per_sample,
                        sys.argv[2], level=5, verify=True,
                        metadata=[tags, Padding(length=1024)], device=device)
    ratio = stats.bytes_written / max(buf.samples.size * 2, 1)
    print(f"encoded {stats.samples} samples in {stats.frames} frames, "
          f"{stats.bytes_written} bytes (ratio {ratio:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
