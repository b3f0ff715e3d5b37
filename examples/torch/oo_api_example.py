"""Callback-style (OO) API example on the PyTorch/CUDA port — the analog of
the reference's C++ examples (examples/cpp/encode/file/main.cpp,
examples/cpp/decode/file/main.cpp): subclass-style Decoder with
write/metadata/error callbacks, and the Encoder facade with a progress
callback. The device is FLAC_TPU_DEVICE's (unset: CUDA, which raises without
a GPU; `cpu` runs the plain versions).

Usage: oo_api_example.py <in.wav> <out.flac>   (encodes, then decodes back
and verifies the PCM round trip through the callback API)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from flac_tpu_torch.api import Decoder, Encoder
from flac_tpu_torch.containers import read_audio
from flac_tpu_torch.metadata import StreamInfo, VorbisComment


def main() -> int:
    if len(sys.argv) != 3:
        print("usage: oo_api_example.py <in.wav> <out.flac>")
        return 1
    device = os.environ.get("FLAC_TPU_DEVICE") or None
    buf = read_audio(sys.argv[1])

    # ---- encode with a progress callback (stream_encoder.h:677) ----------
    def progress(stats):
        print(f"\rwrote {stats.bytes_written} bytes, "
              f"{stats.samples} samples, {stats.frames} frames", end="")

    enc = Encoder(sys.argv[2], sample_rate=buf.sample_rate,
                  bits_per_sample=buf.bits_per_sample,
                  channels=buf.samples.shape[1], compression_level=5,
                  metadata=[VorbisComment(vendor_string="",
                                          comments=["TITLE=oo example"])],
                  verify=True, total_samples_estimate=len(buf.samples),
                  progress_callback=progress, device=device)
    # feed in arbitrary chunks, like a capture loop would
    for start in range(0, len(buf.samples), 65536):
        enc.process(buf.samples[start:start + 65536])
    enc.finish()
    print()

    # ---- decode through callbacks (decoder.h:99: write/metadata/error) ---
    chunks: list[np.ndarray] = []

    class MyDecoder(Decoder):
        def write_callback(self, frame_pcm, frame_info):
            chunks.append(frame_pcm)
            return True

        def metadata_callback(self, block):
            if isinstance(block, StreamInfo):
                print(f"streaminfo: {block.sample_rate} Hz, "
                      f"{block.channels} ch, {block.bits_per_sample} bps, "
                      f"{block.total_samples} samples")
            elif isinstance(block, VorbisComment):
                for c in block.comments:
                    print(f"tag: {c}")

        def error_callback(self, status):
            print(f"decode error: {status}", file=sys.stderr)

    dec = MyDecoder(sys.argv[2], device=device)
    # STREAMINFO responds by default; opt in to the rest
    # (stream_decoder.h:811-879 respond/ignore filtering)
    dec.set_metadata_respond_all()
    dec.process_until_end_of_metadata()
    dec.process_until_end_of_stream()

    got = np.concatenate(chunks)
    ok = np.array_equal(got, buf.samples)
    print("round trip:", "bit-exact" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
