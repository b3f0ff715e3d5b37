"""Minimal decode example on the PyTorch/CUDA port — the analog of
examples/c/decode/file/main.c: decode a FLAC file to WAV, verifying CRCs
and the stream MD5. The device is FLAC_TPU_DEVICE's (unset: CUDA, which
raises without a GPU; `cpu` runs the plain versions)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from flac_tpu_torch.containers import AudioBuffer, write_wav
from flac_tpu_torch.decode.stream import decode_bytes_device


def main() -> int:
    if len(sys.argv) != 3:
        print("usage: decode_example.py <in.flac> <out.wav>")
        return 1
    device = os.environ.get("FLAC_TPU_DEVICE") or None
    with open(sys.argv[1], "rb") as f:
        data = f.read()
    pcm, streaminfo, info = decode_bytes_device(data, device=device)  # raises on CRC/MD5 error
    write_wav(sys.argv[2], AudioBuffer(samples=pcm,
                                       sample_rate=streaminfo.sample_rate,
                                       bits_per_sample=streaminfo.bits_per_sample))
    print(f"decoded {len(pcm)} samples x {streaminfo.channels} channels "
          f"({info['frames']} frames, path={info['path']}); MD5 verified")
    return 0


if __name__ == "__main__":
    sys.exit(main())
