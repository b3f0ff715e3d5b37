"""One rank of the port's multi-process tests (tests/test_torch_parallel.py).

    python tests/_torch_dist_worker.py RANK WORLD INIT_FILE INPUTS.npz OUT.npz DEVICE TASK...

Joins a gloo process group through a `file://` store (no port needed),
builds the ('host', 'chip') mesh, runs the named tasks of
flac_tpu_torch.parallel.sharding with `device=DEVICE` ("cpu", or "card":
device=None, this rank's GPU, whose tensors the step hands to gloo on the
host) and writes what each returned to OUT.npz, for the test to hold
against flac_tpu. It imports only flac_tpu_torch, torch and numpy: a worker
that imported flac_tpu would bring JAX, and its x64 mode, into the process. Every rank raises the
same errors at the same point, so a task that is meant to raise records
the error's class instead of leaving the other rank in a collective.
"""

from __future__ import annotations

import sys
from datetime import timedelta
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from flac_tpu_torch.encode.frame_encoder import EncoderConfig  # noqa: E402
from flac_tpu_torch.parallel import sharding  # noqa: E402

BS = 256
DEVICE = "cpu"  # set by main: "cpu", or None for this rank's card


def _config() -> EncoderConfig:
    return EncoderConfig.from_level(5, channels=2, bits_per_sample=16,
                                    sample_rate=44100, blocksize=BS)


def _error_name(fn) -> str:
    try:
        fn()
    except Exception as e:  # the test compares the class with flac_tpu's
        return type(e).__name__
    return ""


def task_step(mesh, inp, out):
    """One encode step over 16 frames, this rank's rows of them."""
    frames = inp["step_pcm"].reshape(-1, BS, 2)
    fpd = frames.shape[0] // mesh.size()
    r = dist.get_rank()
    res = sharding.build_sharded_encode_step(_config(), mesh, fpd, DEVICE)(
        frames[r * fpd:(r + 1) * fpd], np.arange(r * fpd, (r + 1) * fpd))
    for k in ("words", "nbytes", "stream_offset", "assignment", "min_framesize",
              "max_framesize", "total_bytes"):
        out[f"step_{k}"] = getattr(res, k).cpu().numpy()
    out["frames_sharded_words"] = sharding.encode_frames_sharded(
        frames, _config(), mesh, device=DEVICE).words.cpu().numpy()


def task_audit(mesh, inp, out):
    """The collective calls and bytes of one step at two batch sizes."""
    frames = inp["step_pcm"].reshape(-1, BS, 2)
    r = dist.get_rank()
    for fpd in (2, 8):
        step = sharding.build_sharded_encode_step(_config(), mesh, fpd, DEVICE)
        calls, nbytes = sharding.collective_calls, sharding.collective_bytes
        step(frames[r * fpd:(r + 1) * fpd], np.arange(r * fpd, (r + 1) * fpd))
        out[f"audit_{fpd}"] = np.array([sharding.collective_calls - calls,
                                        sharding.collective_bytes - nbytes])


def task_corpus(mesh, inp, out):
    """The ragged corpus through encode_corpus_sharded, then decoded back."""
    corpus, ragged = inp["corpus"], int(inp["ragged"])
    stream = sharding.encode_corpus_sharded([corpus[:ragged], corpus[ragged:]], _config(),
                                            mesh, frames_per_device=8, device=DEVICE)
    out["corpus_stream"] = np.frombuffer(stream, np.uint8)
    out["decoded"] = sharding.decode_corpus_sharded(stream, mesh, frames_per_device=2,
                                                    max_lpc_order=12, device=DEVICE)
    bad = bytearray(stream)
    bad[len(bad) - 600] ^= 0x10
    out["corrupt_error"] = np.array(_error_name(lambda: sharding.decode_corpus_sharded(
        bytes(bad), mesh, frames_per_device=2, max_lpc_order=12, device=DEVICE)))
    out["variable_error"] = np.array(_error_name(lambda: sharding.decode_corpus_sharded(
        inp["variable"].tobytes(), mesh, frames_per_device=2, device=DEVICE)))


TASKS = {"step": task_step, "audit": task_audit, "corpus": task_corpus}


def main(argv: list[str]) -> int:
    global DEVICE
    rank, world = int(argv[0]), int(argv[1])
    init_file, inputs, out_path, tasks = argv[2], argv[3], argv[4], argv[6:]
    DEVICE = None if argv[5] == "card" else argv[5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        mesh = sharding.make_mesh(DEVICE)
        inp = dict(np.load(inputs))
        out: dict[str, np.ndarray] = {}
        for name in tasks:
            TASKS[name](mesh, inp, out)
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
