"""Headline benchmarks of the PyTorch/CUDA port (flac_tpu_torch): encode and
decode Msamples/s on one card at -5 and -8 — the counterpart of bench.py.

    python3 bench_torch.py                      # on the card (CUDA)
    FLAC_TPU_DEVICE=cpu python3 bench_torch.py  # the plain versions, small sizes

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"},
with bench.py's rows: the headline level-5 stereo 16/44.1 encode, and in
"extra" decode -5, encode and decode -8, the device-resident encode rows
(and on the card the 24-bit/96 kHz -8 one), the compression ratios, the
delivered decode, and the card's name and power limit as nvidia-smi gives
them. Unset, FLAC_TPU_DEVICE means CUDA, which raises without a GPU: nothing
drops to the CPU on its own.

Baselines (BASELINE.md, from the reference's doc/html/comparison.html):
flac -5 encode ~= 1.0 Msamples/s, decode ~= 2.7 Msamples/s of stereo samples
on the PII-333 benchmark machine; the -8 rows reuse the -5 baselines.

Measurement (PERF.md §2): the PCM and the words are staged in device memory
before the timed region; each row's wall is the host clock around the calls
and a final torch.cuda.synchronize() (or the copy back that ends them). The
encode rows copy the compressed bytes back to the host, the "_kernel" rows
leave them on the card; the decode rows leave the PCM on the card, the
delivered row copies it back.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

BASELINE_ENC = 1.0  # Msamples/s, libFLAC -5 encode (BASELINE.md)
BASELINE_DEC = 2.7  # Msamples/s, libFLAC -5 decode (BASELINE.md)
T = 4096


def make_corpus(n_samples: int, seed: int = 7) -> np.ndarray:
    """CD-audio-like stereo: correlated tonal content + noise floor, so the
    encoder exercises its real decision paths (LPC wins, mid-side wins often)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples, dtype=np.float64) / 44100.0
    base = (0.45 * np.sin(2 * np.pi * 220.0 * t)
            + 0.25 * np.sin(2 * np.pi * 659.3 * t + 0.3)
            + 0.12 * np.sin(2 * np.pi * 1760.0 * t + 1.1))
    am = 0.6 + 0.4 * np.sin(2 * np.pi * 0.37 * t)
    left = base * am + rng.normal(0, 0.004, n_samples)
    right = 0.92 * base * am + rng.normal(0, 0.004, n_samples)
    pcm = np.stack([left, right], axis=-1)
    return np.clip(np.round(pcm * 28000), -32768, 32767).astype(np.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_encode(level: int, batch: int, nbatches: int, reps: int, device: torch.device,
                 fetch: bool = True, bps: int = 16, rate: int = 44100):
    """Timed: the dense encode of every batch on `device`, and with `fetch`
    the copy back of each batch's compressed bytes (else they stay on the
    device and frame_bytes is None). bps=24 takes the wide datapath.
    Returns (msamples_per_s, frame_bytes of the fastest run)."""
    from flac_tpu_torch.encode.frame_encoder import EncoderConfig, build_frame_encoder_dense
    from flac_tpu_torch.encode.packer import stream_words_to_bytes

    cfg = EncoderConfig.from_level(level, channels=2, bits_per_sample=bps,
                                   sample_rate=rate, blocksize=T)
    encode = build_frame_encoder_dense(cfg, device=device)
    shift = bps - 16
    batches = [torch.as_tensor(make_corpus(batch * T, seed=7 + i).reshape(batch, T, 2) << shift,
                               device=device) for i in range(nbatches)]
    fnos = [torch.arange(i * batch, (i + 1) * batch, dtype=torch.int64, device=device)
            for i in range(nbatches)]

    def fetch_bytes(stream, total):
        n = int(total)
        return stream_words_to_bytes(stream[:(n + 3) // 4].cpu().numpy(), n)

    s, tot, _bits, _ = encode(batches[0], fnos[0])  # warm-up
    fetch_bytes(s, tot)
    best, frame_bytes = float("inf"), None
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        pending = [encode(batches[i], fnos[i]) for i in range(nbatches)]
        if fetch:
            got = [fetch_bytes(s, tot) for s, tot, _bits, _ in pending]
        else:
            _sync(device)
            got = None
        dt = time.perf_counter() - t0
        if dt < best:
            best, frame_bytes = dt, got
    samples = nbatches * batch * T * 2  # stereo samples, matching BASELINE.md
    return samples / best / 1e6, frame_bytes


def _assemble_stream(frame_bytes, nsamples: int) -> bytes:
    """Minimal fLaC header + the dense encoder's frame bytes = a valid
    fixed-blocksize stream for the decode bench (md5 zeroed: unverified)."""
    from flac_tpu_torch.metadata.blocks import StreamInfo, serialize_metadata

    si = StreamInfo(min_blocksize=T, max_blocksize=T, min_framesize=0,
                    max_framesize=0, sample_rate=44100, channels=2,
                    bits_per_sample=16, total_samples=nsamples,
                    md5sum=b"\x00" * 16)
    return b"fLaC" + serialize_metadata([si]) + b"".join(bytes(b) for b in frame_bytes)


def bench_decode(data: bytes, max_lpc_order: int, batch: int, reps: int,
                 device: torch.device, fetch: bool, expect: np.ndarray | None = None):
    """Timed: the batched decode of every whole batch of indexed frames on
    `device`; with fetch=False the PCM stays on the device, with fetch=True
    each batch is copied to the host. `expect` (the first batch's PCM) is
    checked outside the timed region: a rate for wrong samples is worthless."""
    from flac_tpu_torch.decode.frame_decoder import (DecoderGeometry, build_frame_decoder,
                                                     bytes_to_words)
    from flac_tpu_torch.decode.stream import index_frames
    from flac_tpu_torch.metadata import parse_metadata

    d = np.frombuffer(data, np.uint8)
    blocks, audio_offset = parse_metadata(data)
    geom = DecoderGeometry(blocksize=T, channels=2, bits_per_sample=16,
                           sample_rate=44100, max_lpc_order=max_lpc_order)
    dec = build_frame_decoder(geom, device)
    offsets = index_frames(d, audio_offset, blocks[0])
    if offsets is None or len(offsets) < batch:
        raise RuntimeError("bench_decode: the stream's frame index is short or ambiguous")
    nfr = len(offsets) // batch * batch  # whole batches only
    words = torch.as_tensor(bytes_to_words(d, bucket=True), device=device)
    starts = [torch.as_tensor(offsets[s:s + batch] * 8, device=device)
              for s in range(0, nfr, batch)]

    pcm, _ends, meta = dec(words, starts[0])  # warm-up
    if bool(meta["unary_overflow"].any()):
        raise RuntimeError("bench_decode: the scan flagged frames of the bench corpus")
    if expect is not None and not np.array_equal(
            pcm.cpu().numpy().astype(np.int32).reshape(expect.shape), expect):
        raise RuntimeError("bench_decode: decoded PCM differs from the input")
    best = float("inf")
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        pending = [dec(words, st) for st in starts]
        if fetch:
            for pcm, _ends, _meta in pending:
                pcm.cpu()
        else:
            _sync(device)
        best = min(best, time.perf_counter() - t0)
    return nfr * T * 2 / best / 1e6


def _oracle_ratio_rows(run_geometries: set) -> dict:
    """oracle_same_corpus rows from the recorded tools/oracle_ratio.json (the
    reference flac binary's ratio on the same make_corpus samples), emitted
    only when the record's corpus geometry (level, batch, nbatches, seed
    base, blocksize) matches this run's."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "oracle_ratio.json")
    try:
        with open(path) as f:
            rec = json.load(f)
    except FileNotFoundError:
        return {}
    rows = {}
    for e in rec.get("entries", []):
        key = (e.get("level"), e.get("batch"), e.get("nbatches"),
               e.get("seed_base"), e.get("blocksize"))
        if key in run_geometries:
            rows[f"-{e['level']}"] = e["ratio"]
    return {"oracle_same_corpus": rows} if rows else {}


def describe_device(device: torch.device) -> dict:
    """The device the rows ran on: the card's name and, as nvidia-smi gives
    them, its name and power limit."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}


def main() -> None:
    from flac_tpu_torch.device import resolve_device

    device = resolve_device(os.environ.get("FLAC_TPU_DEVICE") or None)
    on_card = device.type == "cuda"
    reps = 3 if on_card else 1
    b5 = 512 if on_card else 32
    b8 = 256 if on_card else 16
    n5 = 6 if on_card else 2
    n8 = 4 if on_card else 2

    enc5, frames5 = bench_encode(5, b5, n5, reps, device)
    enc8, frames8 = bench_encode(8, b8, n8, reps, device)
    # the encode with the compressed stream left on the device
    enc5_kernel, _ = bench_encode(5, b5, n5, reps, device, fetch=False)
    enc8_kernel, _ = bench_encode(8, b8, n8, reps, device, fetch=False)
    # the wide datapath (24-bit/96 kHz), on the card only as in bench.py
    enc24_kernel = (bench_encode(8, 256, 2, reps, device, fetch=False, bps=24, rate=96000)[0]
                    if on_card else None)
    # compressed size over raw 16-bit PCM, comparable to the reference
    # benchmark page's "avg ratio" column (53.67% at -5, BASELINE.md)
    ratio5 = sum(len(b) for b in frames5) / (b5 * n5 * T * 2 * 2)
    ratio8 = sum(len(b) for b in frames8) / (b8 * n8 * T * 2 * 2)

    stream5 = _assemble_stream(frames5, b5 * n5 * T)
    stream8 = _assemble_stream(frames8, b8 * n8 * T)
    dec_batch = 512 if on_card else 32
    dec_batch8 = min(dec_batch, b8 * n8)
    expect5 = np.concatenate([make_corpus(b5 * T, seed=7 + i).reshape(b5, T, 2)
                              for i in range(n5)])[:dec_batch]
    expect8 = np.concatenate([make_corpus(b8 * T, seed=7 + i).reshape(b8, T, 2)
                              for i in range(n8)])[:dec_batch8]
    dec5 = bench_decode(stream5, 8, dec_batch, reps, device, fetch=False, expect=expect5)
    dec8 = bench_decode(stream8, 12, dec_batch8, reps, device, fetch=False, expect=expect8)
    dec5_delivered = bench_decode(stream5, 8, dec_batch, reps, device, fetch=True)

    print(json.dumps({
        "metric": "encode_-5_stereo16_44k1_throughput_per_chip",
        "value": enc5,
        "unit": "Msamples/s",
        "vs_baseline": enc5 / BASELINE_ENC,
        "extra": {
            "device": describe_device(device),
            "decode_-5": {"value": dec5, "vs_baseline": dec5 / BASELINE_DEC},
            "encode_-8": {"value": enc8, "vs_baseline": enc8 / BASELINE_ENC},
            "encode_-5_kernel": {
                "value": enc5_kernel, "vs_baseline": enc5_kernel / BASELINE_ENC,
                "note": "the compressed stream stays on the device; the headline "
                        "encode rows include the copy back of its bytes"},
            "encode_-8_kernel": {"value": enc8_kernel,
                                 "vs_baseline": enc8_kernel / BASELINE_ENC},
            **({"encode_-8_24bit96k_kernel": {
                "value": enc24_kernel, "vs_baseline": enc24_kernel / BASELINE_ENC,
                "note": "wide datapath: the two-int32-limb LPC residual "
                        "(dsp.lpc.lpc_residual_limbs)"}} if enc24_kernel else {}),
            "decode_-8": {"value": dec8, "vs_baseline": dec8 / BASELINE_DEC},
            "compression_ratio": {
                "-5": ratio5, "-8": ratio8,
                **_oracle_ratio_rows({(5, b5, n5, 7, T), (8, b8, n8, 7, T)}),
                "note": "frame bytes / raw 16-bit PCM bytes on the bench corpus; "
                        "oracle_same_corpus is the reference flac binary's ratio "
                        "on the same samples (tools/oracle_ratio.json)"},
            "decode_-5_delivered": {
                "value": dec5_delivered, "vs_baseline": dec5_delivered / BASELINE_DEC,
                "note": "each batch's PCM copied back to the host"},
            "baselines_Msamples_s": {"encode_-5": BASELINE_ENC, "decode_-5": BASELINE_DEC,
                                     "note": "-8 rows reuse the -5 baselines (no -8 "
                                             "row on the reference's benchmark page)"},
            "sizes": {"b5": b5, "n5": n5, "b8": b8, "n8": n8, "reps": reps,
                      "decode_batch": dec_batch},
        },
    }))


if __name__ == "__main__":
    main()
