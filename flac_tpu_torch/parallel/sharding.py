"""Frame-sharded encoding and decoding over torch.distributed — the port of
flac_tpu.parallel.sharding.

FLAC frames are self-contained: predictor warm-up samples live inside each
subframe and prediction history never crosses a frame boundary (reference
format.h:304-331, stream_encoder.c:3515), so the frame-batch axis is
data-parallel. What is NOT local:

* STREAMINFO statistics (min/max frame size, total bytes): min/max/sum
  all-reduces over the mesh (the reference tracks these serially in
  write_frame_, stream_encoder.c:2418-2421).
* Frame placement in the output stream: an exclusive prefix sum of per-frame
  encoded byte lengths. Locally a cumsum; across shards an all-gather of
  per-shard totals and a masked sum (a two-level scan).
* The ordered byte stream and the MD5: sequential, on the host (the corpus
  function writes the gathered frames in frame order by their collective
  offsets).

The model is SPMD: one process a rank, and every rank calls the same
function with the same arguments. The mesh is 2-D ('host', 'chip'), as
flac_tpu's: rank r = host * chips + chip holds frames [r * fpd, (r + 1) *
fpd) of each global batch, which is JAX's P(("host", "chip")) on axis 0.
Collectives reduce over 'chip', then over 'host'.

Each collective takes tensors on the device that its group's backend serves:
CUDA tensors for NCCL, CPU tensors for gloo. The step moves its few int64
statistics there itself; a tensor on another device raises, and nothing
switches backend or device on its own.

`collective_calls` and `collective_bytes` count the encode step's
collectives (the statistics and the placement) and the bytes they return on
this rank; `payload_calls` and `payload_bytes` count the corpus functions'
gathers of frame rows. They are this process's counts, as the kernels count
their launches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.encode.frame_encoder import (
    EncoderConfig, build_frame_encoder_parts, encode_tail)

collective_calls = 0
collective_bytes = 0
payload_calls = 0
payload_bytes = 0

# the device whose tensors each backend's collectives carry
_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """`device=None` is this rank's card, cuda:{LOCAL_RANK % device_count},
    and raises without a GPU (resolve_device's rule); else the device given."""
    dev = resolve_device(device)
    if device is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def make_mesh(device_type: str | None = None, n_hosts: int | None = None) -> DeviceMesh:
    """A ('host', 'chip') mesh over every rank of the process group that is
    already initialized. `device_type=None` means CUDA (which raises without
    a GPU). As in flac_tpu, `n_hosts` defaults to 2 when the world size is
    even and at least 2, so that both mesh axes run their collectives."""
    kind = "cuda" if device_type is None else torch.device(device_type).type
    dev = rank_device(None if kind == "cuda" else kind)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialize the process group first "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n_hosts is None:
        n_hosts = 2 if n % 2 == 0 and n >= 2 else 1
    if n % n_hosts:
        raise ValueError(f"{n} ranks not divisible into {n_hosts} hosts")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (n_hosts, n // n_hosts),
                            mesh_dim_names=("host", "chip"))


@dataclass
class ShardedEncodeResult:
    """Outputs of one sharded encode step: this rank's rows, and the global
    statistics."""

    words: torch.Tensor          # [fpd, maxwords] int32 — packed big-endian frame words
    nbytes: torch.Tensor         # [fpd] int64 — encoded byte length per frame
    stream_offset: torch.Tensor  # [fpd] int64 — exclusive prefix sum of nbytes, global
    min_framesize: torch.Tensor  # [] int64 — global min (STREAMINFO)
    max_framesize: torch.Tensor  # [] int64 — global max (STREAMINFO)
    total_bytes: torch.Tensor    # [] int64 — global sum
    assignment: torch.Tensor     # [fpd] int32 — chosen channel assignment


class _Mesh:
    """The mesh as the collectives use it: its two groups, this rank's flat
    index in frame order, and the device the groups' backend carries."""

    def __init__(self, mesh: DeviceMesh, device: torch.device):
        if tuple(mesh.mesh_dim_names or ()) != ("host", "chip"):
            raise ValueError(f"expected a ('host', 'chip') mesh, got {mesh.mesh_dim_names}")
        self.host, self.chip = mesh.get_group("host"), mesh.get_group("chip")
        self.size = mesh.size()
        self.index = mesh.get_local_rank("host") * mesh.size(1) + mesh.get_local_rank("chip")
        backends = {dist.get_backend(g) for g in (self.host, self.chip)}
        if len(backends) != 1 or next(iter(backends)) not in _BACKEND_DEVICE:
            raise ValueError(f"mesh groups on backends {sorted(backends)}: "
                             f"expected one of {sorted(_BACKEND_DEVICE)}")
        kind = _BACKEND_DEVICE[backends.pop()]
        if kind == "cuda" and device.type != "cuda":
            raise ValueError(f"an NCCL mesh carries CUDA tensors; the step runs on {device}")
        self.device = device if kind == "cuda" else torch.device("cpu")

    def _check(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"collective on {self.device.type} tensors given a "
                             f"tensor on {t.device}")

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """`t` reduced in place over 'chip', then over 'host'."""
        global collective_calls, collective_bytes
        self._check(t)
        for g in (self.chip, self.host):
            dist.all_reduce(t, op=op, group=g)
            collective_calls += 1
            collective_bytes += t.numel() * t.element_size()
        return t

    def all_gather(self, t: torch.Tensor, payload: bool = False) -> torch.Tensor:
        """[mesh.size, *t.shape]: every rank's `t` in frame order, gathered
        over 'chip', then over 'host' (row-major: host-major)."""
        global collective_calls, collective_bytes, payload_calls, payload_bytes
        self._check(t)
        for g in (self.chip, self.host):
            parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, t.contiguous(), group=g)
            t = torch.stack(parts)
            if payload:
                payload_calls += 1
                payload_bytes += t.numel() * t.element_size()
            else:
                collective_calls += 1
                collective_bytes += t.numel() * t.element_size()
        return t.reshape(self.size, *t.shape[2:])


def build_sharded_encode_step(cfg: EncoderConfig, mesh: DeviceMesh,
                              frames_per_device: int,
                              device: str | torch.device | None = None):
    """Returns `step(pcm [fpd, T, Ch], frame_numbers [fpd]) ->
    ShardedEncodeResult` for this rank's block of frames (rank r holds
    frames [r * fpd, (r + 1) * fpd) of the global batch; frame numbers are
    global). Every rank of the mesh calls it together: the fields stage and
    the pack run on this rank's device, the STREAMINFO statistics and the
    two-level length prefix sum ride the mesh's collectives."""
    if frames_per_device < 1:
        raise ValueError(f"frames_per_device must be at least 1, got {frames_per_device}")
    device = rank_device(device)
    cfg = cfg.resolve()
    fields_fn, pack_fn = build_frame_encoder_parts(cfg, device=device)
    m = _Mesh(mesh, device)

    def step(pcm, frame_numbers) -> ShardedEncodeResult:
        pcm = torch.as_tensor(pcm, device=device)
        if pcm.shape[0] != frames_per_device:
            raise ValueError(f"step takes {frames_per_device} frames, got {pcm.shape[0]}")
        # the frame's total bit count is the field nbits sum (pad and CRC-16
        # fields included): the placement comes from the fields, not from
        # the pack, whose launch runs on while the collectives do
        values, nbits, info = fields_fn(pcm, frame_numbers)
        words, _total_bits = pack_fn(values, nbits)
        nbytes = (nbits.to(torch.int64).sum(dim=1) + 7) // 8

        # global STREAMINFO statistics
        stats = torch.stack([nbytes.min(), nbytes.max(), nbytes.sum()]).to(m.device)
        min_fs = m.all_reduce(stats[0:1].clone(), dist.ReduceOp.MIN)
        max_fs = m.all_reduce(stats[1:2].clone(), dist.ReduceOp.MAX)
        total = m.all_reduce(stats[2:3].clone(), dist.ReduceOp.SUM)

        # two-level exclusive prefix sum: the local exclusive cumsum plus the
        # totals of the shards before this one
        shard_totals = m.all_gather(stats[2:3]).reshape(-1)
        preceding = shard_totals[:m.index].sum()
        offsets = torch.cumsum(nbytes, 0) - nbytes + preceding.to(device)
        return ShardedEncodeResult(
            words=words, nbytes=nbytes, stream_offset=offsets,
            min_framesize=min_fs[0], max_framesize=max_fs[0], total_bytes=total[0],
            assignment=info["assignment"])

    return step


def encode_frames_sharded(pcm: np.ndarray, cfg: EncoderConfig,
                          mesh: DeviceMesh | None = None,
                          first_frame_number: int = 0,
                          device: str | torch.device | None = None) -> ShardedEncodeResult:
    """Convenience: every rank passes the same [B, T, Ch] PCM and gets its
    own rows' result. B must be divisible by the mesh size."""
    device = rank_device(device)
    if mesh is None:
        mesh = make_mesh(device.type)
    B = pcm.shape[0]
    if B % mesh.size():
        raise ValueError(f"batch {B} not divisible by mesh size {mesh.size()}")
    fpd = B // mesh.size()
    step = build_sharded_encode_step(cfg, mesh, fpd, device)
    r = _Mesh(mesh, device).index
    fnos = np.arange(first_frame_number + r * fpd, first_frame_number + (r + 1) * fpd,
                     dtype=np.int64)
    return step(pcm[r * fpd:(r + 1) * fpd], fnos)


def encode_corpus_sharded(pcm, cfg: EncoderConfig, mesh: DeviceMesh | None = None,
                          metadata: list | None = None, do_md5: bool = True,
                          frames_per_device: int = 16,
                          device: str | torch.device | None = None) -> bytes:
    """One-call multi-rank encode of a whole corpus -> a complete .flac,
    returned on every rank.

    Every rank passes the same `pcm`: one [n, channels] int32 array, or a
    list of ragged chunks (an arbitrary, non-frame-aligned split of the
    corpus), which are concatenated and re-cut on the frame grid: samples
    cross shard boundaries, never codec state.

    Per sharded step every rank encodes its block of frames, the mesh runs
    the min/max/sum all-reduces and the two-level prefix sum, and every
    rank's word rows, byte lengths and offsets are gathered to every rank.
    The host then does only the sequential work: the frames written in
    frame order by their collective offsets, the final partial frame, MD5,
    and STREAMINFO (update_metadata_, stream_encoder.c:2516).
    """
    from flac_tpu_torch import constants as C
    from flac_tpu_torch.md5 import MD5Context
    from flac_tpu_torch.metadata import StreamInfo, VorbisComment, serialize_metadata
    from flac_tpu_torch.version import VENDOR_STRING

    device = rank_device(device)
    if isinstance(pcm, (list, tuple)):
        # concatenating IS the re-cut: the samples a raw split bisected out
        # of a frame move to the shard that owns that frame
        pcm = np.concatenate([np.asarray(c) for c in pcm], axis=0)
    pcm = np.asarray(pcm, np.int32)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    if mesh is None:
        mesh = make_mesh(device.type)
    cfg = cfg.resolve()
    bs, ch = cfg.blocksize, cfg.channels
    if pcm.shape[1] != ch:
        raise ValueError(f"PCM has {pcm.shape[1]} channels, the config {ch}")
    n = pcm.shape[0]
    nfull, rem = divmod(n, bs)

    step = build_sharded_encode_step(cfg, mesh, frames_per_device, device)
    m = _Mesh(mesh, device)
    fpd = frames_per_device
    B = fpd * m.size
    frames = pcm[: nfull * bs].reshape(nfull, bs, ch)

    payload = bytearray()
    min_fs, max_fs = (1 << 31) - 1, 0
    for start in range(0, nfull, B):
        batch = frames[start : start + B]
        nb = batch.shape[0]
        if nb < B:  # pad AFTER the real frames; pads drop out of the stream
            batch = np.concatenate([batch, np.repeat(batch[-1:], B - nb, axis=0)], axis=0)
        lo = m.index * fpd
        res = step(batch[lo:lo + fpd], np.arange(start + lo, start + lo + fpd, dtype=np.int64))
        rows = m.all_gather(res.words.to(m.device), payload=True)
        place = m.all_gather(torch.stack([res.nbytes, res.stream_offset], 1).to(m.device),
                             payload=True)
        words = rows.reshape(B, -1).cpu().numpy().view(np.uint32).astype(">u4")
        nbytes, offs = place.reshape(B, 2).cpu().numpy().T
        # host-ordered write by the collective prefix-sum placement
        total_real = int(offs[nb - 1] + nbytes[nb - 1])
        chunk = bytearray(total_real)
        for i in range(nb):
            chunk[offs[i] : offs[i] + nbytes[i]] = words[i].tobytes()[: nbytes[i]]
        payload += chunk
        min_fs = min(min_fs, int(nbytes[:nb].min()))
        max_fs = max(max_fs, int(nbytes[:nb].max()))
    if rem:
        words, total_bits, _ = encode_tail(cfg, pcm[nfull * bs :], nfull, device)
        tail = words[0].cpu().numpy().view(np.uint32).astype(">u4").tobytes()[
            : int(total_bits[0]) // 8]
        payload += tail
        min_fs = min(min_fs, len(tail))
        max_fs = max(max_fs, len(tail))

    md5 = b"\x00" * 16
    if do_md5:
        ctx = MD5Context()
        ctx.accumulate(pcm, cfg.bits_per_sample)
        md5 = ctx.digest()
    si = StreamInfo(min_blocksize=bs, max_blocksize=bs,
                    min_framesize=0 if n == 0 else min_fs,
                    max_framesize=max_fs, sample_rate=cfg.sample_rate,
                    channels=ch, bits_per_sample=cfg.bits_per_sample,
                    total_samples=n, md5sum=md5)
    blocks = [si] + list(metadata or [])
    if not any(isinstance(b, VorbisComment) for b in blocks):
        blocks.insert(1, VorbisComment(vendor_string=VENDOR_STRING))
    return C.STREAM_SYNC_STRING + serialize_metadata(blocks) + bytes(payload)


def build_sharded_decode_step(geom, mesh: DeviceMesh, frames_per_device: int,
                              device: str | torch.device | None = None):
    """Frame-sharded decode: `step(words [W], start_bits [fpd]) -> (pcm
    [fpd, T, Ch], end_bits [fpd], overflow [fpd])` for this rank's block of
    frames, on this rank's device. Every rank holds the whole word stream
    (replicated) and each frame reads its own bit window, so the step has no
    collectives. `overflow` marks frames whose bitstream left the batched
    kernel's domain: the caller decodes those again on the host."""
    from flac_tpu_torch.decode.frame_decoder import build_frame_decoder

    device = rank_device(device)
    _Mesh(mesh, device)  # the mesh must be one this device's collectives can use
    decode = build_frame_decoder(geom, device)

    def step(words, start_bits):
        if len(start_bits) != frames_per_device:
            raise ValueError(f"step takes {frames_per_device} frames, got {len(start_bits)}")
        pcm, ends, meta = decode(words, start_bits)
        return pcm, ends, meta["unary_overflow"]

    return step


def decode_corpus_sharded(data: bytes, mesh: DeviceMesh | None = None,
                          frames_per_device: int = 16,
                          max_lpc_order: int = 32,
                          check_md5: bool = True,
                          device: str | torch.device | None = None) -> np.ndarray:
    """One-call multi-rank decode of a whole .flac stream -> PCM, returned on
    every rank.

    The decode mirror of encode_corpus_sharded: the host does the sequential
    work (metadata parse, the vectorized frame index, the final partial
    frame, MD5), and every indexed frame decodes on its rank in
    frame-sharded batches whose PCM rows are gathered to every rank. Strict:
    any CRC-16 mismatch, frame-length overrun, or MD5 failure raises
    (concealment and resync live in decode_bytes_device / HostDecoder,
    reference stream_decoder.c:2106). Frames the batched kernel flags as
    out of its domain decode again on the host, as in the single-device
    stream decoder.
    """
    from flac_tpu_torch.decode import host_decoder as hd
    from flac_tpu_torch.decode.frame_decoder import DecoderGeometry, bytes_to_words
    from flac_tpu_torch.decode.stream import (StreamDecodeError, check_frame_crc16,
                                              index_frames)
    from flac_tpu_torch.md5 import MD5Context
    from flac_tpu_torch.metadata import StreamInfo, parse_metadata

    device = rank_device(device)
    if mesh is None:
        mesh = make_mesh(device.type)
    data = bytes(data)
    d = np.frombuffer(data, np.uint8)
    pos = hd.skip_id3v2(data, 0)
    if data[pos:pos + 4] != b"fLaC":
        raise hd.DecodeError("missing fLaC stream marker")
    metadata, audio_offset = parse_metadata(data, pos + 4)
    si = metadata[0]
    if not isinstance(si, StreamInfo):
        raise hd.DecodeError("first metadata block is not STREAMINFO")
    if si.min_blocksize != si.max_blocksize:
        raise StreamDecodeError("variable-blocksize stream: use decode_bytes_device")
    offsets = index_frames(d, audio_offset, si)
    if offsets is None:
        raise StreamDecodeError("ambiguous frame index: use decode_bytes_device")
    geom = DecoderGeometry(blocksize=si.min_blocksize, channels=si.channels,
                           bits_per_sample=si.bits_per_sample,
                           sample_rate=si.sample_rate,
                           max_lpc_order=max_lpc_order)
    step = build_sharded_decode_step(geom, mesh, frames_per_device, device)
    m = _Mesh(mesh, device)
    fpd = frames_per_device
    B = fpd * m.size
    words = torch.as_tensor(bytes_to_words(d, bucket=True), device=device)
    nfr = len(offsets)
    host = None
    pcm_parts = []
    ends_all = np.zeros(nfr, np.int64)
    for s in range(0, nfr, B):
        batch_off = offsets[s:s + B]
        nb = len(batch_off)
        if nb < B:
            batch_off = np.concatenate([batch_off, np.repeat(batch_off[-1:], B - nb)])
        lo = m.index * fpd
        pcm, ends, ovf = step(words, batch_off[lo:lo + fpd] * 8)
        pcm = m.all_gather(pcm.to(torch.int32).to(m.device), payload=True)
        ends_ovf = m.all_gather(torch.stack([ends, ovf.to(torch.int64)], 1).to(m.device),
                                payload=True)
        pcm = pcm.reshape(B, *pcm.shape[2:]).cpu().numpy()[:nb]
        ends_np, ovf_np = ends_ovf.reshape(B, 2).cpu().numpy()[:nb].T
        ends_np = ends_np // 8
        for i in np.flatnonzero(ovf_np):
            if host is None:
                host = hd.HostDecoder(data, check_md5=False)
            fpcm, fi = host.decode_frame_at(int(batch_off[i]))
            pcm[i] = fpcm.reshape(pcm[i].shape)
            ends_np[i] = fi.offset + fi.size
        ends_all[s:s + nb] = ends_np
        pcm_parts.append(pcm.reshape(-1, si.channels))
    pcm = (np.concatenate(pcm_parts, axis=0) if pcm_parts
           else np.zeros((0, si.channels), np.int32))
    if nfr:
        if np.any(ends_all[:-1] > offsets[1:]) or ends_all[-1] > len(d):
            raise StreamDecodeError("frame length overrun — corrupt stream?")
        bad = check_frame_crc16(data, d, offsets, ends_all)
        if len(bad):
            raise hd.DecodeError(f"frame CRC-16 mismatch in frame(s) {bad[:5].tolist()}")
    # the final partial frame (not in the index) decodes on the host
    tail_start = int(ends_all[-1]) if nfr else audio_offset
    if tail_start < len(d) - 2:
        host = hd.HostDecoder(data, check_md5=False)
        try:
            tail_pcm, _fi = host.decode_frame_at(tail_start)
            pcm = np.concatenate([pcm, tail_pcm], axis=0)
        except (hd.DecodeError, EOFError):
            pass  # trailing garbage/padding
    if si.total_samples and len(pcm) > si.total_samples:
        pcm = pcm[: si.total_samples]
    if check_md5 and si.md5sum != b"\x00" * 16:
        md5 = MD5Context()
        md5.accumulate(pcm, si.bits_per_sample)
        if md5.digest() != si.md5sum:
            raise hd.DecodeError("MD5 signature mismatch")
    return pcm
