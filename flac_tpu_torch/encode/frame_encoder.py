"""The batched frame encoder, in PyTorch — the port of
flac_tpu.encode.frame_encoder.

One function encodes a whole batch of frames: the reference's per-frame
loops (stream_encoder.c:2920-3660) become tensor axes

  [B]atch of frames x [K] candidate channels (L, R, mid, side) x
  [M] model candidates (fixed orders, LPC per window) x [T] samples

reduced by the reference's strict-< argmin rules, and the bitstream is
assembled by the prefix-sum field packer (encode.packer), whose word fill is
the hand-written CUDA kernel on a GPU.

Every preset (levels 0-8, the exhaustive model search of 7-8 included),
the -p precision sweep, escape coding, and both residual datapaths
(stream_encoder.c:888): the 32-bit one, and the wide one of streams with
bps + log2(T) + 1 > 30, through two int32 limbs where they provably fit
(the 24-bit family) and int64 otherwise; the fractional final block too.
`build_frame_encoder_dense` adds the dense compaction: the batch's
frames back to back in one word stream on the device (packer's
compact_stream_words; the CUDA kernel on a GPU). The device follows the
tensors;
`build_frame_encoder` takes `device=None`, meaning CUDA (see device.py).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from flac_tpu_torch import constants as C
from flac_tpu_torch import crc as crc_mod
from flac_tpu_torch import rice
from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.dsp import fixed as dsp_fixed
from flac_tpu_torch.dsp import lpc as dsp_lpc
from flac_tpu_torch.dsp import signal as dsp_signal
from flac_tpu_torch.dsp import windows as dsp_windows
from flac_tpu_torch.dsp.bitmath import ilog2 as _ilog2
from flac_tpu_torch.encode import packer

INF_BITS = 1 << 40

_I32, _I64, _F32, _F64 = torch.int32, torch.int64, torch.float32, torch.float64


@dataclass(frozen=True)
class EncoderConfig:
    """Resolved encoder settings — the analog of FLAC__StreamEncoderProtected
    after init-time validation/defaulting (stream_encoder.c:676-735).
    A verbatim copy of flac_tpu's, plus `from_dict`."""

    channels: int = 2
    bits_per_sample: int = 16
    sample_rate: int = 44100
    blocksize: int = 4096
    do_mid_side: bool = True
    loose_mid_side: bool = False
    max_lpc_order: int = 8
    qlp_coeff_precision: int = 0  # 0 = auto (resolved in from_level/resolve)
    do_qlp_coeff_prec_search: bool = False
    do_escape_coding: bool = False
    do_exhaustive_model_search: bool = False
    min_partition_order: int = 0
    max_partition_order: int = 5
    apodizations: tuple = (("tukey", 0.5),)
    streamable_subset: bool = True
    # debug flags mirroring the reference's undocumented --disable-* options
    # (src/flac/main.c:212-218)
    disable_constant_subframes: bool = False
    disable_fixed_subframes: bool = False
    disable_verbatim_subframes: bool = False

    # Compression presets 0-8 (stream_encoder.c:120-141):
    # (do_mid_side, loose_mid_side, max_lpc_order, qlp_precision,
    #  prec_search, escape, exhaustive, min_po, max_po, search_dist)
    PRESETS = (
        (False, False, 0, 0, False, False, False, 0, 3, 0),
        (True, True, 0, 0, False, False, False, 0, 3, 0),
        (True, False, 0, 0, False, False, False, 0, 3, 0),
        (False, False, 6, 0, False, False, False, 0, 4, 0),
        (True, True, 8, 0, False, False, False, 0, 4, 0),
        (True, False, 8, 0, False, False, False, 0, 5, 0),
        (True, False, 8, 0, False, False, False, 0, 6, 0),
        (True, False, 8, 0, False, False, True, 0, 6, 0),
        (True, False, 12, 0, False, False, True, 0, 6, 0),
    )

    @classmethod
    def from_level(cls, level: int, channels: int, bits_per_sample: int,
                   sample_rate: int, blocksize: int | None = None,
                   **overrides) -> "EncoderConfig":
        ms, loose, lpc, prec, psearch, esc, exh, minpo, maxpo, _dist = cls.PRESETS[level]
        cfg = cls(channels=channels, bits_per_sample=bits_per_sample,
                  sample_rate=sample_rate,
                  blocksize=blocksize if blocksize else 0,
                  do_mid_side=ms, loose_mid_side=loose, max_lpc_order=lpc,
                  qlp_coeff_precision=prec, do_qlp_coeff_prec_search=psearch,
                  do_escape_coding=esc, do_exhaustive_model_search=exh,
                  min_partition_order=minpo, max_partition_order=maxpo)
        cfg = dataclasses.replace(cfg, **overrides)
        return cfg.resolve()

    @classmethod
    def from_dict(cls, d: dict) -> "EncoderConfig":
        """Build from `dataclasses.asdict` of a flac_tpu EncoderConfig (the
        apodization list comes back as nested tuples)."""
        d = dict(d)
        d["apodizations"] = tuple(tuple(a) for a in d["apodizations"])
        return cls(**d)

    def resolve(self) -> "EncoderConfig":
        """Init-time defaulting/validation (stream_encoder.c:660-766)."""
        c = self
        if c.channels != 2 and (c.do_mid_side or c.loose_mid_side):
            c = dataclasses.replace(c, do_mid_side=False, loose_mid_side=False)
        if not c.do_mid_side and c.loose_mid_side:
            c = dataclasses.replace(c, loose_mid_side=False)
        if c.bits_per_sample >= 32 and c.do_mid_side:
            c = dataclasses.replace(c, do_mid_side=False, loose_mid_side=False)
        if c.blocksize == 0:
            c = dataclasses.replace(c, blocksize=1152 if c.max_lpc_order == 0 else 4096)
        if not (C.MIN_BLOCK_SIZE <= c.blocksize <= C.MAX_BLOCK_SIZE):
            raise ValueError(f"invalid blocksize {c.blocksize}")
        if c.blocksize < c.max_lpc_order:
            raise ValueError("blocksize too small for LPC order")
        if c.qlp_coeff_precision == 0:
            bs, bps = c.blocksize, c.bits_per_sample
            if bps < 16:
                prec = max(C.MIN_QLP_COEFF_PRECISION, 2 + bps // 2)
            elif bps == 16:
                for lim, p in ((192, 7), (384, 8), (576, 9), (1152, 10),
                               (2304, 11), (4608, 12)):
                    if bs <= lim:
                        prec = p
                        break
                else:
                    prec = 13
            else:
                prec = (C.MAX_QLP_COEFF_PRECISION - 2 if bs <= 384
                        else C.MAX_QLP_COEFF_PRECISION - 1 if bs <= 1152
                        else C.MAX_QLP_COEFF_PRECISION)
            c = dataclasses.replace(c, qlp_coeff_precision=prec)
        if c.streamable_subset:
            if not C.blocksize_is_subset(c.blocksize, c.sample_rate):
                raise ValueError("blocksize not subset-streamable")
            if not C.sample_rate_is_subset(c.sample_rate):
                raise ValueError("sample rate not subset-streamable")
            if c.max_partition_order > C.SUBSET_MAX_RICE_PARTITION_ORDER:
                raise ValueError("partition order not subset-streamable")
            if c.sample_rate <= 48000 and (c.blocksize > C.SUBSET_MAX_BLOCK_SIZE_48000HZ
                                           or c.max_lpc_order > C.SUBSET_MAX_LPC_ORDER_48000HZ):
                raise ValueError("blocksize/LPC order not subset-streamable at <=48kHz")
        maxpo = min(c.max_partition_order, (1 << C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_ORDER_LEN) - 1)
        minpo = min(c.min_partition_order, maxpo)
        c = dataclasses.replace(c, max_partition_order=maxpo, min_partition_order=minpo)
        return c

    @property
    def rice_parameter_limit(self) -> int:
        """RICE2 escape space only for >16 bps streams (stream_encoder.c:3196)."""
        return (C.ENTROPY_CODING_METHOD_PARTITIONED_RICE2_ESCAPE_PARAMETER
                if self.bits_per_sample > 16
                else C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_ESCAPE_PARAMETER)

    @property
    def loose_mid_side_frames(self) -> int:
        """Frames between full stereo searches in loose mode (stream_encoder.c:871)."""
        q = int(self.sample_rate * 0.4 / self.blocksize + 0.5)
        return max(q, 1)


def _suggested_param(rbps: torch.Tensor, limit: int) -> torch.Tensor:
    """estimator bits/sample -> suggested Rice parameter
    (stream_encoder.c:3250-3258): trunc(rbps + 0.5) + 1, clipped to limit-1."""
    p = torch.where(rbps > 0, torch.floor(rbps.to(_F64) + 0.5), 0.0).to(_I32) + 1
    return torch.clamp(p, max=limit - 1)


def _utf8_fields(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched UTF-8-style coding of frame numbers into 7 byte fields
    (bitwriter.c:784). n: [B] int64. Returns values [B,7] int64, nbits [B,7]
    int32."""
    thresholds = torch.tensor([0x80, 0x800, 0x10000, 0x200000, 0x4000000,
                               0x80000000, 1 << 36], dtype=_I64, device=n.device)
    length = 1 + (n[:, None] >= thresholds[None, :]).sum(dim=1)  # [B] in 1..7
    one = torch.ones((), dtype=_I64, device=n.device)
    vals, bits = [], []
    for s in range(7):
        active = s < length
        if s == 0:
            # lead byte for length l in 2..6: prefix (0x100 - 2^(8-l)) | top bits
            lead_multi = torch.where(
                length == 7, 0xFE,
                (0x100 - (one << (8 - torch.clamp(length, max=6))))
                | (n >> (6 * (length - 1))))
            v = torch.where(length == 1, n, lead_multi)
        else:
            shift = 6 * (length - 1 - s)
            v = 0x80 | ((n >> torch.clamp(shift, min=0)) & 0x3F)
        vals.append(torch.where(active, v, 0))
        bits.append(torch.where(active, 8, 0).to(_I32))
    return torch.stack(vals, dim=1), torch.stack(bits, dim=1)


def _header_static_codes(cfg: EncoderConfig, blocksize: int):
    """Static frame-header code decisions (stream_encoder_framing.c:238-310)."""
    bs_code = C.FRAME_HEADER_BLOCK_SIZE_CODES.get(blocksize)
    if bs_code is not None:
        bs_ext_bits, bs_ext_val = 0, 0
    elif blocksize <= 0x100:
        bs_code, bs_ext_bits, bs_ext_val = 6, 8, blocksize - 1
    else:
        bs_code, bs_ext_bits, bs_ext_val = 7, 16, blocksize - 1
    sr = cfg.sample_rate
    sr_code = C.FRAME_HEADER_SAMPLE_RATE_CODES.get(sr)
    if sr_code is not None:
        sr_ext_bits, sr_ext_val = 0, 0
    elif sr <= 255000 and sr % 1000 == 0:
        sr_code, sr_ext_bits, sr_ext_val = 12, 8, sr // 1000
    elif sr % 10 == 0:
        sr_code, sr_ext_bits, sr_ext_val = 14, 16, sr // 10
    elif sr <= 0xFFFF:
        sr_code, sr_ext_bits, sr_ext_val = 13, 16, sr
    else:
        sr_code, sr_ext_bits, sr_ext_val = 0, 0, 0
    bps_code = C.FRAME_HEADER_BPS_CODES.get(cfg.bits_per_sample, 0)
    return bs_code, bs_ext_bits, bs_ext_val, sr_code, sr_ext_bits, sr_ext_val, bps_code


def max_frame_bytes(cfg: EncoderConfig, blocksize: int) -> int:
    """Static output-buffer bound: generous margin over the verbatim frame."""
    T, Ch = blocksize, cfg.channels
    bps = cfg.bits_per_sample + 1  # side channel
    per_ch = 64 + 33 * (cfg.max_lpc_order * 2 + 8) + T * (bps + 2) + (1 << cfg.max_partition_order) * 5
    bits = 200 + Ch * per_ch + 64
    return (bits // 8 + 256 + 3) & ~3


def _abs_plane(res: torch.Tensor, narrow: bool) -> torch.Tensor:
    """|res| of a [.., T] residual plane: int32 where the datapath bounds it
    (narrow), else int64 (the int32 |INT32_MIN| would wrap)."""
    return res.abs() if narrow else res.to(_I64).abs()


# ---------------------------------------------------------------------------


PACKER_IMPLS = ("pallas", "merged", "xla")


def resolve_packer_impl(packer_impl: str | None, device: torch.device) -> str:
    """The word-fill choice, resolved at build time so that it is part of
    the build cache's key (flipping the variable mid-process takes effect on
    the next build instead of being silently ignored).

    None reads FLAC_TPU_PACKER=pallas|merged|xla, or the legacy
    FLAC_TPU_PACK=merged; unset means "pallas". "pallas" is the banded fill
    (csrc/pack_words.cu), "merged" the merged-slot fill (the same file's
    multi kernel), "xla" the plain PyTorch fill, which serves the tests only
    and is refused on a CUDA device. On the CPU every choice runs the plain
    versions."""
    if packer_impl is None:
        packer_impl = os.environ.get("FLAC_TPU_PACKER")
        if packer_impl is None and os.environ.get("FLAC_TPU_PACK") == "merged":
            packer_impl = "merged"
        packer_impl = packer_impl or "pallas"
    if packer_impl not in PACKER_IMPLS:
        raise ValueError(f"unknown packer {packer_impl!r}; one of {PACKER_IMPLS}")
    if packer_impl == "xla" and device.type == "cuda":
        raise ValueError("the plain ('xla') word fill serves the CPU tests only; "
                         "on a CUDA device use 'pallas' or 'merged'")
    return packer_impl


def build_frame_encoder(cfg: EncoderConfig, blocksize: int | None = None,
                        device: str | torch.device | None = None,
                        packer_impl: str | None = None):
    """The encoder for a batch of equal-size frames on `device` (None: CUDA,
    which raises without a GPU). Returns fn(pcm [B, T, Ch] int, frame_numbers
    [B] int) -> (words [B, maxwords] int32, total_bits [B] int32, info dict),
    tensors on the device; inputs may be numpy arrays or tensors.

    `blocksize` overrides cfg.blocksize for the stream's final partial frame;
    `packer_impl` selects the word fill (see resolve_packer_impl).
    FLAC_TPU_WIDE=int64 is read here too (see _build_frame_encoder).
    """
    device = resolve_device(device)
    return _build_frame_encoder(cfg, blocksize, device,
                                resolve_packer_impl(packer_impl, device),
                                _wide_int64())[0]


def use_dense_packer(device: torch.device) -> bool:
    """flac_tpu's `_use_pallas_packer` rule for the dense path, read when a
    stream encoder is built: FLAC_TPU_PACKER=pallas forces it, =xla never
    takes it, and otherwise the device decides: CUDA encodes through the
    dense path (with either fill), the CPU does not."""
    forced = os.environ.get("FLAC_TPU_PACKER")
    if forced == "pallas":
        return True
    if forced == "xla":
        return False
    return device.type == "cuda"


def build_frame_encoder_dense(cfg: EncoderConfig,
                              device: str | torch.device | None = None,
                              packer_impl: str | None = None):
    """build_frame_encoder with the packed frames compacted into one dense
    word stream on the device, so that the host fetches about the
    compressed size instead of the padded word matrix. Returns fn(pcm [B,
    T, Ch] int, frame_numbers [B]) -> (stream [B*maxwords] int32 (uint32
    bits; serialize the valid prefix with packer.stream_words_to_bytes),
    total_bytes int64 scalar, total_bits [B] int32, info dict), on the
    device."""
    encode = build_frame_encoder(cfg, device=device, packer_impl=packer_impl)

    def encode_dense(pcm, frame_numbers):
        words, total_bits, info = encode(pcm, frame_numbers)
        stream, total = packer.compact_stream_words_kernel(words, total_bits)
        return stream, total, total_bits, info

    return encode_dense


def build_frame_encoder_parts(cfg: EncoderConfig, blocksize: int | None = None,
                              device: str | torch.device | None = None,
                              packer_impl: str | None = None):
    """The split form: (fields_fn, pack_fn). fields_fn(pcm, fnos) -> (values,
    nbits, info) is the candidate search + field assembly; pack_fn(values,
    nbits) -> (words, total_bits) the word fill and CRC-16."""
    device = resolve_device(device)
    return _build_frame_encoder(cfg, blocksize, device,
                                resolve_packer_impl(packer_impl, device),
                                _wide_int64())[1:]


def _wide_int64() -> bool:
    """FLAC_TPU_WIDE=int64 sends the wide datapath through int64 even where
    the two-limb residual applies, as in flac_tpu. Read at build time so
    that it is part of the build cache's key."""
    return os.environ.get("FLAC_TPU_WIDE") == "int64"


@functools.lru_cache(maxsize=64)
def _build_frame_encoder(cfg: EncoderConfig, blocksize: int | None,
                         device: torch.device, packer_impl: str,
                         wide_int64: bool):
    T = blocksize or cfg.blocksize
    is_fractional = T != cfg.blocksize
    Ch = cfg.channels
    bps_stream = cfg.bits_per_sample
    use_ms = cfg.do_mid_side and Ch == 2
    K = 4 if use_ms else Ch
    limit = cfg.rice_parameter_limit
    max_fixed = min(C.MAX_FIXED_ORDER, max(T - 1, 0))
    maxord = min(cfg.max_lpc_order, T - 1)
    # the whole fixed/constant/LPC section is gated on blocksize >= 4
    # (process_subframe_, stream_encoder.c:3206)
    do_lpc = maxord > 0 and T >= C.MAX_FIXED_ORDER
    A = len(cfg.apodizations) if do_lpc else 0
    exhaustive = cfg.do_exhaustive_model_search
    use_wide = bps_stream + (T.bit_length() - 1) + 1 > 30  # stream_encoder.c:888
    # the two-int32-limb LPC residual (dsp.lpc.lpc_residual_limbs) where its
    # limb sums provably fit int32 (the 24-bit family); the [.., T] planes
    # then stay int32 and only the reductions widen
    bps_worst = bps_stream + (1 if use_ms else 0)
    pmax = C.MAX_QLP_COEFF_PRECISION
    wide_limbs = (use_wide and bps_worst <= 25 and maxord >= 1
                  and maxord * (1 << (pmax + max(bps_worst - 14, 0))) < (1 << 31)
                  and maxord * (1 << (pmax + 11)) < (1 << 31)
                  and not wide_int64)
    # [.., T]-sized elementwise math stays int32 when the whole datapath is
    # 32-bit or the limb path bounds the values
    narrow_t = (not use_wide) or wide_limbs
    if is_fractional:
        max_po = 0
    else:
        max_po = min(C.max_rice_partition_order_from_blocksize(T), cfg.max_partition_order)
    min_po = min(cfg.min_partition_order, max_po)
    nleaf = 1 << max_po
    leafsz = max(T >> max_po, 1)
    if leafsz * nleaf != T:
        # legal blocksizes always factor as nleaf*leafsz (format.c:528)
        raise AssertionError(f"blocksize {T} does not factor into {nleaf} leaves")
    maxwarm = max(maxord, max_fixed)
    maxbytes = max_frame_bytes(cfg, T)
    maxwords = maxbytes // 4
    (bs_code, bs_ext_bits, bs_ext_val, sr_code, sr_ext_bits, sr_ext_val,
     bps_code) = _header_static_codes(cfg, T)

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    window_bank = (dev(dsp_windows.make_window_bank(cfg.apodizations, T))
                   if do_lpc else None)
    crc8_table = dev(packer.xpow_table_np(1024, crc_mod.CRC8_POLY, 8))
    _wtbl, _winv = packer.crc16_word_tables(maxwords)
    crc16_wtbl, crc16_winv = dev(_wtbl), dev(_winv)
    loose_q = cfg.loose_mid_side_frames

    bps_cand_np = np.full(K, bps_stream, np.int32)
    if use_ms:
        bps_cand_np[3] += 1  # side channel
    bps_cand = dev(bps_cand_np)
    tvec = torch.arange(T, device=device)
    one64 = dev(1, _I64)

    def mask_to(v, nbits):
        return v & ((one64 << torch.clamp(nbits.to(_I64), max=63)) - 1)

    def encode(pcm, frame_numbers):
        """Candidate search + field assembly. pcm: [B, T, Ch] int;
        frame_numbers: [B] int. Returns (values [B, F] int64, nbits [B, F]
        int32, info dict); the frame's bit count is nbits.sum(1)."""
        pcm = dev(pcm).to(_I32)
        frame_numbers = dev(frame_numbers).to(_I64)
        B = pcm.shape[0]

        # --- candidate channels -------------------------------------------
        if use_ms:
            left, right = pcm[..., 0], pcm[..., 1]
            mid, side = dsp_signal.mid_side(left, right)
            cand = torch.stack([left, right, mid, side], dim=1)  # [B, K, T]
        else:
            cand = pcm.movedim(-1, 1).contiguous()
        w = dsp_signal.wasted_bits(cand)                          # [B, K]
        x = cand >> w[..., None]
        bps_eff = bps_cand[None, :] - w                           # [B, K] int32
        pre = (8 + w).to(_I64)  # zero-pad+type+wasted-flag+unary

        # --- verbatim / constant baselines --------------------------------
        verbatim_bits = pre + T * bps_eff.to(_I64)
        if cfg.disable_verbatim_subframes and T >= C.MAX_FIXED_ORDER:
            verbatim_bits = torch.full_like(verbatim_bits, INF_BITS)
        is_const = dsp_signal.is_constant(x)
        const_ok = (T >= C.MAX_FIXED_ORDER) and not cfg.disable_constant_subframes
        const_bits = torch.where(is_const & const_ok, pre + bps_eff, INF_BITS)

        cand_bits = [verbatim_bits, const_bits]
        model_res = []      # int32 [B, K, T] residual per model candidate
        model_meta = []

        # --- fixed predictors ---------------------------------------------
        if T >= C.MAX_FIXED_ORDER and not (cfg.disable_fixed_subframes and cfg.max_lpc_order > 0):
            errs, guess_fixed = dsp_fixed.fixed_errors(x, use_wide)
            rbps_fixed = dsp_fixed.residual_bits_per_sample(errs, T - C.MAX_FIXED_ORDER)
            res_all = dsp_fixed.fixed_residuals_all_orders(x)     # [B, K, 5, T]
            orders5 = torch.arange(5, dtype=_I32, device=device)
            folded = rice.fold_residual(res_all, narrow=narrow_t)
            absres = _abs_plane(res_all, narrow_t)
            validt = tvec[None, None, None, :] >= orders5[None, None, :, None]
            absres = torch.where(validt, absres, 0)
            folded = torch.where(validt, folded, 0)
            sugg = _suggested_param(rbps_fixed, limit)
            rs = rice.rice_search(absres, folded, orders5.expand(errs.shape).to(_I32),
                                  sugg, T, min_po, max_po, limit,
                                  do_escape=cfg.do_escape_coding,
                                  compute_exact=False)
            bits = (pre[..., None] + orders5.to(_I64) * bps_eff[..., None]
                    + rs.approx_bits)
            active = orders5[None, None, :] <= max_fixed
            if not exhaustive:  # the estimator's order only
                active = active & (orders5[None, None, :] == guess_fixed[..., None])
            active = active & (rbps_fixed < bps_eff[..., None].to(_F32))
            active = active & ~is_const[..., None]
            bits = torch.where(active, bits, INF_BITS)
            for o in range(5):
                cand_bits.append(bits[..., o])
                model_res.append(res_all[..., o, :])
                model_meta.append(dict(
                    type=C.SUBFRAME_TYPE_FIXED,
                    order=torch.full((B, K), o, dtype=_I32, device=device),
                    po=rs.partition_order[..., o], params=rs.params_leaf[..., o, :],
                    raws=rs.raw_bits_leaf[..., o, :],
                    rice2=rs.is_rice2[..., o], qlp=None, prec=None, shift=None))

        # --- LPC -----------------------------------------------------------
        if do_lpc:
            xw = x.to(_F32)[:, :, None, :] * window_bank[None, None, :, :]
            autoc = dsp_lpc.autocorrelation(xw, maxord)           # [B,K,A,maxord+1]
            autoc_ok = autoc[..., 0] != 0.0
            coeffs, lerr, lvalid = dsp_lpc.levinson(autoc, maxord)
            prec0 = cfg.qlp_coeff_precision
            overhead = (bps_eff[..., None]
                        + (C.MIN_QLP_COEFF_PRECISION if cfg.do_qlp_coeff_prec_search
                           else prec0)).to(_F64)                  # [B,K,1]
            guess_lpc = dsp_lpc.compute_best_order(
                lerr, lvalid, T, overhead.expand(lerr.shape[:-1]))
            if exhaustive:  # every order 1..maxord of every window
                orders = torch.arange(1, maxord + 1, dtype=_I32, device=device
                                      ).expand(B, K, A, maxord)
            else:
                orders = guess_lpc[..., None]                     # [B,K,A,1]
            O = orders.shape[-1]
            idx = (orders - 1).long()
            err_o = torch.gather(lerr, -1, idx)
            valid_o = torch.gather(lvalid, -1, idx)
            rbps_lpc = dsp_lpc.expected_bits_per_residual_sample(
                err_o, (T - orders).to(_F64))
            sugg = _suggested_param(rbps_lpc, limit)
            ilog2_o = _ilog2(orders)
            coeff_rows = torch.gather(                            # [B,K,A,O,maxord]
                coeffs, -2, idx[..., None].expand(idx.shape + (maxord,)))
            # int32 accumulation is exact iff bps + precision + ilog2(order)
            # <= 32 (stream_encoder.c:3592), with the static worst case. Under
            # -p the per-candidate caps (stream_encoder.c:3341-3345, :3583)
            # keep that sum <= 32 whenever bps_eff <= 17.
            if cfg.do_qlp_coeff_prec_search:
                narrow_lpc = not use_wide and bps_worst <= 17
            else:
                narrow_lpc = (not use_wide
                              and (bps_worst + cfg.qlp_coeff_precision
                                   + (maxord.bit_length() - 1) <= 32))
            bps_b = bps_eff[..., None, None]
            base_active = (autoc_ok[..., None] & valid_o & ~is_const[..., None, None]
                           & (rbps_lpc < bps_b.to(_F64))
                           & (orders <= T - 1))

            def eval_precision(prec_arr):
                """Quantize, residual and Rice search at one precision per
                candidate (evaluate_lpc_subframe_, stream_encoder.c:3555-3652),
                with the bps<=16 32-bit-datapath clamp (:3583)."""
                prec_c = torch.where(bps_b <= 16,
                                     torch.minimum(prec_arr, 32 - bps_b - ilog2_o),
                                     prec_arr)
                qlp_p, shift_p, qok_p = dsp_lpc.quantize_coefficients(
                    coeff_rows, orders, prec_c, maxord)
                if wide_limbs:
                    res_p, ovf_p = dsp_lpc.lpc_residual_limbs(
                        x[:, :, None, None, :], qlp_p, orders, shift_p, maxord)
                    qok_p = qok_p & ~ovf_p
                else:
                    res_p = dsp_lpc.lpc_residual(
                        x[:, :, None, None, :], qlp_p, orders, shift_p, maxord,
                        narrow=narrow_lpc)                        # [B,K,A,O,T]
                folded_p = rice.fold_residual(res_p, narrow=narrow_t)
                absres_p = _abs_plane(res_p, narrow_t)
                validt = tvec >= orders[..., None]
                absres_p = torch.where(validt, absres_p, 0)
                folded_p = torch.where(validt, folded_p, 0)
                rs_p = rice.rice_search(absres_p, folded_p, orders, sugg, T,
                                        min_po, max_po, limit,
                                        do_escape=cfg.do_escape_coding,
                                        compute_exact=False)
                bits_p = (pre[..., None, None] + 9
                          + orders.to(_I64) * (prec_c + bps_b).to(_I64)
                          + rs_p.approx_bits)
                bits_p = torch.where(base_active & qok_p, bits_p, INF_BITS)
                return (bits_p, res_p, rs_p.partition_order, rs_p.params_leaf,
                        rs_p.raw_bits_leaf, rs_p.is_rice2, qlp_p, prec_c, shift_p)

            if cfg.do_qlp_coeff_prec_search:
                # the -p sweep (stream_encoder.c:3336-3385): every precision
                # in [MIN, MAX], capped for bps<=17 at min(32-bps-order, MAX)
                # raised back to MIN. flac_tpu's lax.scan over precisions is
                # a loop of whole-batch steps here; strict < keeps the LOWEST
                # winning precision, the reference's first strict winner.
                p_lo, p_hi = C.MIN_QLP_COEFF_PRECISION, C.MAX_QLP_COEFF_PRECISION
                maxp = torch.where(
                    bps_b <= 17,
                    torch.clamp(torch.clamp(32 - bps_b - orders, max=p_hi), min=p_lo),
                    p_hi)                                         # [B,K,A,O]
                sh = orders.shape

                def zeros(extra=(), dtype=_I32):
                    return torch.zeros(sh + extra, dtype=dtype, device=device)

                best = (torch.full(sh, INF_BITS, dtype=_I64, device=device),
                        zeros((T,)), zeros(), zeros((nleaf,)), zeros((nleaf,)),
                        zeros(dtype=torch.bool), zeros((maxord,)), zeros(), zeros())
                for p in range(p_lo, p_hi + 1):
                    cand = eval_precision(torch.full(sh, p, dtype=_I32, device=device))
                    cand = (torch.where(p <= maxp, cand[0], INF_BITS),) + cand[1:]
                    better = cand[0] < best[0]
                    best = tuple(
                        torch.where(better.reshape(sh + (1,) * (n.dim() - len(sh))), n, c)
                        for c, n in zip(best, cand))
            else:
                best = eval_precision(torch.full(orders.shape, prec0, dtype=_I32,
                                                 device=device))
            bits, res, rs_po, rs_params, rs_raws, rs_rice2, qlp, prec, shift = best
            # candidate order sets the strict-< tie-breaks: window-major, then
            # ascending order
            for a in range(A):
                for oi in range(O):
                    cand_bits.append(bits[:, :, a, oi])
                    model_res.append(res[:, :, a, oi, :])
                    model_meta.append(dict(
                        type=C.SUBFRAME_TYPE_LPC, order=orders[:, :, a, oi],
                        po=rs_po[:, :, a, oi], params=rs_params[:, :, a, oi, :],
                        raws=rs_raws[:, :, a, oi, :], rice2=rs_rice2[:, :, a, oi],
                        qlp=qlp[:, :, a, oi, :], prec=prec[:, :, a, oi],
                        shift=shift[:, :, a, oi]))

        # --- pick the best subframe per candidate channel ------------------
        # evaluation priority mirrors the reference's loop order so strict-<
        # ties resolve identically (verbatim, constant, fixed asc, lpc asc)
        n_cand = len(cand_bits)
        bits_stack = torch.stack(cand_bits, dim=-1)                # [B,K,n_cand]
        prio = torch.arange(n_cand, dtype=_I64, device=device)
        best_idx = torch.argmin(bits_stack * 256 + prio, dim=-1)   # unique keys
        best_bits_approx = torch.gather(bits_stack, -1, best_idx[..., None])[..., 0]
        # fall back to verbatim if everything is disabled/INF (stream_encoder.c:3391)
        fallback = best_bits_approx >= INF_BITS
        best_idx = torch.where(fallback, 0, best_idx)
        best_bits_approx = torch.where(fallback, pre + T * bps_eff.to(_I64),
                                       best_bits_approx)
        midx = best_idx - 2  # < 0 for verbatim/constant (no model selected)

        def gather_meta(key, default, dtype, extra_shape=()):
            # where-chain over the model candidates (slots with midx < 0 get
            # `default`; every consumer masks them out)
            out = torch.full((B, K) + extra_shape, default, dtype=dtype, device=device)
            sel_shape = (B, K) + (1,) * len(extra_shape)
            for i, m in enumerate(model_meta):
                v = m[key]
                if v is None:
                    continue
                v = torch.as_tensor(v, dtype=dtype, device=device)
                out = torch.where((midx == i).reshape(sel_shape),
                                  v.expand((B, K) + extra_shape), out)
            return out

        is_model = best_idx >= 2
        sel_type = torch.where(
            best_idx == 0, C.SUBFRAME_TYPE_VERBATIM,
            torch.where(best_idx == 1, C.SUBFRAME_TYPE_CONSTANT,
                        gather_meta("type", 0, _I32)))
        sel_order = torch.where(is_model, gather_meta("order", 0, _I32), 0)
        sel_po = torch.where(is_model, gather_meta("po", 0, _I32), 0)
        sel_params = gather_meta("params", 0, _I32, (nleaf,))
        sel_raws = (gather_meta("raws", 0, _I32, (nleaf,))
                    if cfg.do_escape_coding else None)
        sel_rice2 = is_model & gather_meta("rice2", False, torch.bool)
        sel_qlp = gather_meta("qlp", 0, _I32, (maxord,) if maxord else (1,))
        sel_prec = gather_meta("prec", 0, _I32)
        sel_shift = gather_meta("shift", 0, _I32)
        sel_res = torch.zeros((B, K, T), dtype=_I32, device=device)
        for i, r in enumerate(model_res):
            sel_res = torch.where((midx == i)[..., None], r, sel_res)

        # exact residual-coding bits, one [B,K,T] pass for the selection
        sel_folded = rice.fold_residual(sel_res, narrow=narrow_t)
        sel_exact_res = rice.rice_exact_bits(sel_folded, sel_params, sel_raws,
                                             sel_order, sel_po, T, max_po)
        is_lpc_sel = sel_type == C.SUBFRAME_TYPE_LPC
        hdr_extra = torch.where(is_lpc_sel, 9, 0).to(_I64)
        body = torch.where(
            sel_type == C.SUBFRAME_TYPE_VERBATIM, T * bps_eff.to(_I64),
            torch.where(sel_type == C.SUBFRAME_TYPE_CONSTANT, bps_eff.to(_I64),
                        sel_order.to(_I64)
                        * (bps_eff + torch.where(is_lpc_sel, sel_prec, 0)).to(_I64)
                        + sel_exact_res))
        sel_exact_bits = pre + hdr_extra + body                   # [B,K]

        # --- channel assignment -------------------------------------------
        rows = torch.arange(B, device=device)
        if use_ms:
            bL, bR, bM, bS = (best_bits_approx[:, i] for i in range(4))
            assign_bits = torch.stack([bL + bR, bL + bS, bR + bS, bM + bS], dim=1)
            searched = torch.argmin(assign_bits, dim=1).to(_I32)  # first on ties
            if cfg.loose_mid_side:
                is_search = (frame_numbers % loose_q) == 0
                anchor = (torch.div(frame_numbers, loose_q, rounding_mode="floor")
                          * loose_q - frame_numbers[0])
                anchor = torch.clamp(anchor, 0, B - 1)
                anchor_assign = searched[anchor]
                reuse = torch.where(anchor_assign == C.CHANNEL_ASSIGNMENT_INDEPENDENT,
                                    C.CHANNEL_ASSIGNMENT_INDEPENDENT,
                                    C.CHANNEL_ASSIGNMENT_MID_SIDE).to(_I32)
                ca = torch.where(is_search, searched, reuse)
            else:
                ca = searched
            src0 = dev([0, 0, 3, 2], _I64)[ca.long()]
            src1 = dev([1, 3, 1, 3], _I64)[ca.long()]
            ch_srcs = [src0, src1]
            # INDEPENDENT -> channels-1; LS/RS/MS -> 8/9/10 (framing.c:292-310)
            ca_code = torch.where(ca == 0, Ch - 1, 7 + ca)
        else:
            ca = torch.zeros(B, dtype=_I32, device=device)
            ch_srcs = [torch.full((B,), c, dtype=_I64, device=device)
                       for c in range(Ch)]
            ca_code = torch.full((B,), Ch - 1, dtype=_I32, device=device)

        # --- assemble fields ----------------------------------------------
        values_blocks, nbits_blocks = [], []

        def add(v, n):
            values_blocks.append(v.to(_I64))
            nbits_blocks.append(n.to(_I32))

        def full_col(val):
            return torch.full((B, 1), val, dtype=_I64, device=device)

        # header: one combined 32-bit field, UTF-8 number, extensions, CRC-8
        f0 = ((C.FRAME_HEADER_SYNC << 18) | (bs_code << 12) | (sr_code << 8)
              | (bps_code << 1))
        add(full_col(f0) | (ca_code.to(_I64)[:, None] << 4), full_col(32))
        add(*_utf8_fields(frame_numbers))
        add(full_col(bs_ext_val), full_col(bs_ext_bits))
        add(full_col(sr_ext_val), full_col(sr_ext_bits))
        crc8_slot = sum(v.shape[1] for v in values_blocks)  # the CRC-8 field
        add(full_col(0), full_col(8))

        for src in ch_srcs:
            def g(arr):
                return arr[rows, src]
            c_type = g(sel_type)
            c_order = g(sel_order).to(_I64)
            c_w = g(w).to(_I64)
            c_bps = g(bps_eff).to(_I64)
            c_x = g(x).to(_I64)                                   # [B,T]
            c_po = g(sel_po)
            c_params = g(sel_params)                              # [B,nleaf]
            c_rice2 = g(sel_rice2)
            c_qlp = g(sel_qlp).to(_I64)
            c_prec = g(sel_prec).to(_I64)
            c_shift = g(sel_shift).to(_I64)
            c_res = g(sel_res)                                    # [B,T]
            c_folded = torch.where(tvec >= c_order[:, None],
                                   rice.fold_residual(c_res), 0)

            is_fixed = c_type == C.SUBFRAME_TYPE_FIXED
            is_lpc = c_type == C.SUBFRAME_TYPE_LPC
            is_verb = c_type == C.SUBFRAME_TYPE_VERBATIM
            is_cst = c_type == C.SUBFRAME_TYPE_CONSTANT
            is_coded = is_fixed | is_lpc

            hdr = torch.where(
                is_cst, C.SUBFRAME_TYPE_CONSTANT_BYTE_ALIGNED_MASK,
                torch.where(is_verb, C.SUBFRAME_TYPE_VERBATIM_BYTE_ALIGNED_MASK,
                            torch.where(is_fixed,
                                        C.SUBFRAME_TYPE_FIXED_BYTE_ALIGNED_MASK | (c_order << 1),
                                        C.SUBFRAME_TYPE_LPC_BYTE_ALIGNED_MASK | ((c_order - 1) << 1))))
            hdr = hdr | (c_w > 0).to(_I64)
            add(hdr[:, None], full_col(8))
            # wasted unary: (w-1) zeros + stop bit == w bits, value 1
            add(torch.where(c_w > 0, 1, 0)[:, None], c_w[:, None])
            # constant value
            add(mask_to(c_x[:, :1], c_bps[:, None]) * is_cst[:, None],
                torch.where(is_cst, c_bps, 0)[:, None])
            # warmup samples
            if maxwarm:
                jw = torch.arange(maxwarm, device=device)
                warm_active = is_coded[:, None] & (jw[None, :] < c_order[:, None])
                wv = mask_to(c_x[:, :maxwarm], c_bps[:, None])
                add(torch.where(warm_active, wv, 0),
                    torch.where(warm_active, c_bps[:, None], 0))
            # lpc precision/shift/coeffs
            add(torch.where(is_lpc, c_prec - 1, 0)[:, None],
                torch.where(is_lpc, 4, 0)[:, None])
            add(torch.where(is_lpc, c_shift, 0)[:, None],
                torch.where(is_lpc, 5, 0)[:, None])
            if maxord:
                jo = torch.arange(maxord, device=device)
                co_active = is_lpc[:, None] & (jo[None, :] < c_order[:, None])
                cv = mask_to(c_qlp[:, :maxord], c_prec[:, None])
                add(torch.where(co_active, cv, 0),
                    torch.where(co_active, c_prec[:, None], 0))
            # entropy coding method header: 2-bit type + 4-bit partition order
            ecm = (c_rice2.to(_I64) << 4) | c_po.to(_I64)
            add(torch.where(is_coded, ecm, 0)[:, None],
                torch.where(is_coded, 6, 0)[:, None])
            # Rice fields: one parameter slot per leaf, then its codewords:
            # [leaf0 param, leaf0 codewords..., leaf1 param, ...]
            ps = torch.full((B,), T, dtype=_I64, device=device) >> c_po.to(_I64)
            plen = torch.where(c_rice2, 5, 4).to(_I32)
            leaf_start = torch.arange(nleaf, dtype=_I64, device=device) * leafsz
            at_boundary = (leaf_start[None, :] % ps[:, None]) == 0   # [B, nleaf]
            k_leaf = c_params.to(_I64)                            # [B, nleaf]
            k_t = k_leaf[:, :, None].expand(B, nleaf, leafsz).reshape(B, T)
            param_n = torch.where(is_coded[:, None] & at_boundary, plen[:, None], 0)
            param_v = torch.where(param_n > 0, k_leaf, 0)
            cw_n_coded = (c_folded >> k_t) + 1 + k_t
            cw_v_coded = (one64 << k_t) | (c_folded & ((one64 << k_t) - 1))
            if cfg.do_escape_coding:
                # an escaped partition: the boundary field becomes <escape
                # parameter><5-bit raw length>, and every codeword is the
                # residual at the raw width (stream_encoder_framing.c:478-537)
                raw_leaf = g(sel_raws).to(_I64)                   # [B, nleaf]
                raw_t = raw_leaf[:, :, None].expand(B, nleaf, leafsz).reshape(B, T)
                esc_t = raw_t > 0
                pesc_c = torch.where(
                    c_rice2, C.ENTROPY_CODING_METHOD_PARTITIONED_RICE2_ESCAPE_PARAMETER,
                    C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_ESCAPE_PARAMETER
                ).to(_I64)[:, None]
                esc_leaf = raw_leaf > 0
                param_n = torch.where(param_n > 0,
                                      torch.where(esc_leaf, param_n + 5, param_n), 0)
                param_v = torch.where(param_n > 0,
                                      torch.where(esc_leaf, (pesc_c << 5) | raw_leaf,
                                                  k_leaf), 0)
                cw_n_coded = torch.where(esc_t, raw_t, cw_n_coded)
                cw_v_coded = torch.where(esc_t, mask_to(c_res.to(_I64), raw_t),
                                         cw_v_coded)
            coded_t = is_coded[:, None] & (tvec[None, :] >= c_order[:, None])
            cw_n = torch.where(coded_t, cw_n_coded,
                               torch.where(is_verb[:, None], c_bps[:, None], 0))
            cw_v = torch.where(coded_t, cw_v_coded,
                               torch.where(is_verb[:, None],
                                           mask_to(c_x, c_bps[:, None]), 0))
            inter_v = torch.cat([param_v[:, :, None], cw_v.reshape(B, nleaf, leafsz)],
                                dim=2).reshape(B, nleaf * (1 + leafsz))
            inter_n = torch.cat([param_n[:, :, None].to(_I32),
                                 cw_n.reshape(B, nleaf, leafsz).to(_I32)],
                                dim=2).reshape(B, nleaf * (1 + leafsz))
            add(inter_v, inter_n)

        # tail: byte-align pad + CRC-16
        values = torch.cat(values_blocks, dim=1)
        nbits = torch.cat(nbits_blocks, dim=1)
        bits_so_far = nbits.to(_I64).sum(dim=1)
        pad_bits = ((8 - (bits_so_far & 7)) & 7).to(_I32)
        values = torch.cat([values, torch.zeros((B, 2), dtype=_I64, device=device)], dim=1)
        nbits = torch.cat([nbits, pad_bits[:, None],
                           torch.full((B, 1), 16, dtype=_I32, device=device)], dim=1)

        # CRC-8 over the header bytes (the few fields before the crc8 slot)
        ends = torch.cumsum(nbits[:, :crc8_slot], dim=1, dtype=_I32)
        hdr_msg_end = ends[:, -1]  # the CRC-8 message ends where its field starts
        crc8_val = packer.crc_reduce(values[:, :crc8_slot], ends, hdr_msg_end,
                                     torch.ones((1, crc8_slot), dtype=torch.bool,
                                                device=device),
                                     crc8_table, crc_mod.CRC8_POLY, 8)
        values[:, crc8_slot] = crc8_val
        info = dict(assignment=ca, subframe_type=sel_type, order=sel_order,
                    partition_order=sel_po, wasted=w,
                    exact_subframe_bits=sel_exact_bits)
        return values.contiguous(), nbits.contiguous(), info

    merged = packer_impl == "merged"

    def pack(values, nbits):
        """Word fill + CRC-16 from the packed words: one CUDA kernel launch
        for CUDA tensors, the plain composition for CPU tensors (where
        "pallas" and "xla" are the same plain banded fill)."""
        return packer.pack_frames_kernel(values, nbits, maxwords, crc16_wtbl,
                                         crc16_winv, merged)

    def full(pcm, frame_numbers):
        values, nbits, info = encode(pcm, frame_numbers)
        words, total_bits = pack(values, nbits)
        return words, total_bits, dict(info, frame_bits=total_bits)

    return full, encode, pack
