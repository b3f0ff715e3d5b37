"""ReplayGain analysis, tag storage, and synthesis — the port of
flac_tpu.replaygain.

The analog of src/share/replaygain_analysis (the reference ReplayGain
implementation: yulewalk+Butterworth equal-loudness IIR cascade, 50 ms
windowed RMS, 0.01 dB histogram, 95th-percentile statistic —
replaygain_analysis.c:265,326,347,436-481), src/share/grabbag/replaygain.c
(tag computation/storage over file sets) and src/share/replaygain_synthesis
(gain application with hard 6 dB tanh limiting and dither for the decoder's
--apply-replaygain option).

The IIR cascade is `equal_loudness` for one title and
`equal_loudness_album` for an album: on CUDA tensors one launch of the hand
kernel csrc/iir_scan.cu (both stages, one thread block a channel) for a
title or for a whole album (`compute_replay_gain` hands it groups of
titles under LAUNCH_BYTES), on CPU tensors the plain `iir_filter` twice a
title. The window statistics stay on the host in numpy, as in flac_tpu, on
the filtered signal copied back once a title, so the gain depends only on
the filter's output.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.kernels import iir_scan
from flac_tpu_torch.metadata import MetadataChain, VorbisComment, get_tags
from flac_tpu_torch.replaygain.coefficients import (
    A_BUTTER,
    A_YULE,
    B_BUTTER,
    B_YULE,
    SAMPLE_RATES,
)

REFERENCE_LOUDNESS = 89.0  # dB SPL
PINK_REF = 64.82
STEPS_PER_DB = 100.0
MAX_DB = 120.0
RMS_PERCENTILE = 0.95
RMS_WINDOW_TIME_MS = 50
YULE_ORDER = 10
BUTTER_ORDER = 2

TAG_REFERENCE_LOUDNESS = "REPLAYGAIN_REFERENCE_LOUDNESS"
TAG_TITLE_GAIN = "REPLAYGAIN_TRACK_GAIN"
TAG_TITLE_PEAK = "REPLAYGAIN_TRACK_PEAK"
TAG_ALBUM_GAIN = "REPLAYGAIN_ALBUM_GAIN"
TAG_ALBUM_PEAK = "REPLAYGAIN_ALBUM_PEAK"


class ReplayGainError(Exception):
    pass


def is_valid_sample_rate(rate: int) -> bool:
    return rate in SAMPLE_RATES


_BLOCK = 1024  # samples a triangular solve in iir_filter


def iir_filter(a, b, x: torch.Tensor) -> torch.Tensor:
    """The plain direct-form-I IIR over x [C, n] float64 from zero state,
    y[t] = sum_k b[k] x[t-k] - sum_{k>=1} a[k] y[t-k]: flac_tpu's
    `_iir_scan(a, b)(x)`. The b-sums are one batched product; the
    recursion is a unit lower-triangular banded Toeplitz system, solved a
    block of _BLOCK samples at a time by forward substitution, the last
    outputs of each block carried into the next block's right-hand side.
    The sums are taken in another order than flac_tpu's (and the kernel's)
    fused multiply-adds, so they agree to a tolerance, not bit for bit
    (about 1e-13 of the output's peak at 44.1 kHz, 1e-11 at 96 kHz)."""
    dev = x.device
    a = torch.as_tensor(np.asarray(a, np.float64), device=dev)
    b = torch.as_tensor(np.asarray(b, np.float64), device=dev)
    order = a.shape[0] - 1
    C, n = x.shape
    if n == 0:
        return x.clone()
    fir = (torch.nn.functional.pad(x, (order, 0)).unfold(1, order + 1, 1)
           * b.flip(0)).sum(-1)  # [C, n]
    # T[i, i-k] = a[k]: the recursion over one block
    i = torch.arange(_BLOCK, device=dev)
    lag = i[:, None] - i[None, :]
    T = torch.where((lag >= 0) & (lag <= order), a[lag.clamp(0, order)],
                    torch.zeros((), dtype=torch.float64, device=dev))
    # P[i, j] = a[order + i - j] for j >= i: the previous block's last
    # `order` outputs in the first `order` rows
    k = torch.arange(order, device=dev)
    lag = order + k[:, None] - k[None, :]
    P = torch.where(lag <= order, a[lag.clamp(max=order)],
                    torch.zeros((), dtype=torch.float64, device=dev))
    y = torch.empty_like(fir)
    prev = torch.zeros((C, order), dtype=torch.float64, device=dev)
    for t0 in range(0, n, _BLOCK):
        m = min(_BLOCK, n - t0)
        rhs = fir[:, t0:t0 + m].clone()
        h = min(order, m)
        rhs[:, :h] -= (prev @ P.T)[:, :h]
        y[:, t0:t0 + m] = torch.linalg.solve_triangular(
            T[:m, :m], rhs.T, upper=False, unitriangular=True).T
        prev = y[:, t0 + m - order:t0 + m]  # only the last block is shorter
    return y


def _fma(a: float, b: float, c: float) -> float:
    # one correctly rounded fused multiply-add (int / int rounds correctly)
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def fma_reference(a, b, x) -> np.ndarray:
    """The CUDA kernel's arithmetic for one stage over one channel x [n],
    one correctly rounded operation at a time, in exact rationals: the
    b-dot a chain of fused multiply-adds from 0.0, most recent first; a
    10-tap a-dot in four lanes of two FMAs, the two taps left over in a
    chain, reduced as leftover + ((l0 + l2) + (l1 + l3)); a shorter a-dot
    one chain. That is the order in which XLA:CPU evaluates flac_tpu's
    `_iir_scan` (its GEMV vectorizes the a-dot, which reads a plain buffer),
    so this equals it bit for bit. Slow: it serves checks on short inputs."""
    ta = [float(v) for v in a[1:]]
    b = [float(v) for v in b]
    order = len(ta)
    xh, yh, out = [0.0] * (order + 1), [0.0] * order, []
    for xt in np.asarray(x, np.float64).tolist():
        xh = [xt] + xh[:order]
        bdot = 0.0
        for k in range(order + 1):
            bdot = _fma(b[k], xh[k], bdot)
        if order == 10:
            lanes = [_fma(ta[4 + l], yh[4 + l], _fma(ta[l], yh[l], 0.0)) for l in range(4)]
            rest = _fma(ta[9], yh[9], _fma(ta[8], yh[8], 0.0))
            adot = rest + ((lanes[0] + lanes[2]) + (lanes[1] + lanes[3]))
        else:
            adot = 0.0
            for k in range(order):
                adot = _fma(ta[k], yh[k], adot)
        yh = [bdot - adot] + yh[:-1]
        out.append(yh[0])
    return np.asarray(out, np.float64)


def equalizer_taps(freq_index: int) -> np.ndarray:
    """The 26 taps of one rate in the order the kernel takes them (Yule b,
    Yule a[1:], Butterworth b, Butterworth a[1:])."""
    return np.concatenate([B_YULE[freq_index], A_YULE[freq_index][1:],
                           B_BUTTER[freq_index], A_BUTTER[freq_index][1:]]
                          ).astype(np.float64)


def equal_loudness(x: torch.Tensor, freq_index: int) -> torch.Tensor:
    """ReplayGain's equal-loudness filter, Butterworth(Yule(x)), over x
    [C, n] float64. A CUDA tensor goes to the kernel (one launch, or a
    raise); a CPU tensor takes iir_filter twice."""
    if x.device.type == "cuda":
        return iir_scan.equal_loudness(x, equalizer_taps(freq_index))
    y = iir_filter(A_YULE[freq_index], B_YULE[freq_index], x)
    return iir_filter(A_BUTTER[freq_index], B_BUTTER[freq_index], y)


# float64 bytes one kernel launch may hold, input and output together;
# compute_replay_gain filters an album above it in consecutive groups of
# titles (a 15-minute stereo album at 44.1 kHz holds about 1.27 GB)
LAUNCH_BYTES = 8 << 30


def launch_bytes(x: torch.Tensor) -> int:
    """The float64 bytes a title x [C, n] takes in a launch, x and y."""
    c, n = x.shape
    return 2 * 8 * c * iir_scan.padded(n)


def equal_loudness_album(xs: list[torch.Tensor], freq_index: int) -> list[torch.Tensor]:
    """`equal_loudness` over every title xs[k] [C_k, n_k] float64 of one
    device, each from zero state; returns the outputs in order. On CUDA
    tensors one kernel launch for them all, or a raise; on CPU tensors
    iir_filter twice a title, exactly as `equal_loudness`."""
    if len({x.device for x in xs}) > 1:
        raise ValueError("equal_loudness_album: the titles lie on different devices")
    if not xs or xs[0].device.type != "cuda":
        return [equal_loudness(x, freq_index) for x in xs]
    buf, segs = iir_scan.pack_ragged(xs)
    y = iir_scan.equal_loudness_ragged(buf, segs, equalizer_taps(freq_index))
    return iir_scan.unpack_ragged(y, [tuple(x.shape) for x in xs])


class GainAnalysis:
    """Streaming-equivalent whole-signal analyzer. Matches the reference's
    semantics: equal-loudness filter → 50 ms window mean-square → histogram
    in 0.01 dB steps → gain = PINK_REF − 95th-percentile loudness. The
    filter runs on `device` (None: CUDA)."""

    def __init__(self, sample_rate: int,
                 device: str | torch.device | None = None) -> None:
        if not is_valid_sample_rate(sample_rate):
            raise ReplayGainError(f"sample rate {sample_rate} not supported by ReplayGain")
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.freq_index = SAMPLE_RATES.index(sample_rate)
        self.window = int(np.ceil(sample_rate * RMS_WINDOW_TIME_MS / 1000.0))
        nbins = int(STEPS_PER_DB * MAX_DB)
        self._title_hist = np.zeros(nbins, np.uint64)
        self._album_hist = np.zeros(nbins, np.uint64)
        self.title_peak = 0.0
        self.album_peak = 0.0

    def analyze(self, samples: np.ndarray, bps: int) -> None:
        """samples: int32 [n, channels] (1 or 2 channels). May be called
        repeatedly per title; whole-title analysis equals streaming because
        the filter state is continuous and windows tile the stream — for
        simplicity feed one title per call (the CLI does)."""
        x = self.scaled_input(samples, bps)
        self.add_windows(equal_loudness(x, self.freq_index).cpu().numpy())

    def scaled_input(self, samples: np.ndarray, bps: int) -> torch.Tensor:
        """The first step of analyze: fold the title's peak into the peaks
        and return the samples on the device as float64 [2, n], scaled to
        16-bit full scale (grabbag/replaygain.c:213-218; exact, a power of
        two). Mono is duplicated to two channels."""
        if samples.ndim == 1:
            samples = samples[:, None]
        n, ch = samples.shape
        if ch == 1:
            samples = np.repeat(samples, 2, axis=1)
        elif ch != 2:
            raise ReplayGainError("ReplayGain supports mono or stereo only")
        peak = float(np.abs(samples).max(initial=0)) / (1 << (bps - 1))
        self.title_peak = max(self.title_peak, peak)
        self.album_peak = max(self.album_peak, peak)
        scale = 2.0 ** (16 - bps)
        x = torch.from_numpy(np.ascontiguousarray(samples, np.int32)).to(self.device)
        return (x.T.to(torch.float64) * scale).contiguous()

    def add_windows(self, out: np.ndarray) -> None:
        """The last step of analyze: the filtered title out [2, n] float64
        into the title histogram, complete 50 ms windows only
        (replaygain_analysis.c:404-416)."""
        nwin = out.shape[1] // self.window
        if nwin == 0:
            return
        w = out[:, : nwin * self.window].reshape(2, nwin, self.window)
        msq = (w[0] ** 2 + w[1] ** 2).sum(axis=1) / self.window * 0.5
        val = STEPS_PER_DB * 10.0 * np.log10(msq + 1e-37)
        ival = np.clip(val.astype(np.int64), 0, len(self._title_hist) - 1)
        np.add.at(self._title_hist, ival, 1)

    def _analyze_result(self, hist: np.ndarray) -> float:
        elems = int(hist.sum())
        if elems == 0:
            return float(PINK_REF)  # GAIN_NOT_ENOUGH_SAMPLES behavior
        upper = int(np.ceil(elems * (1.0 - RMS_PERCENTILE)))
        csum = np.cumsum(hist[::-1])
        i = len(hist) - 1 - int(np.searchsorted(csum, upper))
        return float(np.float32(PINK_REF) - np.float32(i) / np.float32(STEPS_PER_DB))

    def title_gain(self) -> float:
        """Finish the current title: returns its gain and folds its histogram
        into the album statistic (GetTitleGain, replaygain_analysis.c:459)."""
        g = self._analyze_result(self._title_hist)
        self._album_hist += self._title_hist
        self._title_hist[:] = 0
        self.title_peak_final = self.title_peak
        self.title_peak = 0.0
        return g

    def album_gain(self) -> float:
        return self._analyze_result(self._album_hist)


# -- file-set workflow (grabbag/replaygain.c) --------------------------------

def compute_replay_gain(paths: list[str], device: str | torch.device | None = None):
    """Analyze a set of FLAC files as one album, decoding and filtering on
    `device` (None: CUDA). Returns (album_gain, album_peak,
    [(title_gain, title_peak), ...]).

    Each title is decoded, checked for its sample rate and scaled in order;
    then the titles are filtered together by `equal_loudness_album`, one
    launch on CUDA (above LAUNCH_BYTES, a group of titles at a time: the
    pending titles are filtered when the next would not fit), and their
    window statistics and gains taken in order."""
    from flac_tpu_torch.decode.stream import decode_bytes_device

    analysis: GainAnalysis | None = None
    titles: list[tuple[float, float]] = []
    pending: list[tuple[torch.Tensor, float]] = []  # scaled, not yet filtered
    pending_bytes = 0

    def finish_pending() -> None:
        ys = equal_loudness_album([x for x, _ in pending], analysis.freq_index)
        for y, (_, peak) in zip(ys, pending):
            analysis.add_windows(y.cpu().numpy())
            titles.append((analysis.title_gain(), peak))
        pending.clear()

    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        pcm, si, _ = decode_bytes_device(data, check_md5=False, device=device)
        if analysis is None:
            analysis = GainAnalysis(si.sample_rate, device=device)
        elif si.sample_rate != analysis.sample_rate:
            raise ReplayGainError("album files have differing sample rates")
        x = analysis.scaled_input(pcm, si.bits_per_sample)
        peak, analysis.title_peak = analysis.title_peak, 0.0  # this title's own
        if pending and pending_bytes + launch_bytes(x) > LAUNCH_BYTES:
            finish_pending()
            pending_bytes = 0
        pending.append((x, peak))
        pending_bytes += launch_bytes(x)
    finish_pending()
    album_peak = max([0.0] + [peak for _, peak in titles])
    return analysis.album_gain(), album_peak, titles


def store_tags(path: str, album_gain: float, album_peak: float,
               title_gain: float, title_peak: float) -> None:
    """Write the 5 ReplayGain tags (grabbag__replaygain_store_to_vorbiscomment,
    replaygain.c:384; formats :48-50)."""
    chain = MetadataChain.read(path)
    vc = chain.get(VorbisComment)
    if vc is None:
        vc = VorbisComment(vendor_string="")
        chain.blocks.insert(1, vc)
    for tag in (TAG_REFERENCE_LOUDNESS, TAG_TITLE_GAIN, TAG_TITLE_PEAK,
                TAG_ALBUM_GAIN, TAG_ALBUM_PEAK):
        vc.remove_entries(tag)
    vc.comments.append(f"{TAG_REFERENCE_LOUDNESS}={REFERENCE_LOUDNESS:2.1f} dB")
    vc.comments.append(f"{TAG_TITLE_GAIN}={title_gain:+2.2f} dB")
    vc.comments.append(f"{TAG_TITLE_PEAK}={title_peak:1.8f}")
    vc.comments.append(f"{TAG_ALBUM_GAIN}={album_gain:+2.2f} dB")
    vc.comments.append(f"{TAG_ALBUM_PEAK}={album_peak:1.8f}")
    chain.write(use_padding=True)


def add_replay_gain_tags(paths: list[str],
                         device: str | torch.device | None = None) -> None:
    """The `flac --replay-gain` / `metaflac --add-replay-gain` workflow:
    all files form one album (main.c:511-518); decoded and filtered on
    `device` (None: CUDA)."""
    album_gain, album_peak, titles = compute_replay_gain(paths, device=device)
    for p, (tg, tp) in zip(paths, titles):
        store_tags(p, album_gain, album_peak, tg, tp)


def load_tags(path: str, album: bool) -> tuple[float, float] | None:
    """Read (gain, peak) from a file's tags; album or track flavor."""
    vc = get_tags(path)
    if vc is None:
        return None
    g = vc.find_entry(TAG_ALBUM_GAIN if album else TAG_TITLE_GAIN)
    p = vc.find_entry(TAG_ALBUM_PEAK if album else TAG_TITLE_PEAK)
    if g is None:
        return None
    try:
        gain = float(g.strip().split()[0])
        peak = float(p) if p else 0.0
    except ValueError:
        return None
    return gain, peak


# -- synthesis (replaygain_synthesis.c:216,300-462) ---------------------------

# 16-tap psychoacoustic shaping filters (the reference's embedded WaveGain
# coefficient sets F44_1..3, replaygain_synthesis.c:131-196), used by the
# pure-Python fallback; the native runtime carries its own copy
_RG_F44 = np.array([
    [0.85018292704024355931, 0.29089597350995344721, -0.05021866022121039450,
     -0.23545456294599161833, -0.58362726442227032096, -0.67038978965193036429,
     -0.38566861572833459221, -0.15218663390367969967, -0.02577543084864530676,
     0.14119295297688728127, 0.22398848581628781612, 0.15401727203382084116,
     0.05216161232906000929, -0.00282237820999675451, -0.03042794608323867363,
     -0.03109780942998826024],
    [1.78827593892108555290, 0.95508210637394326553, -0.18447626783899924429,
     -0.44198126506275016437, -0.88404052492547413497, -1.42218907262407452967,
     -1.02037566838362314995, -0.34861755756425577264, -0.11490230170431934434,
     0.12498899339968611803, 0.38065885268563131927, 0.31883491321310506562,
     0.10486838686563442765, -0.03105361685110374845, -0.06450524884075370758,
     -0.02939198261121969816],
    [2.89072132015058161445, 2.68932810943698754106, 0.21083359339410251227,
     -0.98385073324997617515, -1.11047823227097316719, -2.18954076314139673147,
     -2.36498032881953056225, -0.95484132880101140785, -0.23924057925542965158,
     -0.13865235703915925642, 0.43587843191057992846, 0.65903257226026665927,
     0.24361815372443152787, -0.00235974960154720097, 0.01844166574603346289,
     0.01722945988740875099]], np.float32)


def compute_scale_factor(gain_db: float, preamp_db: float = 0.0,
                         peak: float = 0.0,
                         prevent_clipping: bool = False) -> float:
    """Linear scale from gain+preamp, optionally capped at 1/peak
    (grabbag__replaygain_compute_scale_factor, grabbag/replaygain.c:685-697)."""
    scale = float(np.float32(10.0 ** ((gain_db + preamp_db) * 0.05)))
    if prevent_clipping and peak > 0.0:
        scale = min(scale, float(np.float32(1.0 / peak)))
    return scale


class _PyDitherState:
    """Pure-Python fallback mirror of the native RgDitherCtx."""

    def __init__(self) -> None:
        self.r1 = self.r2 = 1
        self.last_random = [0] * 8
        self.dither_hist = np.zeros((8, 16), np.float32)
        self.error_hist = np.zeros((8, 16), np.float32)
        self.last_history_index = 0

    def rand(self) -> int:
        t1, t2 = self.r1, self.r2
        p1 = bin(t1 & 0xF5).count("1") & 1
        p2 = bin((t2 >> 25) & 0x63).count("1") & 1
        self.r1 = ((t1 >> 1) | (p1 << 31)) & 0xFFFFFFFF
        self.r2 = ((t2 + t2) | p2) & 0xFFFFFFFF
        return self.r1 ^ self.r2


def _as_i32(u: int) -> int:
    return u - (1 << 32) if u >= (1 << 31) else u


def _py_apply(state: _PyDitherState, pcm: np.ndarray, source_bps: int,
              target_bps: int, scale: float, hard_limit: bool,
              do_dither: bool, shaping: int) -> np.ndarray:
    """Sample-sequential fallback (same algorithm as the native path;
    vectorized when no dithering is requested)."""
    n, ch = pcm.shape
    conv = 1 << (32 - target_bps)
    hard_clip = -(1 << (target_bps - 1))
    multi = scale / (1 << (source_bps - 1))
    x = pcm.astype(np.float64) * multi
    if hard_limit:
        x = np.where(x > 0.5, np.tanh((x - 0.5) / 0.5) * 0.5 + 0.5, x)
        x = np.where(x < -0.5, np.tanh((x + 0.5) / 0.5) * 0.5 - 0.5, x)
    x *= 2147483648.0  # the reference's 2147483647.f float literal == 2^31
    # add/mask/dither amplitude quantize at the SOURCE width: the reference
    # initializes its DitherContext with the stream bps (decode.c:1353), while
    # conv/hard_clip use the apply call's target_bps
    # (replaygain_synthesis.c:226-228,372-373)
    add = 0.5 * ((1 << (32 - source_bps)) - 1)
    if not do_dither:
        r = np.round(x + add).astype(np.int64)
        v = np.sign(r) * (np.abs(r) // conv)  # C trunc-toward-zero division
        state.last_history_index = (state.last_history_index + n) % 32
        return np.clip(v, hard_clip, -(hard_clip + 1)).astype(np.int32)
    shaping = max(0, min(3, shaping))
    dd = [92, 92, 88, 84, 81, 78, 74, 67, 0, 0]
    di = max(0, min(9, source_bps - 11 - shaping))
    dmult = float(np.float32(0.01 * dd[di])) / (1 << source_bps)
    mask = (~0) << (32 - source_bps)
    coeff = _RG_F44[shaping - 1 if shaping else 0]
    out = np.empty_like(pcm)
    last = state.last_history_index
    for k in range(ch):
        for i in range(n):
            ridx = (i + last) % 32 & 15
            s = x[i, k]
            if shaping == 0:
                tmp = dmult * _as_i32(state.rand())
                sum2 = tmp - state.last_random[k]
                state.last_random[k] = int(tmp)
                val = int(np.round(s + sum2 + add)) & mask
            else:
                dh, eh = state.dither_hist[k], state.error_hist[k]
                rot = np.roll(coeff, -ridx)
                tri = dmult * (_as_i32(state.rand()) + _as_i32(state.rand()))
                sum2 = tri - float(dh @ rot)
                stored = np.float32(sum2)
                dh[(-1 - ridx) & 15] = stored
                ssum = s + float(stored)
                val = int(np.round(ssum + float(eh @ rot) + add)) & mask
                eh[(-1 - ridx) & 15] = np.float32(ssum - val)
            v = val // conv if val >= 0 else -((-val) // conv)
            if v >= -hard_clip:
                v = -(hard_clip + 1)
            elif v < hard_clip:
                v = hard_clip
            out[i, k] = v
    state.last_history_index = (last + n) % 32
    return out


class GainApplier:
    """Streaming gain application with persistent dither state — the analog
    of (DitherContext, FLAC__replaygain_synthesis__apply_gain) pairs
    (replaygain_synthesis.h:60, decode.c:1353). Feed chunks in stream order."""

    def __init__(self, source_bps: int, target_bps: int | None = None,
                 scale: float = 1.0, hard_limit: bool = False,
                 noise_shaping: int = 0) -> None:
        self.source_bps = source_bps
        self.target_bps = target_bps or source_bps
        self.scale = scale
        self.hard_limit = hard_limit
        self.noise_shaping = max(0, min(3, noise_shaping))
        # the reference CLI dithers iff shaping is enabled (decode.c:1111)
        self.do_dither = self.noise_shaping != 0
        try:
            from flac_tpu_torch._native import RgDitherContext
            self._native = RgDitherContext()
        except Exception:
            self._native = None
            self._py = _PyDitherState()

    def apply(self, pcm: np.ndarray) -> np.ndarray:
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        if self._native is not None:
            return self._native.apply(pcm, self.source_bps, self.target_bps,
                                      self.scale, self.hard_limit,
                                      self.do_dither, self.noise_shaping)
        return _py_apply(self._py, pcm, self.source_bps, self.target_bps,
                         self.scale, self.hard_limit, self.do_dither,
                         self.noise_shaping)


def apply_gain(samples: np.ndarray, gain_db: float, source_bps: int,
               target_bps: int | None = None, preamp_db: float = 0.0,
               hard_limit: bool = True, noise_shaping: int = 0,
               peak: float = 0.0, prevent_clipping: bool = False,
               dither: bool | None = None,
               chunk: int | None = None) -> np.ndarray:
    """Apply a ReplayGain to int32 PCM, returning int32 PCM at target_bps.

    One-shot form of FLAC__replaygain_synthesis__apply_gain
    (replaygain_synthesis.c:300-462): normalize to [-1,1), scale (optionally
    peak-capped), optional 6 dB tanh limiting above half scale, dither with
    the selected noise-shaping filter (0=high-passed rectangular as shaped by
    dither_output_; 1-3=triangular through the 16-tap error-feedback
    filters), convert + clamp to the target width. `dither` (legacy bool)
    forces shaping 1 when True and no shaping/dither when False.

    `chunk` feeds the dither state in blocks of that many samples — pass the
    stream's frame blocksize to reproduce the reference CLI byte-for-byte:
    its apply_gain runs once per decoded frame (decode.c:1100), so the RNG
    draws interleave channel-within-block, block by block."""
    if dither is not None:
        noise_shaping = 1 if (dither and noise_shaping == 0) else (
            noise_shaping if dither else 0)
    scale = compute_scale_factor(gain_db, preamp_db, peak, prevent_clipping)
    applier = GainApplier(source_bps, target_bps, scale, hard_limit,
                          noise_shaping)
    if samples.ndim == 1:
        samples = samples[:, None]
    if not chunk or chunk >= len(samples):
        return applier.apply(samples)
    return np.concatenate([applier.apply(samples[i:i + chunk])
                           for i in range(0, len(samples), chunk)])
