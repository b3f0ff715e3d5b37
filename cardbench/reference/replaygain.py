"""A plain ReplayGain analysis in PyTorch, written from the published
algorithm (the ReplayGain 1.0 proposal as `replaygain_analysis.c` implements
it) and from `grabbag/replaygain.c`'s tags: the check of the benchmark's
`flac --replay-gain` cell. It imports nothing of the program.

- The equal-loudness filter: a 10th-order Yule-Walker stage, then a
  2nd-order Butterworth high-pass, each from zero state at a title's start.
  Each stage is a blocked forward substitution of its all-pole recursion:
  the b-sums (a causal FIR) in one pass, then the recursion BLOCK samples at
  a time, each block solved through its lower-triangular Toeplitz inverse
  (the stage's impulse response) from a zero carry, all blocks at once; the
  last `order` outputs of each block are then carried into the next on the
  host, and their effect added to each block in one product.
- 50 ms windows (complete windows only: a title's remainder is dropped, and
  the state starts anew at the next title), the mean square of both
  channels, 100 bins a dB over 120 dB, the 95th percentile.
- Peaks: the largest |sample| over 2^(bits-1).
- The five tags as `grabbag/replaygain.c` formats them.

Titles are filtered one at a time, so that an album's reference holds one
title's arrays on the device at once. `dtype` sets the filter's precision
(the window statistics are float64 whatever it is): float64 is the
reference, float32 the precision below it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# the published equal-loudness coefficients a sample rate: (Yule-Walker b,
# Yule-Walker a, Butterworth b, Butterworth a), a[0] = 1
FILTERS = {
    192000: (
        (0.01184742123123, -0.04631092400086, 0.06584226961238, -0.02165588522478,
         -0.05656260778952, 0.0860749359276, -0.03375544339786, -0.04216579932754,
         0.06416711490648, -0.03444708260844, 0.00697275872241),
        (1.0, -5.24727318348167, 10.60821585192244, -8.74127665810413, -1.33906071371683,
         8.07972882096606, -5.46179918950847, 0.54318070652536, 0.8745096922428,
         -0.34656083539754, 0.03034796843589),
        (0.99653501465135, -1.99307002930271, 0.99653501465135),
        (1.0, -1.99305802314321, 0.99308203546221),
    ),
    176400: (
        (0.00268568524529, -0.0085237942608, 0.00852704191347, 0.00146116310295,
         -0.00950855828762, 0.00625449515499, 0.00116183868722, -0.00362461417136,
         0.00203961000134, -0.00050664587933, 4.327455427e-05),
        (1.0, -5.57512782763045, 12.44291056065794, -12.87462799681221, 3.08554846961576,
         6.62493459880692, -7.07662766313248, 2.51175542736441, 0.06731510802735,
         -0.24567753819213, 0.03961404162376),
        (0.99622916581118, -1.99245833162236, 0.99622916581118),
        (1.0, -1.99244411238133, 0.99247255086339),
    ),
    144000: (
        (0.0063968235945, -0.02556437970955, 0.04230854400938, -0.03722462201267,
         0.01718514827295, 0.00610592243009, -0.03065965747365, 0.04345745003539,
         -0.03298592681309, 0.01320937236809, -0.00220304127757),
        (1.0, -6.14814623523425, 15.80002457141566, -20.78487587686937, 11.98848552310315,
         3.36462015062606, -10.2241986835947, 6.65599702146473, -1.67141861110485,
         -0.05417956536718, 0.07374767867406),
        (0.99538268958706, -1.99076537917413, 0.99538268958706),
        (1.0, -1.99074405950505, 0.99078669884321),
    ),
    128000: (
        (0.00553120584305, -0.02112620545016, 0.03549076243117, -0.03362498312306,
         0.01425867248183, 0.01344686928787, -0.03392770787836, 0.0346413645953,
         -0.02039116051549, 0.00667420794705, -0.00093763762995),
        (1.0, -6.14581710839925, 16.04785903675838, -22.19089131407749, 15.24756471580286,
         -0.52001440400238, -8.0048864169994, 6.60916094768855, -2.37856022810923,
         0.33106947986101, 0.00459820832036),
        (0.99480702681278, -1.98961405362557, 0.99480702681278),
        (1.0, -1.98958708647324, 0.9896410207779),
    ),
    112000: (
        (0.00528778718259, -0.01893240907245, 0.03185982561867, -0.02926260297838,
         0.00715743034072, 0.01985743355827, -0.03222614850941, 0.02565681978192,
         -0.01210662313473, 0.00325436284541, -0.00044173593001),
        (1.0, -6.24932108456288, 17.42344320538476, -27.86819709054896, 26.79087344681326,
         -13.43711081485123, -0.66023612948173, 6.03658091814935, -4.2492657703031,
         1.40829268709186, -0.19480852628112),
        (0.99406737810867, -1.98813475621734, 0.99406737810867),
        (1.0, -1.98809955990514, 0.98816995252954),
    ),
    96000: (
        (0.00588138296683, -0.01613559730421, 0.02184798954216, -0.01742490405317,
         0.0046463564378, 0.01117772513205, -0.02123865824368, 0.0195935441335,
         -0.01079720643523, 0.00352183686289, -0.00063124341421),
        (1.0, -5.97808823642008, 16.21362507964068, -25.72923730652599, 25.40470663139513,
         -14.66166287771134, 2.81597484359752, 2.51447125969733, -2.23575306985286,
         0.75788151036791, -0.10078025199029),
        (0.99308203517541, -1.98616407035082, 0.99308203517541),
        (1.0, -1.98611621154089, 0.98621192916075),
    ),
    88200: (
        (0.02667482047416, -0.11377479336097, 0.23063167910965, -0.30726477945593,
         0.33188520686529, -0.33862680249063, 0.3180716153134, -0.2373079692988,
         0.12273894790371, -0.03840017967282, 0.00549673387936),
        (1.0, -6.31836451657302, 18.31351310801799, -31.88210014815921, 36.5379214697674,
         -28.23393036467559, 14.24725258227189, -4.04670980012854, 0.18865757280515,
         0.25420333563908, -0.06012333531065),
        (0.99247255046129, -1.98494510092259, 0.99247255046129),
        (1.0, -1.98488843762335, 0.98500176422183),
    ),
    64000: (
        (0.02613056568174, -0.08128786488109, 0.14937282347325, -0.21695711675126,
         0.25010286673402, -0.23162283619278, 0.17424041833052, -0.1029959921668,
         0.04258696481981, -0.00977952936493, 0.00105325558889),
        (1.0, -5.73625477092119, 16.15249794355035, -29.68654912464508, 39.55706155674083,
         -39.82524556246253, 30.50605345013009, -17.43051772821245, 7.05154573908017,
         -1.80783839720514, 0.22127840210813),
        (0.98964101933472, -1.97928203866944, 0.98964101933472),
        (1.0, -1.97917472731009, 0.9793893500288),
    ),
    56000: (
        (0.03144914734085, -0.06151729206963, 0.08066788708145, -0.09737939921516,
         0.08943210803999, -0.0698998467201, 0.04926972841044, -0.03161257848451,
         0.01456837493506, -0.00316015108496, 0.00132807215875),
        (1.0, -4.87377313090032, 12.03922160140209, -20.10151118381395, 25.10388534415171,
         -24.29065560815903, 18.27158469090663, -10.45249552560593, 4.30319491872003,
         -1.13716992070185, 0.14510733527035),
        (0.98816995007392, -1.97633990014784, 0.98816995007392),
        (1.0, -1.97619994516973, 0.97647985512594),
    ),
    48000: (
        (0.038575994352, -0.02160367184185, -0.00123395316851, -9.291677959e-05,
         -0.01655260341619, 0.02161526843274, -0.02074045215285, 0.00594298065125,
         0.00306428023191, 0.00012025322027, 0.00288463683916),
        (1.0, -3.84664617118067, 7.81501653005538, -11.34170355132042, 13.05504219327545,
         -12.28759895145294, 9.4829380631979, -5.87257861775999, 2.75465861874613,
         -0.86984376593551, 0.13919314567432),
        (0.98621192462708, -1.97242384925416, 0.98621192462708),
        (1.0, -1.97223372919527, 0.97261396931306),
    ),
    44100: (
        (0.0541865640643, -0.02911007808948, -0.00848709379851, -0.00851165645469,
         -0.00834990904936, 0.02245293253339, -0.02596338512915, 0.01624864962975,
         -0.00240879051584, 0.00674613682247, -0.00187763777362),
        (1.0, -3.47845948550071, 6.36317777566148, -8.54751527471874, 9.4769360780128,
         -8.81498681370155, 6.85401540936998, -4.39470996079559, 2.19611684890774,
         -0.75104302451432, 0.13149317958808),
        (0.98500175787242, -1.97000351574484, 0.98500175787242),
        (1.0, -1.96977855582618, 0.9702284756635),
    ),
    37800: (
        (0.08717879977844, -0.01000374016172, -0.06265852122368, -0.0111932880095,
         -0.0011427937296, 0.02081333954769, -0.01603261863207, 0.01936763028546,
         0.00760044736442, -0.00303979112271, -0.00075088605788),
        (1.0, -2.62816311472146, 3.53734535817992, -3.81003448678921, 3.91291636730132,
         -3.53518605896288, 2.71356866157873, -1.86723311846592, 1.12075382367659,
         -0.4857408688689, 0.11330544663849),
        (0.98252400815195, -1.96504801630391, 0.98252400815195),
        (1.0, -1.96474258269041, 0.9653534499174),
    ),
    32000: (
        (0.15457299681924, -0.09331049056315, -0.06247880153653, 0.02163541888798,
         -0.05588393329856, 0.04781476674921, 0.00222312597743, 0.03174092540049,
         -0.01390589421898, 0.00651420667831, -0.00881362733839),
        (1.0, -2.37898834973084, 2.84868151156327, -2.64577170229825, 2.23697657451713,
         -1.67148153367602, 1.00595954808547, -0.45953458054983, 0.16378164858596,
         -0.05032077717131, 0.0234789740702),
        (0.97938932735214, -1.95877865470428, 0.97938932735214),
        (1.0, -1.95835380975398, 0.95920349965459),
    ),
    24000: (
        (0.30296907319327, -0.22613988682123, -0.08587323730772, 0.03282930172664,
         -0.00915702933434, -0.02364141202522, -0.00584456039913, 0.06276101321749,
         -8.28086748e-06, 0.00205861885564, -0.02950134983287),
        (1.0, -1.61273165137247, 1.0797749225997, -0.2565625775407, -0.1627671912044,
         -0.22638893773906, 0.39120800788284, -0.22138138954925, 0.04500235387352,
         0.02005851806501, 0.00302439095741),
        (0.97531843204928, -1.95063686409857, 0.97531843204928),
        (1.0, -1.95002759149878, 0.95124613669835),
    ),
    22050: (
        (0.33642304856132, -0.2557224142557, -0.11828570177555, 0.11921148675203,
         -0.07834489609479, -0.0046997791438, -0.0058950022444, 0.05724228140351,
         0.00832043980773, -0.0163538138454, -0.0176017656815),
        (1.0, -1.49858979367799, 0.87350271418188, 0.12205022308084, -0.80774944671438,
         0.47854794562326, -0.12453458140019, -0.04067510197014, 0.08333755284107,
         -0.04237348025746, 0.02977207319925),
        (0.97316523498161, -1.94633046996323, 0.97316523498161),
        (1.0, -1.94561023566527, 0.94705070426118),
    ),
    18900: (
        (0.38524531015142, -0.27682212062067, -0.09980181488805, 0.09951486755646,
         -0.08934020156622, -0.00322369330199, -0.00110329090689, 0.03784509844682,
         0.01683906213303, -0.01147039862572, -0.01941767987192),
        (1.0, -1.29708918404534, 0.90399339674203, -0.29613799017877, -0.42326645916207,
         0.379348874022, -0.37919795944938, 0.23410283284785, -0.03892971758879,
         0.00403009552351, 0.03640166626278),
        (0.96535326815829, -1.93070653631658, 0.96535326815829),
        (1.0, -1.92950577983524, 0.93190729279793),
    ),
    16000: (
        (0.4491525660845, -0.14351757464547, -0.22784394429749, -0.01419140100551,
         0.04078262797139, -0.12398163381748, 0.04097565135648, 0.10478503600251,
         -0.01863887810927, -0.03193428438915, 0.00541907748707),
        (1.0, -0.62820619233671, 0.29661783706366, -0.372563729424, 0.00213767857124,
         -0.42029820170918, 0.22199650564824, 0.00613424350682, 0.06747620744683,
         0.05784820375801, 0.03222754072173),
        (0.96454515552826, -1.92909031105652, 0.96454515552826),
        (1.0, -1.92783286977036, 0.93034775234268),
    ),
    12000: (
        (0.56619470757641, -0.75464456939302, 0.1624213774223, 0.16744243493672,
         -0.18901604199609, 0.3093178284183, -0.27562961986224, 0.00647310677246,
         0.08647503780351, -0.0378898455484, -0.00588215443421),
        (1.0, -1.04800335126349, 0.29156311971249, -0.26806001042947, 0.00819999645858,
         0.45054734505008, -0.33032403314006, 0.0673936833311, -0.04784254229033,
         0.01639907836189, 0.01807364323573),
        (0.96009142950541, -1.92018285901082, 0.96009142950541),
        (1.0, -1.91858953033784, 0.92177618768381),
    ),
    11025: (
        (0.58100494960553, -0.53174909058578, -0.14289799034253, 0.17520704835522,
         0.02377945217615, 0.15558449135573, -0.25344790059353, 0.01628462406333,
         0.06920467763959, -0.03721611395801, -0.00749618797172),
        (1.0, -0.51035327095184, -0.31863563325245, -0.20256413484477, 0.1472815413433,
         0.38952639978999, -0.23313271880868, -0.05246019024463, -0.02505961724053,
         0.02442357316099, 0.01818801111503),
        (0.95856916599601, -1.91713833199203, 0.95856916599601),
        (1.0, -1.9154210807478, 0.91885558323625),
    ),
    8000: (
        (0.53648789255105, -0.42163034350696, -0.00275953611929, 0.04267842219415,
         -0.10214864179676, 0.14590772289388, -0.02459864859345, -0.11202315195388,
         -0.04060034127, 0.0478866554818, -0.02217936801134),
        (1.0, -0.2504987195602, -0.43193942311114, -0.03424681017675, -0.04678328784242,
         0.26408300200955, 0.15113130533216, -0.17556493366449, -0.18823009262115,
         0.05477720428674, 0.0470440968812),
        (0.94597685600279, -1.89195371200558, 0.94597685600279),
        (1.0, -1.88903307939452, 0.89487434461664),
    ),
}

BLOCK = 2048           # samples a block of the forward substitution
WINDOW_MS = 50
STEPS_PER_DB = 100
MAX_DB = 120
PERCENTILE = 0.95
PINK_REF = 64.82
REFERENCE_LOUDNESS = 89.0
NOT_ENOUGH_SAMPLES = -24601.0  # a histogram without a window
# A gain is a histogram bin, 0.01 dB wide, and its tag shows it exactly, so
# the program's gain must be the reference's: the filter's float64 sums in
# another order move a window's level by about 1e-12 dB, which crosses a bin
# edge at the 95th percentile too seldom to see, while the same filter in
# float32 (about 1e-3 dB a window) moved one gain of 60 by one step over 12
# of the benchmark's albums, which a tolerance of one step would pass
GAIN_TOLERANCE_DB = 0.0

TAGS = ("REPLAYGAIN_REFERENCE_LOUDNESS", "REPLAYGAIN_TRACK_GAIN", "REPLAYGAIN_TRACK_PEAK",
        "REPLAYGAIN_ALBUM_GAIN", "REPLAYGAIN_ALBUM_PEAK")
GAINS = ("REPLAYGAIN_TRACK_GAIN", "REPLAYGAIN_ALBUM_GAIN")


@dataclass
class Album:
    title_gains: list
    title_peaks: list
    album_gain: float
    album_peak: float


def _impulse(a: np.ndarray, n: int) -> np.ndarray:
    """The first n samples of 1 / A(z)'s impulse response, in a's dtype."""
    p = len(a) - 1
    h = np.zeros(n, a.dtype)
    h[0] = 1
    for t in range(1, n):
        k = min(p, t)
        h[t] = -np.dot(a[1:k + 1], h[t - k:t][::-1])
    return h


def iir(b, a, x: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_k b[k] x[t-k] - sum_{k>=1} a[k] y[t-k] over each row of
    x [R, n] from zero state, in x's dtype, on x's device."""
    dt, dev = x.dtype, x.device
    npdt = np.float64 if dt == torch.float64 else np.float32
    a, b = np.asarray(a, npdt), np.asarray(b, npdt)
    p = len(a) - 1
    R, n = x.shape
    if n == 0:
        return x.clone()
    fir = float(b[0]) * x
    for k in range(1, len(b)):
        fir[:, k:] += float(b[k]) * x[:, :n - k]
    nb = -(-n // BLOCK)
    f = torch.zeros((R, nb * BLOCK), dtype=dt, device=dev)
    f[:, :n] = fir
    del fir
    f = f.view(R, nb, BLOCK)
    # G[i, j] = h[i - j]: a block's solve from a zero carry
    h = torch.from_numpy(_impulse(a, BLOCK)).to(dev)
    i = torch.arange(BLOCK, device=dev)
    lag = i[:, None] - i[None, :]
    G = torch.where(lag >= 0, h[lag.clamp(min=0)], torch.zeros((), dtype=dt, device=dev))
    z = f @ G.T
    del f
    # the previous block's last p outputs s[j] = y[-p + j] enter row i < p of
    # the right-hand side as -a[p + i - j] s[j], for i <= j < p
    P = torch.zeros((BLOCK, p), dtype=dt, device=dev)
    for r in range(p):
        for j in range(r, p):
            P[r, j] = float(a[p + r - j])
    E = G @ P  # [BLOCK, p]: a carry's effect on the block
    D = E[BLOCK - p:].cpu().numpy()
    zt = z[:, :, BLOCK - p:].cpu().numpy()
    carry = np.zeros((R, nb, p), npdt)
    s = np.zeros((R, p), npdt)
    for blk in range(nb):
        carry[:, blk] = s
        s = zt[:, blk] - s @ D.T
    z -= torch.from_numpy(carry).to(dev) @ E.T
    return z.view(R, nb * BLOCK)[:, :n]


def window_length(rate: int) -> int:
    return -(-rate * WINDOW_MS // 1000)


def histogram(y: torch.Tensor, rate: int) -> np.ndarray:
    """The title's 0.01 dB histogram: one count a complete 50 ms window, by
    the mean square of its two channels (float64)."""
    w = window_length(rate)
    nwin = y.shape[1] // w
    bins = STEPS_PER_DB * MAX_DB
    if nwin == 0:
        return np.zeros(bins, np.int64)
    sq = y[:, :nwin * w].to(torch.float64).reshape(2, nwin, w).square().sum(dim=2)
    msq = (sq[0] + sq[1]) / w * 0.5
    level = torch.trunc(STEPS_PER_DB * 10.0 * torch.log10(msq + 1e-37)).to(torch.int64)
    return torch.bincount(level.clamp(0, bins - 1), minlength=bins).cpu().numpy()


def gain(hist: np.ndarray) -> float:
    """The 95th percentile's gain, as the float the reference returns."""
    elems = int(hist.sum())
    if elems == 0:
        return NOT_ENOUGH_SAMPLES
    upper = math.ceil(elems * (1.0 - PERCENTILE))
    i = len(hist)
    while i > 0:
        i -= 1
        upper -= int(hist[i])
        if upper <= 0:
            break
    return float(np.float32(PINK_REF) - np.float32(i) / np.float32(STEPS_PER_DB))


def analyse(titles, bits: int, rate: int, device="cpu", dtype=torch.float64) -> Album:
    """ReplayGain over `titles` (int32 [n, channels] host arrays, 1 or 2
    channels) as one album."""
    yule_b, yule_a, butter_b, butter_a = FILTERS[rate]
    album = np.zeros(STEPS_PER_DB * MAX_DB, np.int64)
    gains, peaks = [], []
    for pcm in titles:
        pcm = np.asarray(pcm)
        pcm = pcm[:, None] if pcm.ndim == 1 else pcm
        peaks.append(int(np.abs(pcm.astype(np.int64)).max(initial=0)) / (1 << (bits - 1)))
        x = torch.from_numpy(np.ascontiguousarray(pcm.T, np.int32)).to(device)
        x = x.to(dtype) * 2.0 ** (16 - bits)
        if x.shape[0] == 1:
            x = x.repeat(2, 1)
        y = iir(butter_b, butter_a, iir(yule_b, yule_a, x))
        del x
        hist = histogram(y, rate)
        del y
        gains.append(gain(hist))
        album += hist
    return Album(gains, peaks, gain(album), max(peaks, default=0.0))


def tags(album: Album) -> list[dict]:
    """Each title's five tags, formatted as grabbag/replaygain.c does."""
    return [{"REPLAYGAIN_REFERENCE_LOUDNESS": f"{REFERENCE_LOUDNESS:2.1f} dB",
             "REPLAYGAIN_TRACK_GAIN": f"{g:+2.2f} dB", "REPLAYGAIN_TRACK_PEAK": f"{p:1.8f}",
             "REPLAYGAIN_ALBUM_GAIN": f"{album.album_gain:+2.2f} dB",
             "REPLAYGAIN_ALBUM_PEAK": f"{album.album_peak:1.8f}"}
            for g, p in zip(album.title_gains, album.title_peaks)]


def vorbis_comments(data: bytes) -> list[str]:
    """The comments of a FLAC stream's VORBIS_COMMENT block ([] without one)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    at, last = 4, False
    while not last and at + 4 <= len(data):
        last, kind = bool(data[at] & 0x80), data[at] & 0x7F
        size = int.from_bytes(data[at + 1:at + 4], "big")
        body = data[at + 4:at + 4 + size]
        at += 4 + size
        if kind != 4:
            continue
        vendor = int.from_bytes(body[:4], "little")
        pos = 4 + vendor
        count = int.from_bytes(body[pos:pos + 4], "little")
        pos += 4
        out = []
        for _ in range(count):
            k = int.from_bytes(body[pos:pos + 4], "little")
            out.append(body[pos + 4:pos + 4 + k].decode("utf-8"))
            pos += 4 + k
        return out
    return []


def replaygain_tags(data: bytes) -> dict:
    """{name: value} of the stream's ReplayGain tags (names upper-cased; the
    last entry of a name wins)."""
    out = {}
    for c in vorbis_comments(data):
        name, sep, value = c.partition("=")
        if sep and name.upper() in TAGS:
            out[name.upper()] = value
    return out


def _db(value: str) -> float | None:
    try:
        number, unit = value.split()
        return float(number) if unit == "dB" else None
    except ValueError:
        return None


def gain_steps(got: str, want: str) -> float:
    """How many 0.01 dB steps a gain tag lies from another (inf where either
    is not a gain)."""
    g, w = _db(got), _db(want)
    return math.inf if g is None or w is None else round(abs(g - w) * STEPS_PER_DB, 6)


def mismatches(got: dict, want: dict, tolerance_db: float = GAIN_TOLERANCE_DB) -> int:
    """The tags of `want` that `got` lacks or holds otherwise: a gain further
    than `tolerance_db` from the reference's, any other tag not the same
    string."""
    n = 0
    for name, value in want.items():
        if name not in got:
            n += 1
        elif name in GAINS:
            g, w = _db(got[name]), _db(value)
            n += g is None or abs(g - w) > tolerance_db + 1e-9
        else:
            n += got[name] != value
    return n
