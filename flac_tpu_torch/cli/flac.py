"""`flac`-equivalent command line tool.

The analog of src/flac/main.c (option table :97-230) and its encode and decode
front ends (src/flac/encode.c, decode.c): encode (default), decode (-d), test
(-t), and analyze (-a) modes over WAV/RF64/Wave64/AIFF/AIFF-C/raw/FLAC
inputs, with the encoder option surface (-0..-8, -b/-m/-M/-l/-q/-r/-A/-e/-p,
--lax, -V), stream windowing (--skip/--until/--cue), metadata at encode time
(-S seektables, -T tags, --cuesheet, --picture, -P padding), raw-format
options, foreign-chunk preservation, and the undocumented --disable-*
debug flags.

The port of flac_tpu.cli.flac. FLAC_TPU_DEVICE names the torch device the
codec runs on; unset, it is CUDA, which raises without a GPU. An encode
records the span `cli.encode` a file and, with --replay-gain,
`cli.replaygain` around the album's tagging (`flac_tpu_torch.trace`).

Usage: python -m flac_tpu_torch.cli.flac [options] [infile [...]]
"""

from __future__ import annotations

import os
import sys

from flac_tpu_torch import trace
from flac_tpu_torch.containers import (
    AudioBuffer,
    aiff_bytes,
    parse_aiff,
    parse_raw,
    parse_w64,
    parse_wav,
    raw_bytes,
    sniff_format,
    w64_bytes,
    wav_bytes,
)
from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.kernels import DEVICE_FAULTS
from flac_tpu_torch.version import __version__ as VERSION

USAGE = __doc__

EXPLAIN = """\
Detailed option reference (-H/--explain; mirrors flac's show_explain,
src/flac/main.c:1300):

general:
  -v, --version          Show the version number
  -h, --help             Show the basic usage synopsis
  -H, --explain          Show this screen
  -d, --decode           Decode (default behavior is to encode)
  -t, --test             Same as -d except no decoded file is written
  -a, --analyze          Same as -d except an analysis file is written
  -c, --stdout           Write output to stdout
  -s, --silent           Do not write runtime encode/decode statistics
      --totally-silent   Do not print anything, including errors
      --no-utf8-convert  Do not convert tags from local charset to UTF-8
  -w, --warnings-as-errors  Treat all warnings as errors
  -f, --force            Force overwriting of output files
  -o, --output-name=FILENAME  Force the output file name
      --output-prefix=STRING  Prepend STRING to output names
      --delete-input-file     Delete the encoded/decoded input on success
      --preserve-modtime      Output files keep the input's timestamps (default)
      --keep-foreign-metadata Save/restore RIFF/AIFF chunks in/from APPLICATION
                              blocks
      --skip={#|mm:ss.ss}     Skip the first # samples of the input
      --until={#|[+|-]mm:ss.ss}  Stop at the given sample/time
      --ogg                   Use Ogg as the transport layer
      --serial-number=#       Ogg serial number (encode; increments per file)

analysis options:
      --residual-text         Include residual signal in the analysis file
      --residual-gnuplot      Dump gnuplot files of residual distributions

decoding options:
  -F, --decode-through-errors Continue decoding through stream errors
      --cue=[#.#][-[#.#]]     Decode the given cuesheet track section
      --apply-replaygain-which-is-not-lossless[=SPEC]  Apply ReplayGain
      --channel-map=none      Do not reorder channels

encoding options:
  -V, --verify            Verify a correct encoding by decoding in parallel
      --lax               Allow encoder to generate non-Subset files
      --sector-align      (DEPRECATED) Align multiple CD-audio files on sector
                          boundaries
      --ignore-chunk-sizes    Ignore data chunk sizes in WAVE/AIFF files
      --replay-gain           Calculate ReplayGain & store in Vorbis comments
      --cuesheet=FILENAME     Import the given cuesheet
      --picture=SPECIFICATION Import a picture into a PICTURE block
  -T, --tag=FIELD=VALUE       Add a Vorbis comment
      --tag-from-file=FIELD=FILENAME  Tag value from file contents
  -S, --seekpoint={#|X|#x|#s} Include seek points in a SEEKTABLE
      --no-cued-seekpoints    Do not add seekpoints for cuesheet track indices
  -P, --padding=#             Write a PADDING block of the given size
  -b, --blocksize=#           Block size in samples
  -m, --mid-side              Try mid-side coding for stereo
  -M, --adaptive-mid-side     Adaptive mid-side coding
  -0..-8, --compression-level-#  Compression preset (-5 default); --fast=-0,
                          --best=-8
  -e, --exhaustive-model-search   Exhaustive model search
  -A, --apodization=FUNCTION  Window function(s) for LPC analysis
  -l, --max-lpc-order=#       Maximum LPC order
  -p, --qlp-coeff-precision-search  Search all quantized coeff precisions
  -q, --qlp-coeff-precision=# Precision of quantized LPC coefficients
  -r, --rice-partition-order=[#,]#  [Min,]max residual partition order
  -V with -t is not allowed; format options (--endian/--sign/--channels/--bps/
  --sample-rate) describe raw input, --force-raw-format forces raw treatment.
"""


class CLIError(Exception):
    pass


class Options:
    def __init__(self) -> None:
        self.mode = "encode"  # encode | decode | test | analyze
        self.level = 5
        self.verbosity = 2  # 0 totally silent, 1 silent(errors only), 2 normal
        self.force = False
        self.output_name: str | None = None
        self.output_prefix: str | None = None
        self.to_stdout = False
        self.delete_input = False
        self.preserve_modtime = True  # main.c:556 default
        self.ignore_chunk_sizes = False
        self.sector_align = False  # DEPRECATED in the reference, kept for parity
        self.serial_number: int | None = None  # Ogg; random when unset (main.c:1852)
        self.channel_map_none = False  # --channel-map=none (main.c:722-725)
        self.cued_seekpoints = True  # main.c:582
        self.align_reservoir = None  # --sector-align carry between files
        self.lax = False
        self.ogg = False
        self.verify = False
        self.decode_through_errors = False
        self.warnings_as_errors = False
        # encoder overrides (None = use preset)
        self.blocksize: int | None = None
        self.mid_side: bool | None = None
        self.adaptive_mid_side: bool | None = None
        self.max_lpc_order: int | None = None
        self.qlp_precision: int | None = None
        self.qlp_prec_search: bool | None = None
        self.exhaustive: bool | None = None
        self.escape_coding: bool | None = None
        self.partition_orders: tuple[int, int] | None = None
        self.apodizations: tuple | None = None
        self.do_md5 = True
        self.disable_constant = False
        self.disable_fixed = False
        self.disable_verbatim = False
        # metadata at encode time
        self.seektable_spec: str | None = None  # None => default; "" => none
        self.padding: int | None = None  # None => default, 0 => --no-padding
        self.tags: list[str] = []
        self.cuesheet_file: str | None = None
        self.picture_specs: list[str] = []
        self.keep_foreign = False
        # windowing
        self.skip: str | None = None
        self.until: str | None = None
        self.cue: str | None = None
        # raw format
        self.force_raw = False
        self.raw_endian: str | None = None
        self.raw_sign: str | None = None
        self.raw_channels: int | None = None
        self.raw_bps: int | None = None
        self.raw_rate: int | None = None
        self.input_size: int | None = None
        # decode output format
        self.force_aiff = False
        self.force_rf64 = False
        self.force_w64 = False
        # replaygain
        self.replay_gain = False
        self.apply_rg: dict | None = None
        # analysis
        self.residual_text = False
        self.residual_gnuplot = False
        self.files: list[str] = []
        self.device = None  # the resolved torch device, set by main

    def say(self, level: int, msg: str) -> None:
        if self.verbosity >= level:
            print(msg, file=sys.stderr)


def parse_args(argv: list[str]) -> Options:
    o = Options()
    i = 0
    n = len(argv)

    def need_arg(name: str) -> str:
        nonlocal i
        i += 1
        if i >= n:
            raise CLIError(f"option {name} requires an argument")
        return argv[i]

    while i < n:
        a = argv[i]
        if a == "--":
            o.files.extend(argv[i + 1:])
            break
        if not a.startswith("-") or a == "-":
            o.files.append(a)
            i += 1
            continue
        if a.startswith("--"):
            name, _, inline = a[2:].partition("=")
            val = inline if _ else None

            def arg() -> str:
                return val if val is not None else need_arg("--" + name)

            if name == "help":
                print(USAGE)
                sys.exit(0)
            elif name == "explain":
                print(USAGE)
                print(EXPLAIN)
                sys.exit(0)
            elif name == "version":
                print(f"flac_tpu {VERSION}")
                sys.exit(0)
            elif name == "decode":
                o.mode = "decode"
            elif name == "test":
                o.mode = "test"
            elif name == "analyze":
                o.mode = "analyze"
            elif name == "stdout":
                o.to_stdout = True
            elif name == "silent":
                o.verbosity = 1
            elif name == "totally-silent":
                o.verbosity = 0
            elif name == "force":
                o.force = True
            elif name == "delete-input-file":
                o.delete_input = True
            elif name == "output-name":
                o.output_name = arg()
            elif name == "output-prefix":
                o.output_prefix = arg()
            elif name == "preserve-modtime":
                o.preserve_modtime = True
            elif name == "no-preserve-modtime":
                o.preserve_modtime = False
            elif name == "ignore-chunk-sizes":
                o.ignore_chunk_sizes = True
            elif name == "no-ignore-chunk-sizes":
                o.ignore_chunk_sizes = False
            elif name == "sector-align":
                o.sector_align = True
            elif name == "no-sector-align":
                o.sector_align = False
            elif name == "serial-number":
                o.serial_number = int(arg())
            elif name == "channel-map":
                if arg() != "none":
                    raise CLIError("only --channel-map=none currently supported")
                o.channel_map_none = True
            elif name == "no-cued-seekpoints":
                o.cued_seekpoints = False
            elif name == "no-utf8-convert":
                pass  # tags are native unicode here; accepted for parity
            elif name == "warnings-as-errors":
                o.warnings_as_errors = True
            elif name == "lax":
                o.lax = True
            elif name == "ogg":
                o.ogg = True
            elif name == "verify":
                o.verify = True
            elif name == "decode-through-errors":
                o.decode_through_errors = True
            elif name == "compression-level-0":
                o.level = 0
            elif name and name.startswith("compression-level-"):
                o.level = int(name.rsplit("-", 1)[1])
            elif name == "fast":
                o.level = 0
            elif name == "best":
                o.level = 8
            elif name == "blocksize":
                o.blocksize = int(arg())
            elif name == "mid-side":
                o.mid_side = True
            elif name == "no-mid-side":
                o.mid_side = False
            elif name == "adaptive-mid-side":
                o.adaptive_mid_side = True
            elif name == "no-adaptive-mid-side":
                o.adaptive_mid_side = False
            elif name == "max-lpc-order":
                o.max_lpc_order = int(arg())
            elif name == "qlp-coeff-precision":
                o.qlp_precision = int(arg())
            elif name == "qlp-coeff-precision-search":
                o.qlp_prec_search = True
            elif name == "no-qlp-coeff-prec-search":
                o.qlp_prec_search = False
            elif name == "exhaustive-model-search":
                o.exhaustive = True
            elif name == "no-exhaustive-model-search":
                o.exhaustive = False
            elif name == "escape-coding":
                o.escape_coding = True
            elif name == "no-escape-coding":
                o.escape_coding = False
            elif name == "rice-partition-order":
                o.partition_orders = _parse_partition_order(arg())
            elif name == "apodization":
                o.apodizations = _parse_apodization(arg())
            elif name == "no-md5-sum":
                o.do_md5 = False
            elif name == "disable-constant-subframes":
                o.disable_constant = True
            elif name == "disable-fixed-subframes":
                o.disable_fixed = True
            elif name == "disable-verbatim-subframes":
                o.disable_verbatim = True
            elif name == "seekpoint":
                o.seektable_spec = ((o.seektable_spec + ";") if o.seektable_spec
                                    else "") + arg()
            elif name == "no-seektable":
                o.seektable_spec = ""
            elif name == "padding":
                o.padding = int(arg())
            elif name == "no-padding":
                o.padding = 0
            elif name == "tag":
                o.tags.append(arg())
            elif name == "tag-from-file":
                spec = arg()
                tag_name, _, fname = spec.partition("=")
                if not _:
                    raise CLIError("--tag-from-file needs NAME=FILENAME")
                with open(fname, encoding="utf-8") as f:
                    o.tags.append(f"{tag_name}={f.read().rstrip()}")
            elif name == "cuesheet":
                o.cuesheet_file = arg()
            elif name == "picture":
                o.picture_specs.append(arg())
            elif name == "keep-foreign-metadata":
                o.keep_foreign = True
            elif name == "replay-gain":
                o.replay_gain = True
            elif name == "apply-replaygain-which-is-not-lossless":
                o.apply_rg = _parse_rg_spec(val)
            elif name == "skip":
                o.skip = arg()
            elif name == "until":
                o.until = arg()
            elif name == "cue":
                o.cue = arg()
            elif name == "force-raw-format":
                o.force_raw = True
            elif name == "endian":
                o.raw_endian = arg()
            elif name == "sign":
                o.raw_sign = arg()
            elif name == "channels":
                o.raw_channels = int(arg())
            elif name == "bps":
                o.raw_bps = int(arg())
            elif name == "sample-rate":
                o.raw_rate = int(arg())
            elif name == "input-size":
                o.input_size = int(arg())
            elif name == "force-aiff-format":
                o.force_aiff = True
            elif name == "force-rf64-format":
                o.force_rf64 = True
            elif name == "force-wave64-format":
                o.force_w64 = True
            elif name == "residual-text":
                o.residual_text = True
            elif name == "residual-gnuplot":
                o.residual_gnuplot = True
            elif name == "no-ogg":
                o.ogg = False
            elif name in ("no-verify", "no-lax"):
                setattr(o, "verify" if name == "no-verify" else "lax", False)
            # remaining negations from the reference option table
            # (src/flac/main.c:97-222): later flags override earlier ones
            elif name == "no-decode-through-errors":
                o.decode_through_errors = False
            elif name == "no-delete-input-file":
                o.delete_input = False
            elif name == "no-force":
                o.force = False
            elif name == "no-keep-foreign-metadata":
                o.keep_foreign = False
            elif name == "no-replay-gain":
                o.replay_gain = False
            elif name == "no-residual-gnuplot":
                o.residual_gnuplot = False
            elif name == "no-residual-text":
                o.residual_text = False
            elif name == "no-silent":
                o.verbosity = 2
            elif name == "no-warnings-as-errors":
                o.warnings_as_errors = False
            else:
                raise CLIError(f"unknown option --{name}")
        else:
            # short options, possibly clustered
            j = 1
            while j < len(a):
                c = a[j]
                if c.isdigit():
                    o.level = int(c)
                elif c == "d":
                    o.mode = "decode"
                elif c == "t":
                    o.mode = "test"
                elif c == "a":
                    o.mode = "analyze"
                elif c == "c":
                    o.to_stdout = True
                elif c == "s":
                    o.verbosity = 1
                elif c == "f":
                    o.force = True
                elif c == "m":
                    o.mid_side = True
                elif c == "M":
                    o.adaptive_mid_side = True
                elif c == "e":
                    o.exhaustive = True
                elif c == "E":
                    o.escape_coding = True
                elif c == "p":
                    o.qlp_prec_search = True
                elif c == "V":
                    o.verify = True
                elif c == "F":
                    o.decode_through_errors = True
                elif c == "h":
                    print(USAGE)
                    sys.exit(0)
                elif c == "H":
                    print(USAGE)
                    print(EXPLAIN)
                    sys.exit(0)
                elif c == "v":
                    print(f"flac_tpu {VERSION}")
                    sys.exit(0)
                elif c in "oblqrASTP":
                    # short options with a required argument
                    rest = a[j + 1 :]
                    argval = rest if rest else need_arg("-" + c)
                    if c == "o":
                        o.output_name = argval
                    elif c == "b":
                        o.blocksize = int(argval)
                    elif c == "l":
                        o.max_lpc_order = int(argval)
                    elif c == "q":
                        o.qlp_precision = int(argval)
                    elif c == "r":
                        o.partition_orders = _parse_partition_order(argval)
                    elif c == "A":
                        o.apodizations = _parse_apodization(argval)
                    elif c == "S":
                        if argval == "-":
                            o.seektable_spec = ""
                        else:
                            o.seektable_spec = ((o.seektable_spec + ";")
                                                if o.seektable_spec else "") + argval
                    elif c == "T":
                        o.tags.append(argval)
                    elif c == "P":
                        o.padding = 0 if argval == "-" else int(argval)
                    j = len(a)
                    break
                else:
                    raise CLIError(f"unknown option -{c}")
                j += 1
        i += 1
    return o


def _parse_rg_spec(s: str | None) -> dict:
    """[preamp-dB][a|t][l|L][n{0..3}] (main.c:697-721). With no argument the
    defaults are album gain + hard limiter + low noise shaping (main.c:540-543);
    giving an argument resets limiter/shaping to none (main.c:701-703) but
    leaves the album-gain default in place."""
    import re
    if s is None:
        return dict(preamp=0.0, album=True, limiter="hard", noise_shaping=1)
    spec = dict(preamp=0.0, album=True, limiter="none", noise_shaping=0)
    m = re.match(r"[-+]?\d*\.?\d*", s)
    if m and m.group(0) not in ("", "+", "-"):
        spec["preamp"] = float(m.group(0))
    rest = s[m.end():] if m else s
    i = 0
    while i < len(rest):
        c = rest[i]
        if c == "a":
            spec["album"] = True
        elif c == "t":
            spec["album"] = False
        elif c == "l":
            spec["limiter"] = "peak"
        elif c == "L":
            spec["limiter"] = "hard"
        elif c == "n" and i + 1 < len(rest) and rest[i + 1] in "0123":
            spec["noise_shaping"] = int(rest[i + 1])
            i += 1
        else:
            raise CLIError(f"bad --apply-replaygain specification {s!r}")
        i += 1
    return spec


def _parse_partition_order(s: str) -> tuple[int, int]:
    if "," in s:
        lo, hi = s.split(",", 1)
        return int(lo), int(hi)
    return 0, int(s)


def _parse_apodization(s: str) -> tuple:
    """"tukey(0.5);hann;..." — stream_encoder.c:1526-1595; cap 32 windows."""
    from flac_tpu_torch.dsp.windows import parse_apodization_spec
    return parse_apodization_spec(s)


# ---------------------------------------------------------------------------


def _read_input(path: str, o: Options) -> tuple[AudioBuffer, str, bytes]:
    # Containers parse lazily when encoding: samples become a LazyPCM view
    # and file-backed inputs are memory-mapped, so the int32 expansion of a
    # multi-GB input never materializes (encode_file feeds the stream
    # encoder in bounded chunks). Foreign-metadata scans want real bytes.
    lazy = o.mode == "encode" and not o.keep_foreign
    if path == "-":
        data = sys.stdin.buffer.read()
    else:
        import numpy as _np
        try:
            data = (memoryview(_np.memmap(path, dtype=_np.uint8, mode="r"))
                    if lazy and os.path.getsize(path) else None)
        except (OSError, ValueError):
            data = None
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
    if o.input_size:
        data = data[: o.input_size]
    kind = "raw" if o.force_raw else sniff_format(data)
    if isinstance(data, memoryview) and kind in ("flac", "ogg"):
        data = bytes(data)  # codec inputs walk bytes; containers take views
    if kind in ("wav", "rf64"):
        strict = o.mode == "encode" and not o.channel_map_none
        return parse_wav(data, ignore_chunk_sizes=o.ignore_chunk_sizes,
                         strict_channel_mask=strict, lazy=lazy), kind, data
    if kind == "w64":
        return parse_w64(data, lazy=lazy), kind, data
    if kind == "aiff":
        return parse_aiff(data, ignore_chunk_sizes=o.ignore_chunk_sizes,
                          lazy=lazy), kind, data
    if kind == "flac":
        from flac_tpu_torch.decode.stream import decode_bytes_device
        pcm, si, _ = decode_bytes_device(data, device=o.device)
        return AudioBuffer(samples=pcm, sample_rate=si.sample_rate,
                           bits_per_sample=si.bits_per_sample), kind, data
    if kind == "ogg":
        from flac_tpu_torch.ogg import decode_ogg_flac
        pcm, si, _meta = decode_ogg_flac(data, device=o.device)
        return AudioBuffer(samples=pcm, sample_rate=si.sample_rate,
                           bits_per_sample=si.bits_per_sample), kind, data
    if kind == "raw":
        if not (o.raw_channels and o.raw_bps and o.raw_rate):
            raise CLIError("raw input requires --channels, --bps and --sample-rate")
        return parse_raw(data, channels=o.raw_channels, bits_per_sample=o.raw_bps,
                         sample_rate=o.raw_rate,
                         is_big_endian=o.raw_endian == "big",
                         is_unsigned=o.raw_sign == "unsigned",
                         lazy=lazy), kind, data
    raise CLIError(f"unsupported input format {kind}")


def _default_outname(path: str, o: Options) -> str:
    base = os.path.basename(path)
    stem = base.rsplit(".", 1)[0] if "." in base else base
    d = os.path.dirname(path)
    if o.mode == "encode":
        ext = ".oga" if o.ogg else ".flac"
    elif o.force_raw:
        ext = ".raw"
    elif o.force_aiff:
        ext = ".aiff"
    elif o.force_rf64:
        ext = ".rf64"
    elif o.force_w64:
        ext = ".w64"
    else:
        ext = ".wav"
    if path == "-":
        # stdin input (or --stdout) streams to stdout (main.c:2165-2167)
        return "-"
    name = os.path.join(d, stem + ext)
    if o.output_prefix:
        # the reference prepends the prefix string to the output filename
        # verbatim (main.c get_outfilename)
        name = o.output_prefix + name
    return name


def _copy_modtime(src: str, dst: str) -> None:
    """--preserve-modtime: output keeps the input's timestamps (the analog of
    grabbag__file_copy_metadata, src/share/grabbag/file.c)."""
    try:
        st = os.stat(src)
        os.utime(dst, (st.st_atime, st.st_mtime))
    except OSError:
        pass


# space --replay-gain reserves inside PADDING for the tags added after the
# encode (GRABBAG__REPLAYGAIN_MAX_TAG_SPACE_REQUIRED, grabbag/replaygain.c:54)
_RG_MAX_TAG_SPACE = 190


def _warn(o: Options, msg: str) -> None:
    """Reference warning semantics: printed at normal verbosity, fatal under
    -w/--warnings-as-errors (encode.c treat_warnings_as_errors checks)."""
    o.say(1, msg)
    if o.warnings_as_errors:
        raise CLIError("treating warning as error (-w)")


def _parse_cuesheet_opt(o: Options, buf: AudioBuffer, total: int):
    from flac_tpu_torch.grabbag import cuesheet_parse

    if not o.cuesheet_file:
        return None
    with open(o.cuesheet_file, encoding="utf-8") as f:
        text = f.read()
    # CDDA = mono/stereo 16-bit 44.1kHz (encode.c:1745)
    is_cdda = (buf.channels in (1, 2) and buf.bits_per_sample == 16
               and buf.sample_rate == 44100)
    return cuesheet_parse(text, buf.sample_rate, is_cdda, total)


def _seek_template_points(spec: str, total: int, sample_rate: int, cuesheet,
                          cued: bool):
    """Seek-table template from an -S spec plus the cuesheet's track-index
    points (convert_to_seek_table_template, encode.c:2214-2228;
    --no-cued-seekpoints disables the latter)."""
    from flac_tpu_torch.grabbag import seektable_from_specification
    from flac_tpu_torch.grabbag.seektable import PLACEHOLDER
    from flac_tpu_torch.metadata import SeekPoint

    points = []
    if spec:
        points, _ = seektable_from_specification(spec, total, sample_rate)
    if cuesheet is not None and cued:
        for tr in cuesheet.tracks:
            for ix in tr.indices:
                points.append(SeekPoint(tr.offset + ix.offset, 0, 0))
        real = sorted({p.sample_number for p in points
                       if p.sample_number != PLACEHOLDER})
        nplace = sum(1 for p in points if p.sample_number == PLACEHOLDER)
        points = ([SeekPoint(s, 0, 0) for s in real]
                  + [SeekPoint(PLACEHOLDER, 0, 0)] * nplace)
    return points


def _default_padding(o: Options, total: int, sample_rate: int) -> int:
    # FLAC_ENCODE__DEFAULT_PADDING, x8 for inputs over 20 minutes
    # (encode.c:121,1986)
    return 8192 if total // max(sample_rate, 1) < 20 * 60 else 8192 * 8


def _mask_tag(tags: list[str], channel_mask: int) -> list[str]:
    """Replace/append the WAVEFORMATEXTENSIBLE_CHANNEL_MASK tag
    (flac__utils_set_channel_mask_tag, utils.c:279-297)."""
    tags = [t for t in tags if not t.upper().startswith(
        "WAVEFORMATEXTENSIBLE_CHANNEL_MASK=")]
    tags.append(f"WAVEFORMATEXTENSIBLE_CHANNEL_MASK=0x{channel_mask:04X}")
    return tags


def _build_metadata(o: Options, buf: AudioBuffer, total: int, kind: str,
                    fm=None):
    """Metadata for a non-FLAC input, in the reference's emission order:
    SEEKTABLE, CUESHEET, VORBIS_COMMENT (always present), PICTUREs, foreign
    APPLICATION blocks, PADDING (encode.c:2010-2048 static_metadata_append
    sequence)."""
    from flac_tpu_torch.grabbag import picture_from_specification
    from flac_tpu_torch.metadata import Application, Padding, SeekTable, VorbisComment

    blocks = []
    cuesheet = _parse_cuesheet_opt(o, buf, total)
    spec = "10s" if o.seektable_spec is None else o.seektable_spec
    points = _seek_template_points(spec, total, buf.sample_rate, cuesheet,
                                   o.cued_seekpoints)
    if points:
        # the StreamEncoder adopts a user-supplied SEEKTABLE and fills it
        # in during writes, so don't also pass a seekpoints list
        blocks.append(SeekTable(points=points))
    if cuesheet is not None:
        blocks.append(cuesheet)
    tags = list(o.tags)
    if buf.channel_mask:
        # WAVEFORMATEXTENSIBLE inputs carry their speaker mask through a
        # vorbis tag so decode can rebuild the same fmt chunk
        tags = _mask_tag(tags, buf.channel_mask)
    # the reference CLI always supplies a VORBIS_COMMENT, even with no tags
    # (encode.c:2026); the encoder stamps the vendor string
    blocks.append(VorbisComment(vendor_string="", comments=tags))
    for spec_ in o.picture_specs:
        blocks.append(picture_from_specification(spec_))
    if fm is not None:
        # one APPLICATION block per stored container chunk, in file order
        # (foreign_metadata.c read_from_*_; encode.c:2029-2040 reserves the
        # space, flac__foreign_metadata_write_to_flac fills it)
        for chunk_bytes in fm.blocks:
            blocks.append(Application(app_id=fm.app_id, data=chunk_bytes))
    if o.padding is None or o.padding > 0:
        pad = o.padding if o.padding else _default_padding(o, total,
                                                           buf.sample_rate)
        pad += _RG_MAX_TAG_SPACE if o.replay_gain else 0
        blocks.append(Padding(length=pad))
    return blocks, None, cuesheet


def _build_metadata_from_flac(o: Options, buf: AudioBuffer, total: int,
                              input_blocks: list, inbase: str):
    """flac-to-flac (and Ogg-FLAC-to-flac) re-encode: the input FLAC's
    metadata is the basis for the output's (encode.c:1783-2009, the
    test_flac.sh:1176-1240 case00a-04e semantics):

    - --picture blocks are appended after the input's blocks;
    - VORBIS_COMMENT: the input's is kept unless -T tags were given (replaced
      with a warning, propagating any channel-mask tag) or absent (a new
      block is created); new blocks are prepended;
    - CUESHEET: --cuesheet replaces with a warning; an existing cuesheet is
      kept only while the encoded length still matches its lead-out offset;
    - SEEKTABLE: dropped when any -S was given or the encoded length changes;
      a new table is prepended for -S specs, or for the default spec when
      none survived (-S- suppresses);
    - PADDING: all input PADDING blocks aggregate into one at the end (sum of
      lengths); -P overrides the size; --no-padding drops padding entirely.

    New blocks are prepended right after STREAMINFO in reverse (VC, then
    CUESHEET, then SEEKTABLE), so a fully rebuilt header reads SEEKTABLE,
    CUESHEET, VORBIS_COMMENT — the same order the from-scratch path emits.
    """
    from flac_tpu_torch.grabbag import picture_from_specification
    from flac_tpu_torch.metadata import (
        CueSheet,
        Padding,
        SeekTable,
        StreamInfo,
        VorbisComment,
    )

    input_si = next(b for b in input_blocks if isinstance(b, StreamInfo))
    blocks = [b for b in input_blocks if not isinstance(b, StreamInfo)]

    # pictures: simply appended (encode.c:1788-1801)
    for spec_ in o.picture_specs:
        blocks.append(picture_from_specification(spec_))

    # VORBIS_COMMENT (encode.c:1803-1846)
    tags = list(o.tags)
    channel_mask = buf.channel_mask or 0
    vc_found = False
    kept = []
    for b in blocks:
        if isinstance(b, VorbisComment):
            vc_found = True
            if tags:
                m = b.find_entry("WAVEFORMATEXTENSIBLE_CHANNEL_MASK")
                if m:
                    try:
                        channel_mask = int(m, 16)
                    except ValueError:
                        pass
                _warn(o, f"{inbase}: WARNING, replacing tags from input FLAC "
                         "file with those given on the command-line")
                continue
        kept.append(b)
    blocks = kept
    new_vc = None
    if not vc_found or tags:
        if channel_mask:
            tags = _mask_tag(tags, channel_mask)
        new_vc = VorbisComment(vendor_string="", comments=tags)

    # CUESHEET (encode.c:1848-1905)
    cuesheet = _parse_cuesheet_opt(o, buf, total)
    kept = []
    for b in blocks:
        if isinstance(b, CueSheet):
            if cuesheet is not None:
                _warn(o, f"{inbase}: WARNING, replacing cuesheet in input "
                         "FLAC file with the one given on the command-line")
                continue
            if not b.tracks or total != b.tracks[-1].offset:
                _warn(o, f"{inbase}: WARNING, lead-out offset of cuesheet in "
                         "input FLAC file does not match input length, "
                         "dropping existing cuesheet...")
                continue
        kept.append(b)
    blocks = kept

    # SEEKTABLE (encode.c:1907-1964); requested: -1 = no -S given,
    # 0 = -S- (--no-seektable), 1 = one or more -S specs
    requested = (-1 if o.seektable_spec is None
                 else (0 if o.seektable_spec == "" else 1))
    existing_seektable = False
    kept = []
    for b in blocks:
        if isinstance(b, SeekTable):
            if total != input_si.total_samples or requested >= 0:
                if requested > 0:
                    _warn(o, f"{inbase}: WARNING, replacing seektable in "
                             "input FLAC file with the one given on the "
                             "command-line")
                elif requested < 0:
                    _warn(o, f"{inbase}: WARNING, can't use existing "
                             "seektable in input FLAC since the input size "
                             "is changing or unknown, dropping existing "
                             "SEEKTABLE block...")
                # -S- deletes silently
                continue
            existing_seektable = True
        kept.append(b)
    blocks = kept
    new_st = None
    if requested > 0 or (requested < 0 and not existing_seektable):
        spec = o.seektable_spec if requested > 0 else "10s"
        points = _seek_template_points(spec, total, buf.sample_rate, cuesheet,
                                       o.cued_seekpoints)
        if points:
            new_st = SeekTable(points=points)

    # PADDING: aggregate existing into one trailing block (encode.c:1966-2003)
    pad = -1
    kept = []
    for b in blocks:
        if isinstance(b, Padding):
            pad = max(pad, 0) + b.length
            continue
        kept.append(b)
    blocks = kept
    if o.padding is not None and o.padding > 0:
        pad = o.padding
    if pad < 0:
        pad = _default_padding(o, total, buf.sample_rate)
    if pad > 0 and o.replay_gain:
        pad += _RG_MAX_TAG_SPACE

    head = [b for b in (new_st, cuesheet, new_vc) if b is not None]
    tail = [Padding(length=pad)] if (o.padding != 0 and pad > 0) else []
    return head + blocks + tail, None, cuesheet


def encode_one(path: str, o: Options, is_last: bool = True) -> int:
    import numpy as np

    from flac_tpu_torch.cli.specs import parse_cue, resolve_cue, resolve_skip_until
    from flac_tpu_torch.encode.encoder import encode_file

    buf, kind, raw_data = _read_input(path, o)
    if o.sector_align:
        if kind in ("flac", "ogg"):
            raise CLIError("--sector-align not supported for FLAC input")
        if (buf.sample_rate, buf.channels, buf.bits_per_sample) != (44100, 2, 16):
            raise CLIError("--sector-align can only be done with 16-bit stereo "
                           "44100 Hz input")
    fm = None
    if o.keep_foreign:
        # gating per main.c:1750-1760
        if path == "-" or o.to_stdout or o.output_name == "-":
            raise CLIError("--keep-foreign-metadata cannot be used when "
                           "encoding from stdin or to stdout")
        if kind not in ("wav", "rf64", "w64", "aiff"):
            raise CLIError("--keep-foreign-metadata can only be used with "
                           "WAVE, Wave64, RF64, or AIFF input")
        from flac_tpu_torch.cli.foreign import ForeignError, scan_container
        try:
            fm = scan_container(raw_data, kind)
        except ForeignError as e:
            raise CLIError(str(e))
    total = buf.nsamples
    skip, until = resolve_skip_until(o.skip, o.until, buf.sample_rate, total)
    sig = buf.samples[skip:until]
    if o.sector_align:
        # CD sector alignment (DEPRECATED in the reference; encode.c:1144-1151,
        # 1255-1280, 1459-1497): prepend the previous file's reservoir; hold
        # back total%588 samples for the next file, or zero-pad the last one.
        if o.align_reservoir is not None and len(o.align_reservoir):
            sig = np.concatenate([o.align_reservoir, sig], axis=0)
        rem = len(sig) % 588
        if is_last:
            o.align_reservoir = None
            if rem:
                sig = np.concatenate(
                    [sig, np.zeros((588 - rem, sig.shape[1]), sig.dtype)], axis=0)
        else:
            o.align_reservoir = sig[len(sig) - rem:] if rem else None
            if rem:
                sig = sig[: len(sig) - rem]
    if kind in ("flac", "ogg"):
        # re-encode: the input FLAC's own metadata is the basis
        from flac_tpu_torch.metadata import parse_metadata
        from flac_tpu_torch.metadata.iterators import _find_stream_start

        if kind == "ogg":
            from flac_tpu_torch.ogg import flac_stream_from_ogg
            native = flac_stream_from_ogg(bytes(raw_data))
        else:
            native = bytes(raw_data)
        in_blocks, _ = parse_metadata(native, _find_stream_start(native) + 4)
        blocks, seekpoints, _ = _build_metadata_from_flac(
            o, buf, len(sig), in_blocks, os.path.basename(path))
    else:
        blocks, seekpoints, _ = _build_metadata(o, buf, len(sig), kind, fm)

    overrides: dict = {}
    if o.mid_side is not None:
        overrides["do_mid_side"] = o.mid_side
        if not o.mid_side:
            overrides["loose_mid_side"] = False
    if o.adaptive_mid_side is not None:
        overrides["loose_mid_side"] = o.adaptive_mid_side
        if o.adaptive_mid_side:
            overrides["do_mid_side"] = True
    if o.max_lpc_order is not None:
        overrides["max_lpc_order"] = o.max_lpc_order
    if o.qlp_precision is not None:
        overrides["qlp_coeff_precision"] = o.qlp_precision
    if o.qlp_prec_search is not None:
        overrides["do_qlp_coeff_prec_search"] = o.qlp_prec_search
    if o.exhaustive is not None:
        overrides["do_exhaustive_model_search"] = o.exhaustive
    if o.escape_coding is not None:
        overrides["do_escape_coding"] = o.escape_coding
    if o.partition_orders is not None:
        overrides["min_partition_order"] = o.partition_orders[0]
        overrides["max_partition_order"] = o.partition_orders[1]
    if o.apodizations is not None:
        overrides["apodizations"] = o.apodizations
    if o.lax:
        overrides["streamable_subset"] = False
    if o.disable_constant:
        overrides["disable_constant_subframes"] = True
    if o.disable_fixed:
        overrides["disable_fixed_subframes"] = True
    if o.disable_verbatim:
        overrides["disable_verbatim_subframes"] = True

    out_path = o.output_name or _default_outname(path, o)
    to_stdout = o.to_stdout or out_path == "-"
    if to_stdout:
        import tempfile
        fd, out_path = tempfile.mkstemp(suffix=".flac")
        os.close(fd)
    elif os.path.exists(out_path) and not o.force and os.path.abspath(out_path) != os.path.abspath(path):
        raise CLIError(f"output file {out_path} exists; use -f to override")

    if o.ogg:
        from flac_tpu_torch.ogg import encode_ogg_flac
        if o.serial_number is None:
            # random first serial, then increment per file (main.c:1852-1856)
            import random
            o.serial_number = random.randrange(0, 1 << 31)
        serial = o.serial_number
        o.serial_number += 1
        sig = np.asarray(sig)  # the Ogg encoder takes a realized array
        data = encode_ogg_flac(sig, buf.sample_rate, buf.bits_per_sample,
                               level=o.level, blocksize=o.blocksize,
                               metadata=blocks, verify=o.verify, serial=serial,
                               device=o.device, **overrides)
        with open(out_path, "wb") as f:
            f.write(data)
        stats_bytes = len(data)
    else:
        stats = encode_file(sig, buf.sample_rate, buf.bits_per_sample, out_path,
                            level=o.level, blocksize=o.blocksize, metadata=blocks,
                            seekpoints=seekpoints, verify=o.verify,
                            do_md5=o.do_md5, device=o.device, **overrides)
        stats_bytes = stats.bytes_written

    if to_stdout:
        with open(out_path, "rb") as f:
            sys.stdout.buffer.write(f.read())
        os.unlink(out_path)
    elif o.preserve_modtime and path != "-":
        _copy_modtime(path, out_path)
    ratio = stats_bytes / max(sig.size * ((buf.bits_per_sample + 7) // 8), 1)
    o.say(2, f"{os.path.basename(path)}: wrote {stats_bytes} bytes, ratio={ratio:.3f}")
    if o.delete_input and not o.to_stdout and path != "-":
        os.unlink(path)
    return 0


def _decode_window(o: Options, data: bytes):
    """Decode with --skip/--until/--cue applied; returns (pcm, streaminfo)."""
    from flac_tpu_torch.cli.specs import parse_cue, resolve_cue, resolve_skip_until
    from flac_tpu_torch.decode.stream import decode_bytes_device
    from flac_tpu_torch.metadata import CueSheet

    if o.cue or o.skip or o.until:
        from flac_tpu_torch.decode.seek import SeekableDecoder
        dec = SeekableDecoder(data, device=o.device)
        si = dec.streaminfo
        total = si.total_samples
        if o.cue:
            cs = next((b for b in dec.metadata if isinstance(b, CueSheet)), None)
            if cs is None:
                raise CLIError("--cue requires a CUESHEET block in the stream")
            skip, until = resolve_cue(parse_cue(o.cue), cs, total)
        else:
            skip, until = resolve_skip_until(o.skip, o.until, si.sample_rate, total)
        pcm = dec.decode_range(skip, until - skip)
        return pcm, si
    if o.decode_through_errors:
        # -F: device decode with reference concealment semantics — corrupt
        # frames come back zeroed (only those frames demote to the host
        # decoder), parse failures resync, MD5 mismatch is a warning
        pcm, si, info = decode_bytes_device(data, continue_on_error=True,
                                            device=o.device)
        for err in info.get("errors", []):
            o.say(1, f"WARNING: error while decoding ({err})")
        return pcm, si
    pcm, si, _info = decode_bytes_device(data, device=o.device)
    return pcm, si


def _channel_mask_tag(meta_blocks) -> int:
    """WAVEFORMATEXTENSIBLE_CHANNEL_MASK tag restores the source speaker
    mask (flac__utils_get_channel_mask_tag, decode.c:1359)."""
    from flac_tpu_torch.metadata import VorbisComment
    for b in meta_blocks:
        if isinstance(b, VorbisComment):
            for c in b.comments:
                name, _, val = c.partition("=")
                if (name.upper() == "WAVEFORMATEXTENSIBLE_CHANNEL_MASK"
                        and val[:2].lower() == "0x"):
                    return int(val, 16)
    return 0


def _decode_streaming(path: str, data: bytes, o: Options, dec=None) -> int | None:
    """Constant-memory decode: write container headers up front (sizes from
    STREAMINFO total_samples), stream PCM blocks from the batched device
    decoder, fix the headers up if the stream delivered a different count
    (the reference does the same, decode.c:119-128). Returns None when this
    fast path doesn't apply (windowing/RG/foreign restore/-F/unknown length
    stay on the assembled path).

    `dec` may be a pre-built decoder-like object (streaminfo/metadata/
    iter_blocks) — the stdin pipe path passes a ChunkedStreamDecoder so
    the COMPRESSED side stays bounded too."""
    if (o.apply_rg is not None or o.cue or o.skip or o.until
            or o.decode_through_errors or o.keep_foreign):
        return None
    from flac_tpu_torch.containers import (aiff_header_bytes, aiff_trailer_bytes,
                                     w64_header_bytes, w64_trailer_bytes,
                                     wav_header_bytes, wav_trailer_bytes)
    from flac_tpu_torch.containers.aiff import _aiff_pcm_bytes
    from flac_tpu_torch.containers.wav import _wav_pcm_bytes
    from flac_tpu_torch.decode.stream import StreamDecoder

    if dec is None:
        dec = StreamDecoder(data, device=o.device)
    si = dec.streaminfo
    total = si.total_samples
    if not total:
        return None  # header sizes unknown up front: assemble instead
    ch, bits, rate = si.channels, si.bits_per_sample, si.sample_rate
    channel_mask = _channel_mask_tag(dec.metadata)

    def _ab(block):
        return AudioBuffer(samples=block, sample_rate=rate, bits_per_sample=bits)

    if o.force_raw:
        header = lambda n: b""
        trailer = lambda n: b""
        blk = lambda b: raw_bytes(_ab(b), is_big_endian=o.raw_endian == "big",
                                  is_unsigned=o.raw_sign == "unsigned")
    elif o.force_aiff:
        header = lambda n: aiff_header_bytes(n, ch, bits, rate)
        trailer = lambda n: aiff_trailer_bytes(n, ch, bits)
        blk = lambda b: _aiff_pcm_bytes(_ab(b))
    elif o.force_rf64 or o.force_w64:
        rf64 = o.force_rf64
        header = (lambda n: wav_header_bytes(n, ch, bits, rate,
                                             channel_mask=channel_mask,
                                             rf64=True)) if rf64 else \
                 (lambda n: w64_header_bytes(n, ch, bits, rate,
                                             channel_mask=channel_mask))
        trailer = (lambda n: wav_trailer_bytes(n, ch, bits)) if rf64 else \
                  (lambda n: w64_trailer_bytes(n, ch, bits))
        blk = lambda b: _wav_pcm_bytes(_ab(b))
    else:
        header = lambda n: wav_header_bytes(n, ch, bits, rate,
                                            channel_mask=channel_mask)
        trailer = lambda n: wav_trailer_bytes(n, ch, bits)
        blk = lambda b: _wav_pcm_bytes(_ab(b))

    out_path = o.output_name or _default_outname(path, o)
    to_stdout = o.to_stdout or out_path == "-"
    if not to_stdout and os.path.exists(out_path) and not o.force:
        raise CLIError(f"output file {out_path} exists; use -f to override")
    f = sys.stdout.buffer if to_stdout else open(out_path, "wb")
    emitted = 0
    try:
        f.write(header(total))
        for block in dec.iter_blocks():
            f.write(blk(block))
            emitted += len(block)
        f.write(trailer(emitted))
        if emitted != total:
            # short/long stream vs STREAMINFO: rewrite the headers with the
            # real count (same length — sizes are the only fields that
            # change); the reference fixes headers up the same way
            if to_stdout:
                o.say(1, f"WARNING: decoded {emitted} samples, STREAMINFO "
                         f"said {total}; stdout headers not rewritten")
            else:
                f.seek(0)
                f.write(header(emitted))
    except Exception:
        if not to_stdout:
            f.close()
            try:
                os.unlink(out_path)  # match the assembled path: error => no file
            except OSError:
                pass
        raise
    if not to_stdout:
        f.close()
        if o.preserve_modtime and path != "-":
            _copy_modtime(path, out_path)
        o.say(2, f"{os.path.basename(path)}: done")
    if o.delete_input and path != "-":
        os.unlink(path)
    return 0


def _stdin_chunked(o: Options):
    """Bounded-memory stdin consumption: when the chunked fast path applies
    (native FLAC, known length, no windowing/RG/foreign), decode_one never
    holds more than a window of the pipe (reference: the read-callback
    decoder, stream_decoder.c:1034-1160). Returns (rc, None) when the
    chunked path completed, else (None, data) with stdin fully drained for
    the assembled path."""
    from flac_tpu_torch.decode.streaming import ByteFeed, ChunkedStreamDecoder

    feed = ByteFeed(sys.stdin.buffer)
    feed.ensure(4)
    magic = bytes(feed.view()[:4])
    dec = None
    if magic[:3] == b"ID3" or magic == b"fLaC":
        try:
            dec = ChunkedStreamDecoder(feed, device=o.device)
        except DEVICE_FAULTS:
            raise
        except Exception:
            dec = None  # malformed header: assembled path owns the error
    elif magic == b"OggS":
        # incremental page demux -> native bytes, still O(window)
        from flac_tpu_torch.ogg import OggToNativeReader
        try:
            dec = ChunkedStreamDecoder(OggToNativeReader(feed.read), device=o.device)
        except DEVICE_FAULTS:
            raise
        except Exception:
            dec = None
    if dec is not None and dec.streaminfo.total_samples:
        rc = _decode_streaming("-", b"", o, dec=dec)
        if rc is not None:
            return rc, None
    # drain the pipe for the assembled path (metadata prefix re-attached;
    # an Ogg pipe drains as the DEMUXED native stream, which the assembled
    # path decodes identically)
    drain = dec.feed if dec is not None else feed
    while not drain.eof:
        drain.ensure(len(drain) + (1 << 20))
    data = (dec.meta_prefix if dec is not None else b"") + bytes(drain.view())
    return None, data


def decode_one(path: str, o: Options) -> int:
    if path == "-":
        rc, data = _stdin_chunked(o)
        if rc is not None:
            return rc
    else:
        with open(path, "rb") as f:
            data = f.read()
    if sniff_format(data) == "ogg":
        # unwrap to a native stream so windowing/seek work identically
        from flac_tpu_torch.ogg import flac_stream_from_ogg
        data = flac_stream_from_ogg(data)
    rc = _decode_streaming(path, data, o)
    if rc is not None:
        return rc
    pcm, si = _decode_window(o, data)
    # bps%8!=0 layout: the container writers left-justify into the padded
    # byte width themselves (decode.c:962,1094-1097); raw output stays
    # right-justified (shift=0, decode.c:962). The RG path converts to the
    # padded width inside apply_gain (decode.c:1108) — its output buffer is
    # marked left_justified so writers emit it as-is.
    shift = 0 if o.force_raw else (8 - si.bits_per_sample % 8) % 8
    if o.apply_rg is not None:
        from flac_tpu_torch.replaygain import apply_gain, load_tags
        tags = load_tags(path, album=o.apply_rg["album"]) if path != "-" else None
        if tags is None:
            raise CLIError("no ReplayGain tags found (run --replay-gain / "
                           "metaflac --add-replay-gain first)")
        gain, peak = tags
        # RGSS_LIMIT__PEAK caps the linear scale at 1/peak
        # (grabbag__replaygain_compute_scale_factor, decode.c:1351)
        pcm = apply_gain(pcm, gain, si.bits_per_sample,
                         target_bps=si.bits_per_sample + shift,
                         preamp_db=o.apply_rg["preamp"], peak=peak,
                         prevent_clipping=o.apply_rg["limiter"] == "peak",
                         hard_limit=o.apply_rg["limiter"] == "hard",
                         noise_shaping=o.apply_rg["noise_shaping"],
                         chunk=si.max_blocksize)
    buf = AudioBuffer(samples=pcm, sample_rate=si.sample_rate,
                      bits_per_sample=si.bits_per_sample,
                      left_justified=o.apply_rg is not None and shift > 0)
    try:
        from flac_tpu_torch.metadata import parse_metadata
        meta_blocks, _ = parse_metadata(data, 4)
        channel_mask = _channel_mask_tag(meta_blocks)
    except Exception:
        meta_blocks = []
        channel_mask = 0
    foreign = None
    if o.keep_foreign:
        # gating per main.c:2038-2043; restore chunks stored in APPLICATION
        # blocks ids riff/aiff/w64 (foreign_metadata.c:44,477-643)
        if path == "-" or o.to_stdout or o.output_name == "-":
            raise CLIError("--keep-foreign-metadata cannot be used when "
                           "decoding from stdin or to stdout")
        if o.force_raw:
            raise CLIError("--keep-foreign-metadata can only be used with "
                           "WAVE, Wave64, RF64, or AIFF output")
        from flac_tpu_torch.cli.foreign import (
            APPLICATION_IDS,
            ForeignError,
            from_application_blocks,
        )
        from flac_tpu_torch.metadata import Application
        kind_out = ("aiff" if o.force_aiff else "w64" if o.force_w64
                    else "rf64" if o.force_rf64 else "wav")
        want = APPLICATION_IDS[kind_out]
        datas = [b.data for b in meta_blocks
                 if isinstance(b, Application) and b.app_id == want]
        try:
            foreign = from_application_blocks(datas, kind_out)
        except ForeignError as e:
            raise CLIError(str(e))
    if o.force_raw:
        out = raw_bytes(buf, is_big_endian=o.raw_endian == "big",
                        is_unsigned=o.raw_sign == "unsigned")
    elif o.force_aiff:
        out = aiff_bytes(buf, foreign=foreign)
    elif o.force_rf64:
        from flac_tpu_torch.containers import rf64_bytes
        out = rf64_bytes(buf, foreign=foreign, channel_mask=channel_mask)
    elif o.force_w64:
        out = w64_bytes(buf, foreign=foreign, channel_mask=channel_mask)
    else:
        out = wav_bytes(buf, foreign=foreign, channel_mask=channel_mask)
    out_path = o.output_name or _default_outname(path, o)
    if o.to_stdout or out_path == "-":
        sys.stdout.buffer.write(out)
    else:
        if os.path.exists(out_path) and not o.force:
            raise CLIError(f"output file {out_path} exists; use -f to override")
        with open(out_path, "wb") as f:
            f.write(out)
        if o.preserve_modtime and path != "-":
            _copy_modtime(path, out_path)
        o.say(2, f"{os.path.basename(path)}: done")
    if o.delete_input and path != "-":
        os.unlink(path)
    return 0


def test_one(path: str, o: Options) -> int:
    from flac_tpu_torch.decode.stream import StreamDecoder

    if path == "-":
        # full CRC/MD5 verification of a pipe in bounded memory on BOTH
        # sides (compressed window + PCM batch)
        from flac_tpu_torch.decode.streaming import ByteFeed, ChunkedStreamDecoder

        feed = ByteFeed(sys.stdin.buffer)
        feed.ensure(4)
        try:
            if bytes(feed.view()[:4]) == b"OggS":
                from flac_tpu_torch.ogg import OggToNativeReader
                src = OggToNativeReader(feed.read)
            else:
                src = feed
            for _ in ChunkedStreamDecoder(src, device=o.device).iter_blocks():
                pass
        except DEVICE_FAULTS:
            raise
        except Exception as e:
            o.say(1, f"-: FAILED ({e})")
            return 1
        o.say(2, "-: ok")
        return 0
    with open(path, "rb") as f:
        data = f.read()
    try:
        if sniff_format(data) == "ogg":
            from flac_tpu_torch.ogg import decode_ogg_flac
            decode_ogg_flac(data, device=o.device)
        else:
            # stream the blocks and discard them: full CRC/MD5 verification
            # in constant memory
            for _ in StreamDecoder(data, device=o.device).iter_blocks():
                pass
    except DEVICE_FAULTS:
        raise
    except Exception as e:  # CRC/MD5/parse failures
        o.say(1, f"{os.path.basename(path)}: FAILED ({e})")
        return 1
    o.say(2, f"{os.path.basename(path)}: ok")
    return 0


def analyze_one(path: str, o: Options) -> int:
    from flac_tpu_torch.cli.analyze import analyze_frame
    from flac_tpu_torch.decode.host_decoder import HostDecoder

    with open(path, "rb") as f:
        data = f.read()
    if sniff_format(data) == "ogg":
        from flac_tpu_torch.ogg import flac_stream_from_ogg
        data = flac_stream_from_ogg(data)
    keep_res = o.residual_text or o.residual_gnuplot
    dec = HostDecoder(data, check_md5=False, keep_residuals=keep_res)
    if o.to_stdout:
        out = sys.stdout
    else:
        out_path = o.output_name or (path.rsplit(".", 1)[0] + ".ana")
        out = open(out_path, "w")
    try:
        pos = dec.audio_offset
        fno = 0
        # The reference's analysis offsets derive from a decode_position that
        # is updated only at the STREAMINFO metadata callback (decode.c:244,
        # :1078-1080, :1257-1262), so frame 0's printed offset is the end of
        # the STREAMINFO block and its bit count includes any following
        # metadata bytes. Mirror that exactly so .ana files diff clean.
        from flac_tpu_torch.decode.host_decoder import skip_id3v2
        from flac_tpu_torch.metadata import parse_block
        stream_start = skip_id3v2(data, 0)
        _si, decode_position = parse_block(data, stream_start + 4)
        all_stats = None
        if o.residual_gnuplot:
            from flac_tpu_torch.cli.analyze import ResidualStats
            all_stats = ResidualStats()
        while pos < len(data) - 2:
            try:
                _pcm, frame = dec.decode_frame_at(pos)
            except Exception:
                break
            frame_end = frame.offset + frame.size
            frame.offset = decode_position
            frame.size = frame_end - decode_position
            decode_position = frame_end
            analyze_frame(frame, fno, out, residual_text=o.residual_text)
            if all_stats is not None:
                # per-subframe residual distributions (analyze.c:128-158)
                from flac_tpu_torch.cli.analyze import ResidualStats
                for ch, sf in enumerate(frame.subframes):
                    if sf.residual is None:
                        continue
                    st = ResidualStats()
                    st.update(sf.residual)
                    st.dump("f%06u.s%u.gp" % (fno, ch))
                    all_stats.merge(st)
            pos = frame_end
            fno += 1
        if all_stats is not None:
            all_stats.dump("all")  # flac__analyze_finish (analyze.c:167)
    finally:
        if out is not sys.stdout:
            out.close()
    o.say(2, f"{os.path.basename(path)}: done")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # the port's device rule: FLAC_TPU_DEVICE names the torch device; unset
    # means CUDA, which raises without a GPU (nothing drops to the CPU)
    device = resolve_device(os.environ.get("FLAC_TPU_DEVICE") or None)
    try:
        o = parse_args(argv)
        o.device = device
        if not o.files:
            # no files: short usage, success (main.c:344-348); stdin needs
            # an explicit "-" argument
            o.say(1, USAGE)
            return 0
        if len(o.files) > 1 and o.output_name:
            raise CLIError("-o cannot be used with multiple files")
        if o.output_name and o.output_prefix:
            raise CLIError("--output-prefix conflicts with -o/--output-name")
        if o.ignore_chunk_sizes:
            # main.c:402-413
            if o.mode != "encode":
                raise CLIError("--ignore-chunk-sizes only allowed for encoding")
            if o.sector_align:
                raise CLIError("--ignore-chunk-sizes not allowed with --sector-align")
            if o.until:
                raise CLIError("--ignore-chunk-sizes not allowed with --until")
            if o.cue:
                raise CLIError("--ignore-chunk-sizes not allowed with --cue")
            if o.cuesheet_file:
                raise CLIError("--ignore-chunk-sizes not allowed with --cuesheet")
            if o.keep_foreign:
                raise CLIError("--keep-foreign-metadata cannot be used with "
                               "--ignore-chunk-sizes")
        if o.keep_foreign:
            # main.c:1750-1756
            if o.mode == "test":
                raise CLIError("--keep-foreign-metadata is not allowed in "
                               "test mode")
            if o.mode == "analyze":
                raise CLIError("--keep-foreign-metadata is not allowed in "
                               "analyis mode")
        if o.sector_align:
            # main.c:414-429 (deprecated feature, kept for parity)
            if o.mode != "encode":
                raise CLIError("--sector-align only allowed for encoding")
            if o.skip:
                raise CLIError("--sector-align not allowed with --skip")
            if o.until:
                raise CLIError("--sector-align not allowed with --until")
            if o.cue:
                raise CLIError("--sector-align not allowed with --cue")
            if o.raw_channels is not None and o.raw_channels != 2:
                raise CLIError("--sector-align can only be done with stereo input")
            if o.raw_bps is not None and o.raw_bps != 16:
                raise CLIError("--sector-align can only be done with 16-bit samples")
            if o.raw_rate is not None and o.raw_rate != 44100:
                raise CLIError("--sector-align can only be done with a sample "
                               "rate of 44100")
        rc = 0
        encoded_outputs: list[str] = []
        for idx, path in enumerate(o.files):
            try:
                if o.mode == "encode":
                    with trace.span("cli.encode"):
                        rc |= encode_one(path, o, is_last=idx == len(o.files) - 1)
                    if o.replay_gain and not o.to_stdout:
                        encoded_outputs.append(o.output_name or
                                               _default_outname(path, o))
                elif o.mode == "decode":
                    rc |= decode_one(path, o)
                elif o.mode == "test":
                    rc |= test_one(path, o)
                else:
                    rc |= analyze_one(path, o)
            except (CLIError, OSError, ValueError) as e:
                o.say(1, f"{path}: ERROR: {e}")
                rc = 1
        if o.mode == "encode" and o.replay_gain and encoded_outputs and rc == 0:
            # all files of one invocation form one album (main.c:511-518)
            from flac_tpu_torch.replaygain import add_replay_gain_tags
            with trace.span("cli.replaygain"):
                add_replay_gain_tags(encoded_outputs, device=o.device)
        return rc
    except CLIError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
