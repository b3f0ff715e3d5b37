"""`metaflac`-equivalent command line tool.

The analog of src/metaflac/ (option table options.c:40-97, list format
operations.c:554-700): STREAMINFO field display, tag get/set/import/export,
cuesheet and picture import/export, seekpoint templates, padding add/merge/
sort, block remove with number/type filters, and --list whose output is
byte-compatible with the reference's.

Usage: python -m flac_tpu_torch.cli.metaflac [options] [operations] FLACfile [...]
"""

from __future__ import annotations

import os
import sys

from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.metadata import (
    Application,
    CueSheet,
    MetadataChain,
    Padding,
    Picture,
    SeekTable,
    StreamInfo,
    VorbisComment,
)

USAGE = __doc__

METADATA_TYPE_STRING = {
    0: "STREAMINFO", 1: "PADDING", 2: "APPLICATION", 3: "SEEKTABLE",
    4: "VORBIS_COMMENT", 5: "CUESHEET", 6: "PICTURE",
}
TYPE_CODE_FROM_NAME = {v: k for k, v in METADATA_TYPE_STRING.items()}

PICTURE_TYPE_STRING = [
    "Other", "32x32 pixels 'file icon' (PNG only)", "Other file icon",
    "Cover (front)", "Cover (back)", "Leaflet page",
    "Media (e.g. label side of CD)", "Lead artist/lead performer/soloist",
    "Artist/performer", "Conductor", "Band/Orchestra", "Composer",
    "Lyricist/text writer", "Recording Location", "During recording",
    "During performance", "Movie/video screen capture",
    "A bright coloured fish", "Illustration", "Band/artist logotype",
    "Publisher/Studio logotype",
]


class CLIError(Exception):
    pass


def _undocumented_warning(opt: str) -> None:
    # byte-identical to the reference's warning, typo included (options.c:1106)
    sys.stderr.write(
        f"WARNING: undocmented option --{opt} should be used with caution,\n"
        "         only for repairing a damaged STREAMINFO block\n")


def hexdump(buf: bytes, indent: str, out) -> None:
    """Byte-compatible with the reference's hexdump (src/metaflac/utils.c:78)."""
    for i in range(0, len(buf), 16):
        row = buf[i : i + 16]
        hexpart = " ".join(f"{row[j]:02X}" if j < len(row) else "00"
                           for j in range(16))
        asciipart = "".join(
            (chr(row[j]) if 32 <= row[j] < 127 else ".") if j < len(row) else " "
            for j in range(16))
        out.write(f"{indent}{i:08X}: {hexpart} {asciipart}\n")


def _vc_sanitize(s: str) -> str:
    # the reference replaces unprintable characters with '?' (write_vc_field)
    return "".join(ch if ch == "\t" or ord(ch) >= 0x20 else "?" for ch in s)


def list_block(block, index: int, out, application_data_format: str = "hexdump",
               filename: str | None = None) -> None:
    pre = f"{filename}:" if filename else ""
    body = block.body_bytes()
    out.write(f"{pre}METADATA block #{index}\n")
    tc = block.type_code
    tname = METADATA_TYPE_STRING.get(tc, "UNKNOWN")
    out.write(f"{pre}  type: {tc} ({tname})\n")
    out.write(f"{pre}  is last: {'true' if block.is_last else 'false'}\n")
    out.write(f"{pre}  length: {len(body)}\n")
    if isinstance(block, StreamInfo):
        out.write(f"{pre}  minimum blocksize: {block.min_blocksize} samples\n")
        out.write(f"{pre}  maximum blocksize: {block.max_blocksize} samples\n")
        out.write(f"{pre}  minimum framesize: {block.min_framesize} bytes\n")
        out.write(f"{pre}  maximum framesize: {block.max_framesize} bytes\n")
        out.write(f"{pre}  sample_rate: {block.sample_rate} Hz\n")
        out.write(f"{pre}  channels: {block.channels}\n")
        out.write(f"{pre}  bits-per-sample: {block.bits_per_sample}\n")
        out.write(f"{pre}  total samples: {block.total_samples}\n")
        out.write(f"{pre}  MD5 signature: {block.md5sum.hex()}\n")
    elif isinstance(block, Padding):
        pass  # nothing to print
    elif isinstance(block, Application):
        out.write(f"{pre}  application ID: {block.app_id.hex()}\n")
        out.write(f"{pre}  data contents:\n")
        if application_data_format == "hexdump":
            hexdump(block.data, "    ", out)
        else:
            out.write(block.data.decode("utf-8", errors="replace"))
    elif isinstance(block, SeekTable):
        out.write(f"{pre}  seek points: {len(block.points)}\n")
        for i, p in enumerate(block.points):
            if p.is_placeholder:
                out.write(f"{pre}    point {i}: PLACEHOLDER\n")
            else:
                out.write(f"{pre}    point {i}: sample_number={p.sample_number}, "
                          f"stream_offset={p.stream_offset}, "
                          f"frame_samples={p.frame_samples}\n")
    elif isinstance(block, VorbisComment):
        out.write(f"{pre}  vendor string: {_vc_sanitize(block.vendor_string)}\n")
        out.write(f"{pre}  comments: {len(block.comments)}\n")
        for i, cmt in enumerate(block.comments):
            out.write(f"{pre}    comment[{i}]: {_vc_sanitize(cmt)}\n")
    elif isinstance(block, CueSheet):
        mcn = block.media_catalog_number.split(b"\x00")[0].decode("ascii", "replace")
        out.write(f"{pre}  media catalog number: {mcn}\n")
        out.write(f"{pre}  lead-in: {block.lead_in}\n")
        out.write(f"{pre}  is CD: {'true' if block.is_cd else 'false'}\n")
        out.write(f"{pre}  number of tracks: {len(block.tracks)}\n")
        for i, t in enumerate(block.tracks):
            is_last = i == len(block.tracks) - 1
            is_leadout = is_last and not t.indices
            out.write(f"{pre}    track[{i}]\n")
            out.write(f"{pre}      offset: {t.offset}\n")
            if is_last:
                out.write(f"{pre}      number: {t.number} "
                          f"({'LEAD-OUT' if is_leadout else 'INVALID'})\n")
            else:
                out.write(f"{pre}      number: {t.number}\n")
            if not is_leadout:
                isrc = t.isrc.split(b"\x00")[0].decode("ascii", "replace")
                out.write(f"{pre}      ISRC: {isrc}\n")
                out.write(f"{pre}      type: {'DATA' if t.type == 1 else 'AUDIO'}\n")
                out.write(f"{pre}      pre-emphasis: "
                          f"{'true' if t.pre_emphasis else 'false'}\n")
                out.write(f"{pre}      number of index points: {len(t.indices)}\n")
                for j, ix in enumerate(t.indices):
                    out.write(f"{pre}        index[{j}]\n")
                    out.write(f"{pre}          offset: {ix.offset}\n")
                    out.write(f"{pre}          number: {ix.number}\n")
    elif isinstance(block, Picture):
        ptname = (PICTURE_TYPE_STRING[block.picture_type]
                  if block.picture_type < len(PICTURE_TYPE_STRING) else "UNDEFINED")
        out.write(f"{pre}  type: {block.picture_type} ({ptname})\n")
        out.write(f"{pre}  MIME type: {block.mime_type}\n")
        out.write(f"{pre}  description: {block.description}\n")
        out.write(f"{pre}  width: {block.width}\n")
        out.write(f"{pre}  height: {block.height}\n")
        out.write(f"{pre}  depth: {block.depth}\n")
        out.write(f"{pre}  colors: {block.colors}"
                  f"{'' if block.colors else ' (unindexed)'}\n")
        out.write(f"{pre}  data length: {len(block.data)}\n")
        out.write(f"{pre}  data:\n")
        hexdump(block.data, "    ", out)
    else:
        out.write(f"{pre}  data contents:\n")
        hexdump(getattr(block, "data", body), "    ", out)


# ---------------------------------------------------------------------------


def _populate_seekpoints(path: str, st: SeekTable) -> None:
    """Fill in stream_offset/frame_samples by walking the frames, snapping
    each target to the first sample of its containing frame — the analog of
    populate_seekpoint_values (operations_shorthand_seektable.c:108-148)."""
    from flac_tpu_torch.decode.host_decoder import HostDecoder
    from flac_tpu_torch.grabbag import seektable_template_sort
    from flac_tpu_torch.metadata import SeekPoint

    with open(path, "rb") as f:
        data = f.read()
    dec = HostDecoder(data, check_md5=False)
    audio_offset = dec.audio_offset
    pts = seektable_template_sort(st.points, compact=False)
    pos = audio_offset
    samples_written = 0
    i = 0
    while pos < len(data) - 2 and i < len(pts) and not pts[i].is_placeholder:
        try:
            _pcm, fr = dec.decode_frame_at(pos)
        except Exception:
            break
        first, last = samples_written, samples_written + fr.blocksize - 1
        j = i
        while j < len(pts) and not pts[j].is_placeholder:
            t = pts[j].sample_number
            if t > last:
                break
            if t >= first:
                pts[j] = SeekPoint(first, pos - audio_offset, fr.blocksize)
            j += 1
        i = j
        samples_written += fr.blocksize
        pos = fr.offset + fr.size
    st.points = seektable_template_sort(pts)


class Options:
    def __init__(self) -> None:
        self.preserve_modtime = False
        self.with_filename: bool | None = None  # None = auto (>1 file)
        self.no_utf8_convert = False
        self.use_padding = True
        self.block_numbers: set[int] | None = None
        self.block_types: set[int] | None = None
        self.except_block_types: set[int] | None = None
        self.application_data_format = "hexdump"
        self.data_format = "text"  # --data-format (for --list/--append)
        self.from_files: list[str] = []  # --from-file (for --append)
        self.cued_seekpoints = True  # options.c:133,242-250
        self.ops: list[tuple] = []
        self.files: list[str] = []


def _parse_types(val: str) -> set[int]:
    out = set()
    for t in val.split(","):
        t = t.strip().upper()
        if t.isdigit():
            out.add(int(t))
        elif t in TYPE_CODE_FROM_NAME:
            out.add(TYPE_CODE_FROM_NAME[t])
        else:
            raise CLIError(f"unknown block type {t!r}")
    return out


def parse_args(argv: list[str]) -> Options:
    o = Options()
    i = 0
    n = len(argv)
    while i < n:
        a = argv[i]
        if not a.startswith("--"):
            o.files.append(a)
            i += 1
            continue
        name, eq, val = a[2:].partition("=")

        def arg() -> str:
            nonlocal i
            if eq:
                return val
            i_next = i + 1
            if i_next >= n:
                raise CLIError(f"--{name} requires an argument")
            raise CLIError(f"--{name} requires =VALUE syntax")

        simple_shows = {
            "show-md5sum": lambda si: si.md5sum.hex(),
            "show-min-blocksize": lambda si: si.min_blocksize,
            "show-max-blocksize": lambda si: si.max_blocksize,
            "show-min-framesize": lambda si: si.min_framesize,
            "show-max-framesize": lambda si: si.max_framesize,
            "show-sample-rate": lambda si: si.sample_rate,
            "show-channels": lambda si: si.channels,
            "show-bps": lambda si: si.bits_per_sample,
            "show-total-samples": lambda si: si.total_samples,
        }
        simple_sets = {
            # undocumented STREAMINFO repair setters (options.c:56-64,
            # operations_shorthand_streaminfo.c:84-119): set verbatim
            "set-min-blocksize": "min_blocksize",
            "set-max-blocksize": "max_blocksize",
            "set-min-framesize": "min_framesize",
            "set-max-framesize": "max_framesize",
            "set-sample-rate": "sample_rate",
            "set-channels": "channels",
            "set-bps": "bits_per_sample",
            "set-total-samples": "total_samples",
        }
        if name in simple_shows:
            o.ops.append(("show-streaminfo", simple_shows[name]))
        elif name in simple_sets:
            o.ops.append(("set-streaminfo", simple_sets[name], int(arg())))
            _undocumented_warning(name)
        elif name == "set-md5sum":
            v = arg()
            try:
                md5 = bytes.fromhex(v)
                if len(md5) != 16:
                    raise ValueError
            except ValueError:
                raise CLIError(f"bad MD5 sum {v!r}")
            o.ops.append(("set-streaminfo", "md5sum", md5))
            _undocumented_warning(name)
        elif name == "preserve-modtime":
            o.preserve_modtime = True
        elif name == "with-filename":
            o.with_filename = True
        elif name == "no-filename":
            o.with_filename = False
        elif name == "no-utf8-convert":
            o.no_utf8_convert = True
        elif name == "dont-use-padding":
            o.use_padding = False
        elif name == "block-number":
            o.block_numbers = {int(x) for x in arg().split(",")}
        elif name == "block-type":
            o.block_types = _parse_types(arg())
        elif name == "except-block-type":
            o.except_block_types = _parse_types(arg())
        elif name == "application-data-format":
            o.application_data_format = arg()
        elif name == "show-vendor-tag":
            o.ops.append(("show-vendor",))
        elif name == "show-tag":
            o.ops.append(("show-tag", arg()))
        elif name == "remove-tag":
            o.ops.append(("remove-tag", arg(), True))
        elif name == "remove-first-tag":
            o.ops.append(("remove-tag", arg(), False))
        elif name == "remove-all-tags":
            o.ops.append(("remove-all-tags",))
        elif name == "set-tag":
            if "=" not in arg():
                raise CLIError("--set-tag needs NAME=VALUE")
            o.ops.append(("set-tag", arg()))
        elif name == "set-tag-from-file":
            spec = arg()
            tag_name, _, fname = spec.partition("=")
            if not _:
                raise CLIError("--set-tag-from-file needs NAME=FILENAME")
            with open(fname, encoding="utf-8") as f:
                o.ops.append(("set-tag", f"{tag_name}={f.read().rstrip()}"))
        elif name == "import-tags-from":
            o.ops.append(("import-tags", arg()))
        elif name == "export-tags-to":
            o.ops.append(("export-tags", arg()))
        elif name == "import-cuesheet-from":
            o.ops.append(("import-cuesheet", arg()))
        elif name == "export-cuesheet-to":
            o.ops.append(("export-cuesheet", arg()))
        elif name == "import-picture-from":
            o.ops.append(("import-picture", arg()))
        elif name == "export-picture-to":
            o.ops.append(("export-picture", arg()))
        elif name == "add-seekpoint":
            o.ops.append(("add-seekpoint", arg()))
        elif name == "add-padding":
            o.ops.append(("add-padding", int(arg())))
        elif name == "add-replay-gain":
            o.ops.append(("add-replay-gain",))
        elif name == "remove-replay-gain":
            o.ops.append(("remove-replay-gain",))
        elif name == "remove":
            o.ops.append(("remove",))
        elif name == "remove-all":
            o.ops.append(("remove-all",))
        elif name == "merge-padding":
            o.ops.append(("merge-padding",))
        elif name == "sort-padding":
            o.ops.append(("sort-padding",))
        elif name == "list":
            o.ops.append(("list",))
        elif name == "append":
            o.ops.append(("append",))
        elif name == "data-format":
            if arg() not in ("binary", "text"):
                raise CLIError(f"bad data format {val!r}")
            o.data_format = val
        elif name == "from-file":
            o.from_files.append(arg())
        elif name == "no-cued-seekpoints":
            o.cued_seekpoints = False
        elif name == "version":
            from flac_tpu_torch.version import __version__
            print(f"metaflac {__version__}")
            sys.exit(0)
        elif name == "help":
            print(USAGE)
            sys.exit(0)
        else:
            raise CLIError(f"unknown option --{name}")
        i += 1
    return o


def _block_selected(o: Options, idx: int, block) -> bool:
    if o.block_numbers is not None and idx not in o.block_numbers:
        return False
    if o.block_types is not None and block.type_code not in o.block_types:
        return False
    if (o.except_block_types is not None
            and block.type_code in o.except_block_types):
        return False
    return True


def _get_or_make_vc(chain: MetadataChain) -> VorbisComment:
    vc = chain.get(VorbisComment)
    if vc is None:
        vc = VorbisComment(vendor_string="")
        chain.blocks.insert(1, vc)
    return vc


def apply_ops(path: str, o: Options, out, device=None) -> int:
    chain = MetadataChain.read(path)
    si: StreamInfo = chain.blocks[0]
    dirty = False
    rc = 0
    show_fn = (f"{path}:" if (o.with_filename is True) else "")
    for op in o.ops:
        kind = op[0]
        if kind == "show-streaminfo":
            out.write(f"{show_fn}{op[1](si)}\n")
        elif kind == "set-streaminfo":
            setattr(si, op[1], op[2])
            dirty = True
        elif kind == "append":
            # parity with the reference: operations.c:200-205
            sys.stderr.write("ERROR: --append not implemented yet\n")
            rc = 1
        elif kind == "show-vendor":
            vc = chain.get(VorbisComment)
            out.write(f"{show_fn}{vc.vendor_string if vc else ''}\n")
        elif kind == "show-tag":
            vc = chain.get(VorbisComment)
            prefix = op[1].upper() + "="
            if vc:
                for cmt in vc.comments:
                    if cmt.upper().startswith(prefix):
                        out.write(f"{show_fn}{op[1]}={cmt[len(prefix):]}\n")
        elif kind == "remove-tag":
            vc = chain.get(VorbisComment)
            if vc:
                if op[2]:
                    dirty |= vc.remove_entries(op[1]) > 0
                else:
                    prefix = op[1].upper() + "="
                    for j, cmt in enumerate(vc.comments):
                        if cmt.upper().startswith(prefix):
                            del vc.comments[j]
                            dirty = True
                            break
        elif kind == "remove-all-tags":
            vc = chain.get(VorbisComment)
            if vc and vc.comments:
                vc.comments = []
                dirty = True
        elif kind == "set-tag":
            vc = _get_or_make_vc(chain)
            vc.comments.append(op[1])
            dirty = True
        elif kind == "import-tags":
            text = (sys.stdin.read() if op[1] == "-" else
                    open(op[1], encoding="utf-8").read())
            vc = _get_or_make_vc(chain)
            for line in text.splitlines():
                if line and "=" in line:
                    vc.comments.append(line)
            dirty = True
        elif kind == "export-tags":
            vc = chain.get(VorbisComment)
            dst = sys.stdout if op[1] == "-" else open(op[1], "w", encoding="utf-8")
            try:
                for cmt in (vc.comments if vc else []):
                    dst.write(cmt + "\n")
            finally:
                if dst is not sys.stdout:
                    dst.close()
        elif kind == "import-cuesheet":
            from flac_tpu_torch.grabbag import cuesheet_parse
            text = (sys.stdin.read() if op[1] == "-" else
                    open(op[1], encoding="utf-8").read())
            cs = cuesheet_parse(text, si.sample_rate,
                                si.sample_rate == 44100, si.total_samples)
            chain.blocks.append(cs)
            if o.cued_seekpoints:
                # one seekpoint per track index unless --no-cued-seekpoints
                # (options.c:242-250)
                from flac_tpu_torch.metadata import SeekPoint
                st = chain.get(SeekTable)
                if st is None:
                    st = SeekTable(points=[])
                    chain.blocks.insert(1, st)
                st.points = st.points + [SeekPoint(t.offset + ix.offset, 0, 0)
                                         for t in cs.tracks for ix in t.indices]
                _populate_seekpoints(path, st)
            dirty = True
        elif kind == "export-cuesheet":
            from flac_tpu_torch.grabbag import cuesheet_emit
            cs = chain.get(CueSheet)
            if cs is None:
                out.write(f"{path}: ERROR: FLAC file has no CUESHEET block\n")
                rc = 1
                continue
            text = cuesheet_emit(cs, f'"{os.path.basename(path)}" FLAC')
            if op[1] == "-":
                sys.stdout.write(text)
            else:
                with open(op[1], "w", encoding="utf-8") as f:
                    f.write(text)
        elif kind == "import-picture":
            from flac_tpu_torch.grabbag import picture_from_specification
            chain.blocks.append(picture_from_specification(op[1]))
            dirty = True
        elif kind == "export-picture":
            pic = chain.get(Picture)
            if pic is None:
                out.write(f"{path}: ERROR: FLAC file has no PICTURE block\n")
                rc = 1
                continue
            with open(op[1], "wb") as f:
                f.write(pic.data)
        elif kind == "add-seekpoint":
            from flac_tpu_torch.grabbag import seektable_from_specification
            if si.total_samples == 0:
                out.write(f"{path}: ERROR: cannot add seekpoints because "
                          "STREAMINFO block does not specify total_samples\n")
                rc = 1
                continue
            st = chain.get(SeekTable)
            points, _ = seektable_from_specification(op[1], si.total_samples,
                                                     si.sample_rate)
            if st is None:
                st = SeekTable(points=[])
                chain.blocks.insert(1, st)
            st.points = st.points + points
            _populate_seekpoints(path, st)
            dirty = True
        elif kind == "add-padding":
            chain.blocks.append(Padding(length=op[1]))
            dirty = True
        elif kind == "add-replay-gain":
            from flac_tpu_torch.replaygain import add_replay_gain_tags
            add_replay_gain_tags([path], device=device)
            chain = MetadataChain.read(path)  # re-read: tags were written
            si = chain.blocks[0]
        elif kind == "remove-replay-gain":
            vc = chain.get(VorbisComment)
            if vc:
                for tag in ("REPLAYGAIN_REFERENCE_LOUDNESS",
                            "REPLAYGAIN_TRACK_GAIN", "REPLAYGAIN_TRACK_PEAK",
                            "REPLAYGAIN_ALBUM_GAIN", "REPLAYGAIN_ALBUM_PEAK"):
                    dirty |= vc.remove_entries(tag) > 0
        elif kind == "remove":
            keep = [b for idx, b in enumerate(chain.blocks)
                    if idx == 0 or not _block_selected(o, idx, b)]
            if len(keep) != len(chain.blocks):
                chain.blocks = keep
                dirty = True
        elif kind == "remove-all":
            if len(chain.blocks) > 1:
                chain.blocks = chain.blocks[:1]
                dirty = True
        elif kind == "merge-padding":
            chain.merge_padding()
            dirty = True
        elif kind == "sort-padding":
            chain.sort_padding()
            dirty = True
        elif kind == "list":
            for idx, b in enumerate(chain.blocks):
                if _block_selected(o, idx, b):
                    list_block(b, idx, out, o.application_data_format,
                               filename=path if o.with_filename else None)
        else:
            raise CLIError(f"unhandled operation {kind}")
    if dirty:
        st = os.stat(path)
        chain.write(use_padding=o.use_padding)
        if o.preserve_modtime:
            os.utime(path, (st.st_atime, st.st_mtime))
    return rc


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # the port's device rule: FLAC_TPU_DEVICE names the torch device; unset
    # means CUDA, which raises without a GPU (nothing drops to the CPU)
    device = resolve_device(os.environ.get("FLAC_TPU_DEVICE") or None)
    try:
        o = parse_args(argv)
    except CLIError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    if not o.files:
        print("ERROR: no FLAC files specified", file=sys.stderr)
        return 1
    if o.with_filename is None:
        o.with_filename = len(o.files) > 1
    rc = 0
    for path in o.files:
        try:
            rc |= apply_ops(path, o, sys.stdout, device)
        except (CLIError, OSError, ValueError) as e:
            print(f"{path}: ERROR: {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
