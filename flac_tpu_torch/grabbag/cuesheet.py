"""Cuesheet text parse/emit — the analog of grabbag__cuesheet_parse /
grabbag__cuesheet_emit (src/share/grabbag/cuesheet.c:240,592,616).

Accepts the standard CD cuesheet commands CATALOG / TRACK / INDEX / FLAGS /
ISRC plus the FLAC extensions `REM FLAC__lead-in <samples>` and
`REM FLAC__lead-out <track> <offset>`. Index offsets: MM:SS:FF always; for
non-CD-DA also MM:SS.SS or a raw sample number (cuesheet.c:60-183).
"""

from __future__ import annotations

import re
import shlex

from flac_tpu_torch.metadata import CueSheet, CueSheetIndex, CueSheetTrack


class CueSheetParseError(Exception):
    def __init__(self, line_number: int, message: str) -> None:
        super().__init__(f"line {line_number}: {message}")
        self.line_number = line_number
        self.message = message


def _parse_msf(s: str, sample_rate: int) -> int | None:
    """MM:SS:FF (frame = 1/75 s) → sample number, or None."""
    m = re.fullmatch(r"(\d+):(\d{1,2}):(\d{1,2})", s)
    if not m:
        return None
    mm, ss, ff = (int(g) for g in m.groups())
    if ss >= 60 or ff >= 75:
        return None
    return (mm * 60 + ss) * sample_rate + ff * (sample_rate // 75)


def _parse_ms(s: str, sample_rate: int) -> int | None:
    """MM:SS.SS → sample number (non-CD-DA extension), or None."""
    m = re.fullmatch(r"(\d+):(\d{1,2}(?:\.\d+)?)", s)
    if not m:
        return None
    mm = int(m.group(1))
    x = float(m.group(2))
    if x >= 60.0:
        return None
    return mm * 60 * sample_rate + int(x * sample_rate)


def _fields(line: str) -> list[str]:
    try:
        return shlex.split(line, comments=False, posix=True)
    except ValueError:
        return line.split()


def cuesheet_parse(text: str, sample_rate: int, is_cdda: bool,
                   lead_out_offset: int) -> CueSheet:
    if is_cdda and sample_rate != 44100:
        raise CueSheetParseError(0, "CD-DA cuesheet only allowed with 44.1kHz sample rate")
    cs = CueSheet(media_catalog_number=b"\x00" * 128,
                  lead_in=2 * 44100 if is_cdda else 0, is_cd=is_cdda, tracks=[])
    in_track = False
    in_index = False
    track_has_flags = track_has_isrc = False
    has_catalog = False
    forced_leadout: tuple[int, int] | None = None

    def err(msg: str) -> CueSheetParseError:
        return CueSheetParseError(lineno, msg)

    def check_last_track_indices() -> None:
        t = cs.tracks[-1]
        ok = bool(t.indices)
        if ok and is_cdda:
            nums = [ix.number for ix in t.indices]
            ok = 1 in nums[:2]
        if not ok:
            raise err("previous TRACK must specify at least one INDEX 01"
                      if is_cdda else "previous TRACK must specify at least one INDEX")

    for lineno, raw in enumerate(text.splitlines(), start=1):
        f = _fields(raw)
        if not f:
            continue
        cmd = f[0].upper()
        if cmd == "CATALOG":
            if has_catalog:
                raise err("found multiple CATALOG commands")
            if len(f) < 2:
                raise err("CATALOG is missing catalog number")
            if len(f[1]) >= 128:
                raise err("CATALOG number is too long")
            if is_cdda and not re.fullmatch(r"\d{13}", f[1]):
                raise err("CD-DA CATALOG number must be 13 decimal digits")
            cs.media_catalog_number = f[1].encode("ascii").ljust(128, b"\x00")
            has_catalog = True
        elif cmd == "TRACK":
            if cs.tracks:
                check_last_track_indices()
            if len(f) < 2:
                raise err("TRACK is missing track number")
            try:
                num = int(f[1])
            except ValueError:
                raise err("TRACK has invalid track number") from None
            if num <= 0:
                raise err("TRACK number must be greater than 0")
            if is_cdda and num > 99:
                raise err("CD-DA TRACK number must be between 1 and 99, inclusive")
            if not is_cdda and num == 255:
                raise err("TRACK number 255 is reserved for the lead-out")
            if not is_cdda and num > 255:
                raise err("TRACK number must be between 1 and 254, inclusive")
            if is_cdda and cs.tracks and num != cs.tracks[-1].number + 1:
                raise err("CD-DA TRACK numbers must be sequential")
            if len(f) < 3:
                raise err("TRACK is missing a track type after the track number")
            cs.tracks.append(CueSheetTrack(
                offset=0, number=num, isrc=b"\x00" * 12,
                type=0 if f[2].upper() == "AUDIO" else 1,
                pre_emphasis=False, indices=[]))
            in_track, in_index = True, False
            track_has_flags = track_has_isrc = False
        elif cmd == "FLAGS":
            if track_has_flags:
                raise err("found multiple FLAGS commands")
            if not in_track or in_index:
                raise err("FLAGS command must come after TRACK but before INDEX")
            if any(x.upper() == "PRE" for x in f[1:]):
                cs.tracks[-1].pre_emphasis = True
            track_has_flags = True
        elif cmd == "ISRC":
            if track_has_isrc:
                raise err("found multiple ISRC commands")
            if not in_track or in_index:
                raise err("ISRC command must come after TRACK but before INDEX")
            if len(f) < 2:
                raise err("ISRC is missing ISRC number")
            isrc = f[1].replace("-", "")
            if not re.fullmatch(r"[A-Z0-9]{5}\d{7}", isrc):
                raise err("invalid ISRC number")
            cs.tracks[-1].isrc = isrc.encode("ascii")
            track_has_isrc = True
        elif cmd == "INDEX":
            if not in_track:
                raise err("found INDEX before any TRACK")
            if len(f) < 2:
                raise err("INDEX is missing index number")
            try:
                inum = int(f[1])
            except ValueError:
                raise err("INDEX has invalid index number") from None
            track = cs.tracks[-1]
            if not track.indices:
                if inum > 1:
                    raise err("first INDEX number of a TRACK must be 0 or 1")
            elif inum != track.indices[-1].number + 1:
                raise err("INDEX numbers must be sequential")
            if is_cdda and inum > 99:
                raise err("CD-DA INDEX number must be between 0 and 99, inclusive")
            if len(f) < 3:
                raise err("INDEX is missing an offset after the index number")
            xx = _parse_msf(f[2], sample_rate)
            if xx is None:
                if is_cdda:
                    raise err("illegal INDEX offset (not of the form MM:SS:FF)")
                xx = _parse_ms(f[2], sample_rate)
                if xx is None:
                    try:
                        xx = int(f[2])
                    except ValueError:
                        raise err("illegal INDEX offset") from None
                    if xx < 0:
                        raise err("illegal INDEX offset")
            elif sample_rate % 75:
                raise err("illegal INDEX offset (MM:SS:FF form not allowed "
                          "if sample rate is not a multiple of 75)")
            if is_cdda and len(cs.tracks) == 1 and not track.indices and xx != 0:
                raise err("first INDEX of first TRACK must have an offset of 00:00:00")
            if is_cdda and track.indices and xx <= track.offset + track.indices[-1].offset:
                raise err("CD-DA INDEX offsets must increase in time")
            if not track.indices:
                track.offset = xx
            if is_cdda and len(cs.tracks) > 1:
                prev = cs.tracks[-2]
                if prev.indices and xx <= prev.offset + prev.indices[-1].offset:
                    raise err("CD-DA INDEX offsets must increase in time")
            track.indices.append(CueSheetIndex(offset=xx - track.offset, number=inum))
            in_index = True
        elif cmd == "REM":
            if len(f) >= 2 and f[1] == "FLAC__lead-in":
                if len(f) < 3:
                    raise err("FLAC__lead-in is missing offset")
                try:
                    xx = int(f[2])
                except ValueError:
                    raise err("illegal FLAC__lead-in offset") from None
                if xx < 0:
                    raise err("illegal FLAC__lead-in offset")
                if is_cdda and xx % 588:
                    raise err("illegal CD-DA FLAC__lead-in offset, must be "
                              "even multiple of 588 samples")
                cs.lead_in = xx
            elif len(f) >= 2 and f[1] == "FLAC__lead-out":
                if forced_leadout is not None:
                    raise err("multiple FLAC__lead-out commands")
                if len(f) < 4:
                    raise err("FLAC__lead-out is missing track number or offset")
                try:
                    tnum, off = int(f[2]), int(f[3])
                except ValueError:
                    raise err("illegal FLAC__lead-out") from None
                if off != lead_out_offset:
                    raise err("FLAC__lead-out offset does not match end-of-stream offset")
                forced_leadout = (tnum, off)
        # other commands (FILE, TITLE, PERFORMER, ...) are ignored like the reference

    lineno = len(text.splitlines()) + 1
    if not cs.tracks:
        raise CueSheetParseError(lineno, "there must be at least one TRACK command")
    check_last_track_indices()
    if forced_leadout is None:
        forced_leadout = (170 if is_cdda else 255, lead_out_offset)
    cs.tracks.append(CueSheetTrack(offset=forced_leadout[1], number=forced_leadout[0],
                                   isrc=b"\x00" * 12, type=0, pre_emphasis=False,
                                   indices=[]))
    return cs


def _frame_to_msf(frame: int) -> tuple[int, int, int]:
    return frame // (60 * 75), (frame // 75) % 60, frame % 75


def cuesheet_emit(cs: CueSheet, file_reference: str = '"cuesheet.flac" FLAC') -> str:
    """grabbag__cuesheet_emit (cuesheet.c:616): text form, last track is the
    lead-out and is emitted as the REM FLAC__lead-out line."""
    out: list[str] = []
    mcn = cs.media_catalog_number.rstrip(b"\x00").decode("ascii", errors="replace")
    if mcn:
        out.append(f"CATALOG {mcn}")
    out.append(f"FILE {file_reference}")
    for track in cs.tracks[:-1]:
        out.append(f"  TRACK {track.number:02d} {'AUDIO' if track.type == 0 else 'DATA'}")
        if track.pre_emphasis:
            out.append("    FLAGS PRE")
        isrc = track.isrc.rstrip(b"\x00").decode("ascii", errors="replace")
        if isrc:
            out.append(f"    ISRC {isrc}")
        for index in track.indices:
            if cs.is_cd:
                m, s, f = _frame_to_msf((track.offset + index.offset) // (44100 // 75))
                out.append(f"    INDEX {index.number:02d} {m:02d}:{s:02d}:{f:02d}")
            else:
                out.append(f"    INDEX {index.number:02d} {track.offset + index.offset}")
    lead_out = cs.tracks[-1]
    out.append(f"REM FLAC__lead-in {cs.lead_in}")
    out.append(f"REM FLAC__lead-out {lead_out.number} {lead_out.offset}")
    return "\n".join(out) + "\n"
