"""Picture specification parsing — the analog of
grabbag__picture_parse_specification (src/share/grabbag/picture.c:262) with
PNG/JPEG/GIF header sniffing (picture.c:127-260).

Spec: "[TYPE]|[MIME]|[DESCRIPTION]|[WIDTHxHEIGHTxDEPTH[/COLORS]]|FILE", or
just "FILE" (everything guessed from the image data). MIME "-->"' means FILE
is a URL stored verbatim.
"""

from __future__ import annotations

import os
import struct

from flac_tpu_torch.metadata import Picture


class PictureSpecError(Exception):
    pass


def _sniff_mime(data: bytes) -> str | None:
    if data[:8] == b"\x89PNG\x0d\x0a\x1a\x0a":
        return "image/png"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "image/gif"
    if data[:2] == b"\xff\xd8":
        return "image/jpeg"
    return None


def _sniff_png(data: bytes, pic: Picture) -> bool:
    if data[:8] != b"\x89PNG\x0d\x0a\x1a\x0a":
        return False
    pos = 8
    need_palette = False
    while pos + 12 <= len(data):
        (clen,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4 : pos + 8]
        if ctype == b"IHDR" and clen == 13:
            pic.width, pic.height = struct.unpack_from(">II", data, pos + 8)
            bit_depth = data[pos + 16]
            color_type = data[pos + 17]
            if color_type == 3:
                # palette image: depth is always counted as 8 per the PNG
                # spec note in the reference (picture.c:148); colors from PLTE
                pic.depth = 8
                need_palette = True
            else:
                channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type, 3)
                pic.depth = bit_depth * channels
                pic.colors = 0
                return True
        elif ctype == b"PLTE" and need_palette:
            pic.colors = clen // 3
            return True
        pos += 12 + clen
    return pic.width > 0 and pic.height > 0


def _sniff_jpeg(data: bytes, pic: Picture) -> bool:
    if data[:2] != b"\xff\xd8":
        return False
    pos = 2
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            return False
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:  # standalone markers
            pos += 2
            continue
        (seglen,) = struct.unpack_from(">H", data, pos + 2)
        # SOF0..SOF15 except DHT(C4)/JPG(C8)/DAC(CC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 9 > n:
                return False
            precision = data[pos + 4]
            pic.height, pic.width = struct.unpack_from(">HH", data, pos + 5)
            ncomp = data[pos + 9] if pos + 9 < n else 3
            pic.depth = precision * ncomp
            pic.colors = 0
            return True
        pos += 2 + seglen
    return False


def _sniff_gif(data: bytes, pic: Picture) -> bool:
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 11:
        return False
    pic.width = data[6] | (data[7] << 8)
    pic.height = data[8] | (data[9] << 8)
    pic.depth = 24  # the reference pessimistically assumes 24-bit (picture.c:252)
    pic.colors = 1 << ((data[10] & 0x07) + 1)
    return True


def _extract_resolution(data: bytes, mime: str, pic: Picture) -> bool:
    if mime == "image/png":
        return _sniff_png(data, pic)
    if mime == "image/jpeg":
        return _sniff_jpeg(data, pic)
    if mime == "image/gif":
        return _sniff_gif(data, pic)
    return False


def _parse_resolution(part: str, pic: Picture) -> None:
    """WIDTHxHEIGHTxDEPTH[/COLORS] (picture.c:local__parse_resolution_)."""
    if not part:
        pic.width = pic.height = pic.depth = pic.colors = 0
        return
    colors = 0
    if "/" in part:
        part, ctext = part.split("/", 1)
        if not ctext.isdigit():
            raise PictureSpecError("invalid picture specification: "
                                   "can't parse resolution/color part")
        colors = int(ctext)
    dims = part.split("x")
    if len(dims) != 3 or not all(d.isdigit() for d in dims):
        raise PictureSpecError("invalid picture specification: "
                               "can't parse resolution/color part")
    pic.width, pic.height, pic.depth = (int(d) for d in dims)
    pic.colors = colors
    if pic.depth < 32 and (1 << pic.depth) < pic.colors:
        raise PictureSpecError("invalid picture specification: "
                               "can't parse resolution/color part")


def picture_from_specification(spec: str) -> Picture:
    pic = Picture(picture_type=3)  # default: front cover
    if "|" in spec:
        parts = spec.split("|")
        if len(parts) != 5:
            raise PictureSpecError("invalid picture specification")
        type_s, mime, desc, res, filename = parts
        if type_s:
            if not type_s.isdigit():
                raise PictureSpecError("invalid picture type")
            pic.picture_type = int(type_s)
        pic.mime_type = mime
        pic.description = desc
        _parse_resolution(res, pic)
    else:
        filename = spec
        pic.mime_type = ""
        pic.description = ""
        pic.width = pic.height = pic.depth = pic.colors = 0

    if pic.mime_type == "-->":  # URL stored verbatim
        pic.data = filename.encode("utf-8")
        if pic.width == 0 or pic.height == 0 or pic.depth == 0:
            raise PictureSpecError("unable to extract resolution and color info "
                                   "from URL, user must set explicitly")
    else:
        if not os.path.isfile(filename):
            raise PictureSpecError("error opening picture file")
        with open(filename, "rb") as f:
            pic.data = f.read()
        if not pic.mime_type:
            mime = _sniff_mime(pic.data)
            if mime is None:
                raise PictureSpecError("unable to guess MIME type from file, "
                                       "user must set explicitly")
            pic.mime_type = mime
        if pic.width == 0 or pic.height == 0 or pic.depth == 0:
            if not _extract_resolution(pic.data, pic.mime_type, pic):
                raise PictureSpecError("unable to extract resolution and color "
                                       "info from file, user must set explicitly")

    if pic.picture_type == 1 and (  # 32x32 PNG standard icon rule
            (pic.mime_type not in ("image/png", "-->"))
            or pic.width != 32 or pic.height != 32):
        raise PictureSpecError("type 1 icon must be a 32x32 pixel PNG")
    return pic
