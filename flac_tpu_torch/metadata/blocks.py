"""Metadata block object model and (de)serialization.

Mirrors the behavior of the reference's metadata objects
(src/libFLAC/metadata_object.c) and the on-disk block formats parsed in
src/libFLAC/stream_decoder.c:1423-1917 / emitted by
stream_encoder_framing.c:50 (FLAC__add_metadata_block).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from flac_tpu_torch import constants as C
from flac_tpu_torch.bitio import BitReader, BitWriter


@dataclass
class MetadataBlock:
    is_last: bool = False

    @property
    def type_code(self) -> int:
        raise NotImplementedError

    def body_bytes(self) -> bytes:
        raise NotImplementedError


@dataclass
class StreamInfo(MetadataBlock):
    min_blocksize: int = 0
    max_blocksize: int = 0
    min_framesize: int = 0
    max_framesize: int = 0
    sample_rate: int = 0
    channels: int = 1
    bits_per_sample: int = 16
    total_samples: int = 0
    md5sum: bytes = b"\x00" * 16

    @property
    def type_code(self) -> int:
        return C.METADATA_TYPE_STREAMINFO

    def body_bytes(self) -> bytes:
        w = BitWriter()
        w.write_bits(self.min_blocksize, 16)
        w.write_bits(self.max_blocksize, 16)
        w.write_bits(self.min_framesize, 24)
        w.write_bits(self.max_framesize, 24)
        w.write_bits(self.sample_rate, 20)
        w.write_bits(self.channels - 1, 3)
        w.write_bits(self.bits_per_sample - 1, 5)
        w.write_bits(self.total_samples, 36)
        body = w.getvalue() + self.md5sum
        assert len(body) == C.STREAM_METADATA_STREAMINFO_LENGTH
        return body

    @classmethod
    def parse(cls, body: bytes, is_last: bool) -> "StreamInfo":
        r = BitReader(body)
        return cls(
            is_last=is_last,
            min_blocksize=r.read_bits(16),
            max_blocksize=r.read_bits(16),
            min_framesize=r.read_bits(24),
            max_framesize=r.read_bits(24),
            sample_rate=r.read_bits(20),
            channels=r.read_bits(3) + 1,
            bits_per_sample=r.read_bits(5) + 1,
            total_samples=r.read_bits(36),
            md5sum=body[18:34],
        )


@dataclass
class Padding(MetadataBlock):
    length: int = 0

    @property
    def type_code(self) -> int:
        return C.METADATA_TYPE_PADDING

    def body_bytes(self) -> bytes:
        return b"\x00" * self.length

    @classmethod
    def parse(cls, body: bytes, is_last: bool) -> "Padding":
        return cls(is_last=is_last, length=len(body))


@dataclass
class Application(MetadataBlock):
    app_id: bytes = b"\x00" * 4
    data: bytes = b""

    @property
    def type_code(self) -> int:
        return C.METADATA_TYPE_APPLICATION

    def body_bytes(self) -> bytes:
        assert len(self.app_id) == 4
        return self.app_id + self.data

    @classmethod
    def parse(cls, body: bytes, is_last: bool) -> "Application":
        return cls(is_last=is_last, app_id=body[:4], data=body[4:])


@dataclass
class SeekPoint:
    sample_number: int
    stream_offset: int
    frame_samples: int

    PLACEHOLDER = C.SEEKPOINT_PLACEHOLDER

    @property
    def is_placeholder(self) -> bool:
        return self.sample_number == self.PLACEHOLDER


@dataclass
class SeekTable(MetadataBlock):
    points: list[SeekPoint] = field(default_factory=list)

    @property
    def type_code(self) -> int:
        return C.METADATA_TYPE_SEEKTABLE

    def body_bytes(self) -> bytes:
        return b"".join(
            struct.pack(">QQH", p.sample_number, p.stream_offset, p.frame_samples)
            for p in self.points
        )

    @classmethod
    def parse(cls, body: bytes, is_last: bool) -> "SeekTable":
        points = [
            SeekPoint(*struct.unpack_from(">QQH", body, off))
            for off in range(0, len(body) - len(body) % 18, 18)
        ]
        return cls(is_last=is_last, points=points)

    def is_legal(self) -> bool:
        """FLAC__format_seektable_is_legal (format.c:248): ascending unique
        sample numbers, placeholders at the end."""
        prev = -1
        seen_placeholder = False
        for p in self.points:
            if p.is_placeholder:
                seen_placeholder = True
                continue
            if seen_placeholder or p.sample_number <= prev:
                return False
            prev = p.sample_number
        return True


@dataclass
class VorbisComment(MetadataBlock):
    vendor_string: str = ""
    comments: list[str] = field(default_factory=list)  # "NAME=value" entries

    @property
    def type_code(self) -> int:
        return C.METADATA_TYPE_VORBIS_COMMENT

    def body_bytes(self) -> bytes:
        # Vorbis comment uses little-endian lengths, unlike everything else in FLAC
        out = bytearray()
        v = self.vendor_string.encode("utf-8")
        out += struct.pack("<I", len(v)) + v
        out += struct.pack("<I", len(self.comments))
        for c in self.comments:
            e = c.encode("utf-8")
            out += struct.pack("<I", len(e)) + e
        return bytes(out)

    @classmethod
    def parse(cls, body: bytes, is_last: bool) -> "VorbisComment":
        pos = 0
        (vlen,) = struct.unpack_from("<I", body, pos)
        pos += 4
        vendor = body[pos : pos + vlen].decode("utf-8", errors="replace")
        pos += vlen
        (count,) = struct.unpack_from("<I", body, pos)
        pos += 4
        comments = []
        for _ in range(count):
            (clen,) = struct.unpack_from("<I", body, pos)
            pos += 4
            comments.append(body[pos : pos + clen].decode("utf-8", errors="replace"))
            pos += clen
        return cls(is_last=is_last, vendor_string=vendor, comments=comments)

    def find_entry(self, name: str) -> str | None:
        prefix = name.upper() + "="
        for c in self.comments:
            if c.upper().startswith(prefix):
                return c[len(prefix):]
        return None

    def set_entry(self, name: str, value: str, replace_all: bool = True) -> None:
        prefix = name.upper() + "="
        if replace_all:
            self.comments = [c for c in self.comments if not c.upper().startswith(prefix)]
        self.comments.append(f"{name}={value}")

    def remove_entries(self, name: str) -> int:
        prefix = name.upper() + "="
        before = len(self.comments)
        self.comments = [c for c in self.comments if not c.upper().startswith(prefix)]
        return before - len(self.comments)


@dataclass
class CueSheetIndex:
    offset: int = 0
    number: int = 0


@dataclass
class CueSheetTrack:
    offset: int = 0
    number: int = 0
    isrc: bytes = b"\x00" * 12
    type: int = 0  # 0 audio, 1 non-audio
    pre_emphasis: bool = False
    indices: list[CueSheetIndex] = field(default_factory=list)


@dataclass
class CueSheet(MetadataBlock):
    media_catalog_number: bytes = b"\x00" * 128
    lead_in: int = 0
    is_cd: bool = False
    tracks: list[CueSheetTrack] = field(default_factory=list)

    @property
    def type_code(self) -> int:
        return C.METADATA_TYPE_CUESHEET

    def body_bytes(self) -> bytes:
        mcn = self.media_catalog_number.ljust(128, b"\x00")[:128]
        out = bytearray(mcn)
        out += struct.pack(">Q", self.lead_in)
        out += bytes([0x80 if self.is_cd else 0x00]) + b"\x00" * 258
        out += bytes([len(self.tracks)])
        for t in self.tracks:
            out += struct.pack(">Q", t.offset)
            out += bytes([t.number])
            out += t.isrc.ljust(12, b"\x00")[:12]
            flags = (0x80 if t.type else 0) | (0x40 if t.pre_emphasis else 0)
            out += bytes([flags]) + b"\x00" * 13
            out += bytes([len(t.indices)])
            for ix in t.indices:
                out += struct.pack(">Q", ix.offset) + bytes([ix.number]) + b"\x00" * 3
        return bytes(out)

    @classmethod
    def parse(cls, body: bytes, is_last: bool) -> "CueSheet":
        pos = 0
        mcn = body[:128]
        pos = 128
        (lead_in,) = struct.unpack_from(">Q", body, pos)
        pos += 8
        is_cd = bool(body[pos] & 0x80)
        pos += 259
        ntracks = body[pos]
        pos += 1
        tracks = []
        for _ in range(ntracks):
            (offset,) = struct.unpack_from(">Q", body, pos)
            pos += 8
            number = body[pos]
            pos += 1
            isrc = body[pos : pos + 12]
            pos += 12
            flags = body[pos]
            pos += 14
            nidx = body[pos]
            pos += 1
            indices = []
            for _ in range(nidx):
                (ioff,) = struct.unpack_from(">Q", body, pos)
                pos += 8
                inum = body[pos]
                pos += 4
                indices.append(CueSheetIndex(offset=ioff, number=inum))
            tracks.append(CueSheetTrack(offset=offset, number=number, isrc=isrc,
                                        type=(flags >> 7) & 1,
                                        pre_emphasis=bool(flags & 0x40),
                                        indices=indices))
        return cls(is_last=is_last, media_catalog_number=mcn, lead_in=lead_in,
                   is_cd=is_cd, tracks=tracks)


@dataclass
class Picture(MetadataBlock):
    picture_type: int = 0
    mime_type: str = ""
    description: str = ""
    width: int = 0
    height: int = 0
    depth: int = 0
    colors: int = 0
    data: bytes = b""

    @property
    def type_code(self) -> int:
        return C.METADATA_TYPE_PICTURE

    def body_bytes(self) -> bytes:
        mime = self.mime_type.encode("ascii")
        desc = self.description.encode("utf-8")
        out = bytearray()
        out += struct.pack(">I", self.picture_type)
        out += struct.pack(">I", len(mime)) + mime
        out += struct.pack(">I", len(desc)) + desc
        out += struct.pack(">IIII", self.width, self.height, self.depth, self.colors)
        out += struct.pack(">I", len(self.data)) + self.data
        return bytes(out)

    @classmethod
    def parse(cls, body: bytes, is_last: bool) -> "Picture":
        pos = 0
        (ptype,) = struct.unpack_from(">I", body, pos)
        pos += 4
        (mlen,) = struct.unpack_from(">I", body, pos)
        pos += 4
        mime = body[pos : pos + mlen].decode("ascii", errors="replace")
        pos += mlen
        (dlen,) = struct.unpack_from(">I", body, pos)
        pos += 4
        desc = body[pos : pos + dlen].decode("utf-8", errors="replace")
        pos += dlen
        width, height, depth, colors = struct.unpack_from(">IIII", body, pos)
        pos += 16
        (datalen,) = struct.unpack_from(">I", body, pos)
        pos += 4
        return cls(is_last=is_last, picture_type=ptype, mime_type=mime, description=desc,
                   width=width, height=height, depth=depth, colors=colors,
                   data=body[pos : pos + datalen])


@dataclass
class Unknown(MetadataBlock):
    code: int = C.METADATA_TYPE_UNDEFINED
    data: bytes = b""

    @property
    def type_code(self) -> int:
        return self.code

    def body_bytes(self) -> bytes:
        return self.data


_PARSERS = {
    C.METADATA_TYPE_STREAMINFO: StreamInfo.parse,
    C.METADATA_TYPE_PADDING: Padding.parse,
    C.METADATA_TYPE_APPLICATION: Application.parse,
    C.METADATA_TYPE_SEEKTABLE: SeekTable.parse,
    C.METADATA_TYPE_VORBIS_COMMENT: VorbisComment.parse,
    C.METADATA_TYPE_CUESHEET: CueSheet.parse,
    C.METADATA_TYPE_PICTURE: Picture.parse,
}


def serialize_block(block: MetadataBlock, is_last: bool | None = None) -> bytes:
    """Block header (1 is_last + 7 type + 24 length) + body."""
    body = block.body_bytes()
    last = block.is_last if is_last is None else is_last
    header = bytes([((0x80 if last else 0) | block.type_code) & 0xFF]) + len(body).to_bytes(3, "big")
    return header + body


def parse_block(data: bytes, offset: int) -> tuple[MetadataBlock, int]:
    """Parse one block at `offset`; returns (block, next_offset)."""
    hdr = data[offset]
    is_last = bool(hdr & 0x80)
    btype = hdr & 0x7F
    length = int.from_bytes(data[offset + 1 : offset + 4], "big")
    body = data[offset + 4 : offset + 4 + length]
    parser = _PARSERS.get(btype)
    if parser is None:
        block: MetadataBlock = Unknown(is_last=is_last, code=btype, data=body)
    else:
        block = parser(body, is_last)
    return block, offset + 4 + length


def parse_metadata(data: bytes, offset: int = 4) -> tuple[list[MetadataBlock], int]:
    """Parse all metadata blocks after the fLaC magic; returns (blocks, audio_offset)."""
    blocks = []
    while True:
        block, offset = parse_block(data, offset)
        blocks.append(block)
        if block.is_last:
            return blocks, offset


def serialize_metadata(blocks: list[MetadataBlock]) -> bytes:
    out = bytearray()
    for i, b in enumerate(blocks):
        out += serialize_block(b, is_last=(i == len(blocks) - 1))
    return bytes(out)
