"""File-level metadata editing: the reference's 3-level metadata API.

- Level 0 (include/FLAC/metadata.h:158-236): one-shot convenience getters —
  get_streaminfo / get_tags / get_cuesheet / get_picture.
- Level 1 (metadata.h:312-672, metadata_iterators.c:673+): SimpleIterator —
  walk blocks in-file and set/insert/delete with padding reuse, else a
  whole-file rewrite.
- Level 2 (metadata.h:798-1242): Chain/Iterator — read all metadata, edit in
  memory, write back with a `use_padding` strategy (in-place when the new
  metadata fits the existing region, absorbing the difference into a PADDING
  block) or a tempfile rewrite + atomic rename
  (write_metadata_block_stationary_ / rewrite_whole_file_,
  metadata_iterators.c:117-137).

Host-side, pure Python; no device content. The port's copy of
flac_tpu.metadata.iterators; Ogg chains wait for ogg.py (ROADMAP item 11b).
"""

from __future__ import annotations

import io
import os
import tempfile
from dataclasses import dataclass

from flac_tpu_torch import constants as C
from flac_tpu_torch.metadata.blocks import (
    CueSheet,
    MetadataBlock,
    Padding,
    Picture,
    StreamInfo,
    VorbisComment,
    parse_block,
    serialize_metadata,
)

BLOCK_HEADER_LEN = 4  # 1 byte is_last+type, 3 bytes length


class MetadataIOError(Exception):
    pass


def _ogg_not_ported() -> None:
    raise NotImplementedError(
        "Ogg FLAC input is not ported to flac_tpu_torch yet (ROADMAP queue 1 item 11b)")


def _find_stream_start(data: bytes) -> int:
    """Offset of the 'fLaC' marker, skipping a leading ID3v2 tag
    (the reference level-1/2 APIs tolerate ID3v2 the same way the decoder
    does, stream_decoder.c:1919)."""
    pos = 0
    if data[:3] == b"ID3":
        size = 0
        for b in data[6:10]:
            size = (size << 7) | (b & 0x7F)
        pos = 10 + size
    if data[pos : pos + 4] != C.STREAM_SYNC_STRING:
        raise MetadataIOError("not a FLAC file (missing fLaC marker)")
    return pos


# ---------------------------------------------------------------------------
# Level 0 — convenience getters (metadata.h:158-236)
# ---------------------------------------------------------------------------

def get_streaminfo(path: str) -> StreamInfo | None:
    for b in _iter_blocks_from_file(path):
        if isinstance(b, StreamInfo):
            return b
    return None


def get_tags(path: str) -> VorbisComment | None:
    """First VORBIS_COMMENT block, like FLAC__metadata_get_tags."""
    for b in _iter_blocks_from_file(path):
        if isinstance(b, VorbisComment):
            return b
    return None


def get_cuesheet(path: str) -> CueSheet | None:
    for b in _iter_blocks_from_file(path):
        if isinstance(b, CueSheet):
            return b
    return None


def get_picture(path: str, picture_type: int | None = None,
                mime_type: str | None = None, description: str | None = None,
                max_width: int = (1 << 32) - 1, max_height: int = (1 << 32) - 1,
                max_depth: int = (1 << 32) - 1, max_colors: int = (1 << 32) - 1,
                ) -> Picture | None:
    """FLAC__metadata_get_picture (metadata.h:209-236): among PICTURE blocks
    matching the filters and within the max constraints, return the one with
    the largest area."""
    best: Picture | None = None
    best_area = -1
    for b in _iter_blocks_from_file(path):
        if not isinstance(b, Picture):
            continue
        if picture_type is not None and b.picture_type != picture_type:
            continue
        if mime_type is not None and b.mime_type != mime_type:
            continue
        if description is not None and b.description != description:
            continue
        if b.width > max_width or b.height > max_height:
            continue
        if b.depth > max_depth or b.colors > max_colors:
            continue
        area = b.width * b.height
        if area > best_area:
            best, best_area = b, area
    return best


def _iter_blocks_from_file(path: str):
    with open(path, "rb") as f:
        data = f.read()
    pos = _find_stream_start(data) + 4
    while True:
        block, pos = parse_block(data, pos)
        yield block
        if block.is_last:
            return


# ---------------------------------------------------------------------------
# Level 2 — Chain (read → edit in memory → write)
# ---------------------------------------------------------------------------

@dataclass
class _Layout:
    stream_start: int      # offset of 'fLaC'
    metadata_end: int      # offset of first audio byte
    file_len: int


class MetadataChain:
    """FLAC__metadata_chain_* analog. Blocks are exposed as a plain list
    (`chain.blocks`); edit it (or use the convenience methods) and call
    write(). STREAMINFO must remain first; is_last flags are managed
    automatically on write."""

    def __init__(self) -> None:
        self.blocks: list[MetadataBlock] = []
        self._path: str | None = None
        self._layout: _Layout | None = None
        self._is_ogg = False

    # -- reading --

    @classmethod
    def read(cls, path: str) -> "MetadataChain":
        chain = cls()
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"OggS":
            return cls.read_ogg(path)
        start = _find_stream_start(data)
        pos = start + 4
        while True:
            block, pos = parse_block(data, pos)
            chain.blocks.append(block)
            if block.is_last:
                break
        chain._path = path
        chain._layout = _Layout(stream_start=start, metadata_end=pos, file_len=len(data))
        if not chain.blocks or not isinstance(chain.blocks[0], StreamInfo):
            raise MetadataIOError("first metadata block is not STREAMINFO")
        return chain

    @classmethod
    def read_io(cls, handle) -> "MetadataChain":
        """FLAC__metadata_chain_read_with_callbacks (metadata.h:869): read
        the chain from a file-like handle (the Python analog of the C
        IOHandle+IOCallbacks pair). The chain keeps no path; write it back
        with write_io / write_io_tempfile."""
        data = handle.read()
        if data[:4] == b"OggS":
            return cls.read_ogg_io(io.BytesIO(data))
        chain = cls()
        start = _find_stream_start(data)
        pos = start + 4
        while True:
            block, pos = parse_block(data, pos)
            chain.blocks.append(block)
            if block.is_last:
                break
        chain._layout = _Layout(stream_start=start, metadata_end=pos,
                                file_len=len(data))
        if not chain.blocks or not isinstance(chain.blocks[0], StreamInfo):
            raise MetadataIOError("first metadata block is not STREAMINFO")
        return chain

    @classmethod
    def read_ogg_io(cls, handle) -> "MetadataChain":
        """FLAC__metadata_chain_read_ogg_with_callbacks (metadata.h:896)."""
        _ogg_not_ported()

    def write_io(self, handle) -> None:
        """FLAC__metadata_chain_write_with_callbacks (metadata.h:958):
        IN-PLACE write through a seekable read/write handle. Like the
        reference, requires the new metadata to fit the existing region
        (call check_if_tempfile_needed first; padding absorbs slack) —
        raises MetadataIOError otherwise."""
        if self._layout is None:
            raise MetadataIOError("chain was not read from a native stream")
        if self._is_ogg:
            raise MetadataIOError("in-place write is meaningless inside Ogg")
        existing = self._layout.metadata_end - (self._layout.stream_start + 4)
        blob = self._serialized()
        if len(blob) != existing:
            if not isinstance(self.blocks[-1], Padding):
                if len(blob) + BLOCK_HEADER_LEN <= existing:
                    self.blocks.append(Padding(
                        length=existing - len(blob) - BLOCK_HEADER_LEN))
                    blob = self._serialized()
            else:
                delta = existing - len(blob)
                if self.blocks[-1].length + delta >= 0:
                    self.blocks[-1] = Padding(
                        length=self.blocks[-1].length + delta)
                    blob = self._serialized()
        if len(blob) != existing:
            raise MetadataIOError(
                "new metadata does not fit; use write_io_tempfile "
                "(FLAC__METADATA_CHAIN_STATUS_BAD_METADATA analog)")
        handle.seek(self._layout.stream_start + 4)
        handle.write(blob)

    def write_io_tempfile(self, handle, temp_handle) -> None:
        """FLAC__metadata_chain_write_with_callbacks_and_tempfile
        (metadata.h:982): stream the rewritten file into `temp_handle`
        (the caller owns the swap/rename, as in the reference)."""
        if self._layout is None:
            raise MetadataIOError("chain was not read from a native stream")
        handle.seek(0)
        data = handle.read()
        temp_handle.write(data[: self._layout.stream_start + 4])
        temp_handle.write(self._serialized())
        temp_handle.write(data[self._layout.metadata_end:])

    @classmethod
    def read_ogg(cls, path: str) -> "MetadataChain":
        """FLAC__metadata_chain_read_ogg (metadata.h:849): read the chain
        from an Ogg FLAC (.oga) file by demuxing the header packets.

        The reference's Ogg chain is read-only ('a subsequent
        FLAC__metadata_chain_write() will fail', metadata.h:662-663); this
        chain goes one further: write() re-paginates the WHOLE stream
        through a tempfile+rename (rewrite-only — in-place padding reuse
        has no meaning inside Ogg pages)."""
        _ogg_not_ported()

    # -- editing helpers (metadata_object.c-style ops) --

    def merge_padding(self) -> None:
        """Combine adjacent PADDING blocks into one
        (FLAC__metadata_chain_merge_padding, metadata.h:1009)."""
        out: list[MetadataBlock] = []
        for b in self.blocks:
            if isinstance(b, Padding) and out and isinstance(out[-1], Padding):
                out[-1] = Padding(length=out[-1].length + BLOCK_HEADER_LEN + b.length)
            else:
                out.append(b)
        self.blocks = out

    def sort_padding(self) -> None:
        """Move all padding to one block at the end
        (FLAC__metadata_chain_sort_padding, metadata.h:1023)."""
        total = sum(BLOCK_HEADER_LEN + b.length for b in self.blocks
                    if isinstance(b, Padding))
        self.blocks = [b for b in self.blocks if not isinstance(b, Padding)]
        if total >= BLOCK_HEADER_LEN:
            self.blocks.append(Padding(length=total - BLOCK_HEADER_LEN))

    def get(self, cls_or_code) -> MetadataBlock | None:
        for b in self.blocks:
            if isinstance(cls_or_code, int):
                if b.type_code == cls_or_code:
                    return b
            elif isinstance(b, cls_or_code):
                return b
        return None

    def remove(self, predicate) -> int:
        keep, removed = [], 0
        for b in self.blocks:
            if predicate(b) and not isinstance(b, StreamInfo):
                removed += 1
            else:
                keep.append(b)
        self.blocks = keep
        return removed

    # -- writing --

    def _serialized(self) -> bytes:
        return serialize_metadata(self.blocks)

    def check_if_tempfile_needed(self, use_padding: bool = True) -> bool:
        """FLAC__metadata_chain_check_if_tempfile_needed (metadata.h:941)."""
        if self._layout is None:
            return True
        existing = self._layout.metadata_end - (self._layout.stream_start + 4)
        new = len(self._serialized())
        if new == existing:
            return False
        if not use_padding:
            return True
        if isinstance(self.blocks[-1], Padding):
            # the last padding block can shrink or grow to absorb the difference
            delta = existing - new
            return self.blocks[-1].length + delta < 0
        # can append a padding block if ≥4 bytes remain for its header
        return not (new + BLOCK_HEADER_LEN <= existing)

    def write(self, use_padding: bool = True, path: str | None = None) -> None:
        """Write the chain back to the file. In-place when the new metadata
        fits the existing region (difference absorbed by a final PADDING
        block), else tempfile rewrite + atomic rename."""
        path = path or self._path
        if path is None:
            raise MetadataIOError("chain has no associated file")
        if not self.blocks or not isinstance(self.blocks[0], StreamInfo):
            raise MetadataIOError("first metadata block must be STREAMINFO")
        if self._is_ogg:
            self._write_ogg(path)
            return
        layout = self._layout if path == self._path else None

        if layout is not None:
            existing = layout.metadata_end - (layout.stream_start + 4)
            new_blob = self._serialized()
            fits = False
            if len(new_blob) == existing:
                fits = True
            elif use_padding:
                blocks = list(self.blocks)
                if isinstance(blocks[-1], Padding):
                    delta = existing - len(new_blob)
                    if blocks[-1].length + delta >= 0:
                        blocks[-1] = Padding(length=blocks[-1].length + delta)
                        self.blocks = blocks
                        fits = True
                elif len(new_blob) + BLOCK_HEADER_LEN <= existing:
                    self.blocks = blocks + [
                        Padding(length=existing - len(new_blob) - BLOCK_HEADER_LEN)]
                    fits = True
            if fits:
                blob = self._serialized()
                assert len(blob) == existing
                with open(path, "r+b") as f:
                    f.seek(layout.stream_start + 4)
                    f.write(blob)
                return
        # tempfile rewrite (rewrite_whole_file_, metadata_iterators.c:127-137)
        with open(path, "rb") as f:
            data = f.read()
        if layout is None:
            start = _find_stream_start(data)
            pos = start + 4
            while True:
                _b, pos = parse_block(data, pos)
                if _b.is_last:
                    break
            layout = _Layout(stream_start=start, metadata_end=pos, file_len=len(data))
        blob = self._serialized()
        dirn = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".flacmeta.", dir=dirn)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data[: layout.stream_start + 4])
                f.write(blob)
                f.write(data[layout.metadata_end :])
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self._layout = _Layout(stream_start=layout.stream_start,
                               metadata_end=layout.stream_start + 4 + len(blob),
                               file_len=len(data) - (layout.metadata_end -
                                                     layout.stream_start - 4) + len(blob))
        self._path = path

    def _write_ogg(self, path: str) -> None:
        """Ogg chain write: splice the edited blocks into the demuxed native
        stream and RE-PAGINATE the whole file (tempfile + atomic rename),
        keeping the original stream serial number. Beyond-reference: the C
        chain refuses to write Ogg (metadata.h:662-663)."""
        _ogg_not_ported()


# ---------------------------------------------------------------------------
# Level 1 — SimpleIterator (in-file walking + targeted edits)
# ---------------------------------------------------------------------------

_COPY_CHUNK = 1 << 20  # streaming-copy buffer for rewrites


class SimpleIterator:
    """FLAC__metadata_simple_iterator_* analog: true in-file block walking
    (metadata_iterators.c:673+). Navigation reads only 4-byte block headers;
    get_block() parses just the current block's bytes; edits write the
    smallest byte range that keeps the file valid (in-place overwrite,
    padding absorb/emit) and otherwise stream-copy through a tempfile +
    atomic rename with O(1) memory — never the whole file in RAM."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            head = f.read(10)
            start = 0
            if head[:3] == b"ID3":
                size = 0
                for b in head[6:10]:
                    size = (size << 7) | (b & 0x7F)
                start = 10 + size
                f.seek(start)
                head = f.read(4)
            if head[:4] != C.STREAM_SYNC_STRING:
                raise MetadataIOError("not a FLAC file (missing fLaC marker)")
        self._stream_start = start
        self._off = start + 4  # current block's header offset
        self.index = 0
        self._read_header()
        if self._type != C.METADATA_TYPE_STREAMINFO:
            raise MetadataIOError("first metadata block is not STREAMINFO")

    def _read_header(self, off: int | None = None):
        """Read the 4-byte block header at `off` (default: current block).
        Returns (is_last, type, length) and, for the current block, caches
        them on the iterator."""
        at = self._off if off is None else off
        with open(self.path, "rb") as f:
            f.seek(at)
            hdr = f.read(BLOCK_HEADER_LEN)
        if len(hdr) != BLOCK_HEADER_LEN:
            raise MetadataIOError("truncated metadata block header")
        is_last = bool(hdr[0] & 0x80)
        btype = hdr[0] & 0x7F
        length = int.from_bytes(hdr[1:4], "big")
        if off is None:
            self._is_last, self._type, self._length = is_last, btype, length
        return is_last, btype, length

    # -- navigation --

    def __len__(self) -> int:
        n, off = 1, self._stream_start + 4
        while True:
            last, _t, ln = self._read_header(off)
            if last:
                return n
            off += BLOCK_HEADER_LEN + ln
            n += 1

    def next(self) -> bool:
        if self._is_last:
            return False
        self._off += BLOCK_HEADER_LEN + self._length
        self.index += 1
        self._read_header()
        return True

    def prev(self) -> bool:
        if self.index == 0:
            return False
        # re-walk from the first block (the reference does the same,
        # metadata_iterators.c simple_iterator_prev)
        target = self.index - 1
        off, idx = self._stream_start + 4, 0
        while idx < target:
            _last, _t, ln = self._read_header(off)
            off += BLOCK_HEADER_LEN + ln
            idx += 1
        self._off, self.index = off, target
        self._read_header()
        return True

    def is_last(self) -> bool:
        return self._is_last

    def get_block_type(self) -> int:
        return self._type

    def get_block_length(self) -> int:
        return self._length

    def get_block(self) -> MetadataBlock:
        with open(self.path, "rb") as f:
            f.seek(self._off)
            raw = f.read(BLOCK_HEADER_LEN + self._length)
        block, _pos = parse_block(raw, 0)
        return block

    def get_block_offset(self) -> int:
        """Byte offset of the current block's header in the file."""
        return self._off

    # -- mutation (each writes through to the file immediately, like the
    # reference's level-1 API) --

    @staticmethod
    def _header_bytes(btype: int, length: int, is_last: bool) -> bytes:
        return bytes([(0x80 if is_last else 0) | btype]) + length.to_bytes(3, "big")

    def _write_at(self, off: int, payload: bytes) -> None:
        with open(self.path, "r+b") as f:
            f.seek(off)
            f.write(payload)

    def _splice(self, replacement: bytes) -> None:
        """Replace the current block's bytes (header+body) with `replacement`
        via a streaming tempfile copy + atomic rename (O(1) memory) —
        rewrite_whole_file_, metadata_iterators.c:127-137."""
        old_span = BLOCK_HEADER_LEN + self._length
        dirn = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".flacmeta.", dir=dirn)
        try:
            with open(self.path, "rb") as src, os.fdopen(fd, "wb") as dst:
                remaining = self._off
                while remaining:
                    chunk = src.read(min(_COPY_CHUNK, remaining))
                    dst.write(chunk)
                    remaining -= len(chunk)
                dst.write(replacement)
                src.seek(self._off + old_span)
                while True:
                    chunk = src.read(_COPY_CHUNK)
                    if not chunk:
                        break
                    dst.write(chunk)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def set_block(self, block: MetadataBlock, use_padding: bool = True) -> None:
        """Reference set_block cases (write_metadata_block_data_ dispatch in
        FLAC__metadata_simple_iterator_set_block): equal length → overwrite
        in place; shrink ≥4 with padding → block + new PADDING fills the
        hole; grow/odd-shrink absorbed by a following PADDING block when it
        fits; else streaming rewrite."""
        if self.index == 0 and not isinstance(block, StreamInfo):
            raise MetadataIOError("block 0 must remain STREAMINFO")
        body = block.body_bytes()
        new_len, old_len = len(body), self._length
        hdr = self._header_bytes(block.type_code, new_len, self._is_last)

        if new_len == old_len:
            self._write_at(self._off, hdr + body)
        elif use_padding and new_len + BLOCK_HEADER_LEN <= old_len:
            # block + padding block filling the freed bytes, padding takes
            # the current block's is_last flag
            pad_len = old_len - new_len - BLOCK_HEADER_LEN
            out = (self._header_bytes(block.type_code, new_len, False) + body
                   + self._header_bytes(C.METADATA_TYPE_PADDING, pad_len,
                                        self._is_last) + b"\x00" * pad_len)
            self._write_at(self._off, out)
            self._is_last = False
        elif use_padding and not self._is_last:
            next_off = self._off + BLOCK_HEADER_LEN + old_len
            nlast, ntype, nlen = self._read_header(next_off)
            avail = old_len + BLOCK_HEADER_LEN + nlen  # block + padding hdr + body
            if ntype == C.METADATA_TYPE_PADDING and new_len == avail:
                # exact fit: the padding block disappears entirely
                self._write_at(self._off, self._header_bytes(
                    block.type_code, new_len, nlast) + body)
                self._is_last = nlast
            elif (ntype == C.METADATA_TYPE_PADDING
                  and new_len + BLOCK_HEADER_LEN <= avail):
                pad_len = avail - new_len - BLOCK_HEADER_LEN
                out = (self._header_bytes(block.type_code, new_len, False)
                       + body
                       + self._header_bytes(C.METADATA_TYPE_PADDING, pad_len,
                                            nlast) + b"\x00" * pad_len)
                self._write_at(self._off, out)
                self._is_last = False
            else:
                self._splice(hdr + body)
        else:
            self._splice(hdr + body)
        self._type, self._length = block.type_code, new_len

    def insert_block_after(self, block: MetadataBlock,
                           use_padding: bool = True) -> None:
        """Insert after the current block; a following PADDING block is
        consumed to make room when it fits, else streaming rewrite. The
        iterator lands on the new block (simple_iterator_insert_block_after)."""
        body = block.body_bytes()
        new_len = len(body)
        ins_off = self._off + BLOCK_HEADER_LEN + self._length

        consumed = False
        if use_padding and not self._is_last:
            nlast, ntype, nlen = self._read_header(ins_off)
            if ntype == C.METADATA_TYPE_PADDING:
                if new_len == nlen:
                    # perfect fit: new block replaces the padding wholesale
                    self._write_at(ins_off, self._header_bytes(
                        block.type_code, new_len, nlast) + body)
                    consumed = True
                elif new_len + BLOCK_HEADER_LEN <= nlen:
                    pad_len = nlen - new_len - BLOCK_HEADER_LEN
                    out = (self._header_bytes(block.type_code, new_len, False)
                           + body
                           + self._header_bytes(C.METADATA_TYPE_PADDING,
                                                pad_len, nlast)
                           + b"\x00" * pad_len)
                    self._write_at(ins_off, out)
                    consumed = True
        if not consumed:
            ins = self._header_bytes(block.type_code, new_len, self._is_last) \
                + body
            if self._is_last:
                # current block loses last-metadata flag; do both writes via
                # one splice of current block + new block
                cur_hdr = self._header_bytes(self._type, self._length, False)
                with open(self.path, "rb") as f:
                    f.seek(self._off + BLOCK_HEADER_LEN)
                    cur_body = f.read(self._length)
                self._splice(cur_hdr + cur_body + ins)
                self._is_last = False
            else:
                # splice-insert: replace current block bytes with themselves
                # + the new block (streamed; current body read once)
                with open(self.path, "rb") as f:
                    f.seek(self._off)
                    cur = f.read(BLOCK_HEADER_LEN + self._length)
                self._splice(cur + ins)
        self._off = ins_off
        self.index += 1
        self._read_header()

    def delete_block(self, use_padding: bool = True) -> None:
        """Delete the current block: with use_padding it becomes an
        equal-size zeroed PADDING block in place; otherwise the block's
        bytes are removed via streaming rewrite (and a last-block deletion
        promotes the previous block's is_last flag). The iterator is left
        on the preceding block (simple_iterator_delete_block)."""
        if self.index == 0:
            raise MetadataIOError("cannot delete STREAMINFO")
        if use_padding:
            out = self._header_bytes(C.METADATA_TYPE_PADDING, self._length,
                                     self._is_last) + b"\x00" * self._length
            self._write_at(self._off, out)
        else:
            was_last = self._is_last
            self._splice(b"")
            if was_last:
                # previous block becomes the last metadata block: set its
                # is_last bit with a single byte write
                prev_off, idx = self._stream_start + 4, 0
                while idx < self.index - 1:
                    _l, _t, ln = self._read_header(prev_off)
                    prev_off += BLOCK_HEADER_LEN + ln
                    idx += 1
                _l, ptype, _ln = self._read_header(prev_off)
                self._write_at(prev_off, bytes([0x80 | ptype]))
        self.prev()
