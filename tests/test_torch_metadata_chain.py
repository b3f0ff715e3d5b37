"""The port's metadata chain, iterator, getters and grabbag against flac_tpu's,
on the CPU.

Each case encodes one small stream with the port (byte-identical to
flac_tpu's encoder), applies the same edit through `flac_tpu.metadata` to
one copy and through `flac_tpu_torch.metadata` to another, and requires the
two files, and what the edit returned, to be equal byte for byte: in-place
writes into PADDING, the tempfile rewrite, merge and sort of padding, the
level-1 iterator's set, insert and delete, and the handle-based I/O. The
grabbag parsers and emitters give equal blocks, text and errors. Ogg input
raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import shutil
import struct
import zlib

import pytest

from conftest import make_signal
from flac_tpu import grabbag as j_gb
from flac_tpu import metadata as j_md
from flac_tpu_torch import grabbag as t_gb
from flac_tpu_torch import metadata as t_md
from flac_tpu_torch.encode import encoder as t_enc

SIG = make_signal(4096 * 2 + 300, 2, 16, kind="quiet", seed=21)


def _png_bytes(w=8, h=8):
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)

    def chunk(typ, data):
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))
    return (b"\x89PNG\x0d\x0a\x1a\x0a" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", b"\x00") + chunk(b"IEND", b""))


def _pair(tmp_path, metadata):
    src = tmp_path / "src.flac"
    t_enc.encode_file(SIG, 44100, 16, str(src), level=2, batch_frames=8,
                      metadata=metadata, device="cpu")
    paths = []
    for name in ("j.flac", "t.flac"):
        shutil.copy(src, tmp_path / name)
        paths.append(str(tmp_path / name))
    return paths


def _find(md, path, cls):
    it = md.SimpleIterator(path)
    while not isinstance(it.get_block(), cls):
        assert it.next()
    return it


def chain_inplace_padding(md, p):
    chain = md.MetadataChain.read(p)
    needed = chain.check_if_tempfile_needed()
    tags = chain.get(md.VorbisComment)
    tags.set_entry("TITLE", "A much longer title than before")
    tags.set_entry("ALBUM", "New Album")
    chain.write(use_padding=True)
    return needed


def chain_rewrite_tempfile(md, p):
    chain = md.MetadataChain.read(p)
    chain.get(md.VorbisComment).set_entry("COMMENT", "y" * 4000)
    needed = chain.check_if_tempfile_needed(use_padding=True)
    chain.write(use_padding=True)
    return needed


def chain_shrink_no_padding(md, p):
    chain = md.MetadataChain.read(p)
    chain.get(md.VorbisComment).remove_entries("C")
    chain.write(use_padding=False)


def chain_merge_sort_padding(md, p):
    chain = md.MetadataChain.read(p)
    chain.merge_padding()
    lengths = [b.length for b in chain.blocks if isinstance(b, md.Padding)]
    chain.sort_padding()
    removed = chain.remove(lambda b: isinstance(b, md.Application))
    chain.write()
    return lengths, removed


def chain_streaminfo_first(md, p):
    chain = md.MetadataChain.read(p)
    chain.blocks = chain.blocks[1:]
    with pytest.raises(md.MetadataIOError) as e:
        chain.write()
    return str(e.value)


def chain_io_in_place_and_tempfile(md, p):
    with open(p, "r+b") as f:
        chain = md.MetadataChain.read_io(f)
        chain.get(md.VorbisComment).set_entry("GENRE", "Test")
        chain.write_io(f)
    with open(p, "rb") as f:
        chain = md.MetadataChain.read_io(f)
    chain.get(md.VorbisComment).set_entry("COMMENT", "z" * 3000)
    with open(p, "rb") as f, open(p + ".tmp", "wb") as out:
        chain.write_io_tempfile(f, out)
    shutil.move(p + ".tmp", p)


def iterator_walk_set(md, p):
    it = md.SimpleIterator(p)
    types = [it.get_block_type()]
    offsets = [it.get_block_offset()]
    while it.next():
        types.append(it.get_block_type())
        offsets.append(it.get_block_offset())
    it2 = _find(md, p, md.VorbisComment)
    it2.set_block(md.VorbisComment(vendor_string="x", comments=["TITLE=replaced"]),
                  use_padding=True)
    return types, offsets, len(it)


def iterator_insert_delete(md, p):
    it = md.SimpleIterator(p)
    it.insert_block_after(md.Application(app_id=b"abcd", data=b"payload"))
    t = it.get_block_type()
    it3 = md.SimpleIterator(p)
    while it3.get_block_type() != 2:
        assert it3.next()
    it3.delete_block(use_padding=True)
    return t


def iterator_set_shrink_and_grow(md, p):
    it = _find(md, p, md.VorbisComment)
    it.set_block(md.VorbisComment(vendor_string="x", comments=["TITLE=z"]))
    it = _find(md, p, md.VorbisComment)
    big = md.VorbisComment(vendor_string="x", comments=["TITLE=" + "q" * 5000])
    it.set_block(big, use_padding=True)
    return it.get_block_length()


def iterator_delete_last(md, p):
    it = md.SimpleIterator(p)
    while not it.is_last():
        assert it.next()
    it.delete_block(use_padding=False)
    return it.is_last(), it.get_block_type()


def _vc(md, *comments):
    return md.VorbisComment(vendor_string="x", comments=list(comments))


# name -> (edit, the stream's metadata in the port's blocks)
CASES = {
    "chain_inplace_padding": (chain_inplace_padding,
                              [_vc(t_md, "TITLE=Old"), t_md.Padding(length=512)]),
    "chain_rewrite_tempfile": (chain_rewrite_tempfile, [_vc(t_md)]),
    "chain_shrink_no_padding": (chain_shrink_no_padding, [_vc(t_md, "C=" + "z" * 1000)]),
    "chain_merge_sort_padding": (chain_merge_sort_padding, [
        t_md.Padding(length=10), t_md.Padding(length=20),
        t_md.Application(app_id=b"test", data=b"d"), t_md.Padding(length=30)]),
    "chain_streaminfo_first": (chain_streaminfo_first, None),
    "chain_io": (chain_io_in_place_and_tempfile, [_vc(t_md), t_md.Padding(length=256)]),
    "iterator_walk_set": (iterator_walk_set, [_vc(t_md, "TITLE=t"), t_md.Padding(length=256)]),
    "iterator_insert_delete": (iterator_insert_delete, [t_md.Padding(length=128)]),
    "iterator_set_shrink_and_grow": (iterator_set_shrink_and_grow,
                                     [_vc(t_md, "TITLE=" + "y" * 64)]),
    "iterator_delete_last": (iterator_delete_last, [_vc(t_md, "TITLE=tail")]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_edit_gives_flac_tpus_bytes(tmp_path, case):
    edit, metadata = CASES[case]
    jp, tp = _pair(tmp_path, metadata)
    before = open(tp, "rb").read()
    ref = edit(j_md, jp)
    got = edit(t_md, tp)
    assert got == ref
    after = open(tp, "rb").read()
    assert after == open(jp, "rb").read()
    if case != "chain_streaminfo_first":
        assert after != before


def test_getters_match(tmp_path):
    pic = t_md.Picture(picture_type=3, mime_type="image/png", description="cover",
                       width=2, height=2, depth=24, data=b"\x89PNGfake")
    cue = t_gb.cuesheet_parse(CUE_TEXT, 44100, True, len(SIG) // 588 * 588)
    _, p = _pair(tmp_path, [_vc(t_md, "TITLE=Song", "ARTIST=Me"), pic, cue])
    for getter, kw in (("get_streaminfo", {}), ("get_tags", {}), ("get_cuesheet", {}),
                       ("get_picture", {"picture_type": 3}),
                       ("get_picture", {"picture_type": 4}),
                       ("get_picture", {"max_width": 1})):
        got = getattr(t_md, getter)(p, **kw)
        ref = getattr(j_md, getter)(p, **kw)
        assert (got is None) == (ref is None)
        if got is not None:
            assert t_md.serialize_block(got, False) == j_md.serialize_block(ref, False)
    assert t_md.get_picture(p, picture_type=3).data == b"\x89PNGfake"


def test_ogg_input_raises_naming_its_roadmap_item(tmp_path):
    p = tmp_path / "x.oga"
    p.write_bytes(b"OggS" + bytes(60))
    with pytest.raises(NotImplementedError, match="11b"):
        t_md.MetadataChain.read(str(p))
    with open(p, "rb") as f, pytest.raises(NotImplementedError, match="11b"):
        t_md.MetadataChain.read_io(f)
    with pytest.raises(t_md.MetadataIOError, match="not a FLAC file"):
        t_md.get_tags(str(p))


CUE_TEXT = """\
CATALOG 1234567890123
FILE "x.wav" WAVE
  TRACK 01 AUDIO
    ISRC USRC17607839
    INDEX 01 00:00:00
  TRACK 02 AUDIO
    FLAGS PRE
    INDEX 00 00:04:00
    INDEX 01 00:05:37
"""


@pytest.mark.parametrize("spec,total", [
    ("4x", 1000), ("1s", 44100 * 3 + 5), ("X;100;50;X", 1000),
    ("100;100;2000", 1000), ("10x;1s;X", 0), ("2.5s;7x", 44100 * 10),
])
def test_seektable_spec_matches(spec, total):
    got_pts, got_real = t_gb.seektable_from_specification(spec, total, 44100)
    ref_pts, ref_real = j_gb.seektable_from_specification(spec, total, 44100)
    key = [(p.sample_number, p.stream_offset, p.frame_samples) for p in got_pts]
    assert key == [(p.sample_number, p.stream_offset, p.frame_samples) for p in ref_pts]
    assert got_real == ref_real
    sorted_got = t_gb.seektable_template_sort(got_pts)
    sorted_ref = j_gb.seektable_template_sort(ref_pts)
    assert [p.sample_number for p in sorted_got] == [p.sample_number for p in sorted_ref]


@pytest.mark.parametrize("text,rate,cdda,lead_out", [
    (CUE_TEXT, 44100, True, 44100 * 60),
    ("TRACK 01 AUDIO\n  INDEX 01 0\nTRACK 02 AUDIO\n  INDEX 01 96000\n", 96000, False,
     96000 * 9),
    ("TRACK 01 AUDIO\n", 44100, True, 100),
    ("TRACK 01 AUDIO\n INDEX 01 00:01:00\n", 44100, True, 10 ** 6),
    (CUE_TEXT, 48000, True, 100),
])
def test_cuesheet_parse_and_emit_match(text, rate, cdda, lead_out):
    try:
        ref = j_gb.cuesheet_parse(text, rate, cdda, lead_out)
    except j_gb.CueSheetParseError as e:
        with pytest.raises(t_gb.CueSheetParseError) as got:
            t_gb.cuesheet_parse(text, rate, cdda, lead_out)
        assert str(got.value) == str(e)
        return
    got = t_gb.cuesheet_parse(text, rate, cdda, lead_out)
    assert got.body_bytes() == ref.body_bytes()
    assert t_gb.cuesheet_emit(got) == j_gb.cuesheet_emit(ref)


@pytest.mark.parametrize("spec", [
    "{png}", "4||desc||{png}", "3|image/png|c|300x200x24/0|{png}",
    "3|-->|c|10x10x24|http://x/y.png", "1||||{png}", "1||||{icon}", "99||||{png}",
])
def test_picture_spec_matches(tmp_path, spec):
    (tmp_path / "a.png").write_bytes(_png_bytes(8, 8))
    (tmp_path / "i.png").write_bytes(_png_bytes(32, 32))
    spec = spec.format(png=tmp_path / "a.png", icon=tmp_path / "i.png")
    try:
        ref = j_gb.picture_from_specification(spec)
    except j_gb.PictureSpecError as e:
        with pytest.raises(t_gb.PictureSpecError) as got:
            t_gb.picture_from_specification(spec)
        assert str(got.value) == str(e)
        return
    got = t_gb.picture_from_specification(spec)
    assert got.body_bytes() == ref.body_bytes()
