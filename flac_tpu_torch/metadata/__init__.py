"""FLAC metadata engine: block object model, stream I/O, and chain editing —
the port's copy of flac_tpu.metadata (blocks, and the level 0-2 API of
iterators: getters, SimpleIterator, MetadataChain). Host-side, pure Python;
Ogg chains wait for ogg.py (ROADMAP item 11b)."""

from flac_tpu_torch.metadata.iterators import (  # noqa: F401
    MetadataChain,
    MetadataIOError,
    SimpleIterator,
    get_cuesheet,
    get_picture,
    get_streaminfo,
    get_tags,
)
from flac_tpu_torch.metadata.blocks import (  # noqa: F401
    Application,
    CueSheet,
    CueSheetIndex,
    CueSheetTrack,
    MetadataBlock,
    Padding,
    Picture,
    SeekPoint,
    SeekTable,
    StreamInfo,
    Unknown,
    VorbisComment,
    parse_block,
    parse_metadata,
    serialize_block,
    serialize_metadata,
)
