"""FLAC metadata block object model and (de)serialization — the port's copy
of flac_tpu.metadata.blocks. The level-2 chain/iterator API
(flac_tpu.metadata.iterators) is not ported yet."""

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
