"""FLAC format constants.

The analog of the reference's include/FLAC/format.h:92-153 limits and the
bit-length constants defined in src/libFLAC/format.c:69-132. Values are part
of the FLAC format specification (doc/html/format.html in the reference).
"""

MAX_METADATA_TYPE_CODE = 126

MIN_BLOCK_SIZE = 16
MAX_BLOCK_SIZE = 65535
SUBSET_MAX_BLOCK_SIZE_48000HZ = 4608

MAX_CHANNELS = 8
MIN_BITS_PER_SAMPLE = 4
MAX_BITS_PER_SAMPLE = 32
REFERENCE_CODEC_MAX_BITS_PER_SAMPLE = 24  # format.h:118

MAX_SAMPLE_RATE = 655350

MAX_LPC_ORDER = 32
SUBSET_MAX_LPC_ORDER_48000HZ = 12

MIN_QLP_COEFF_PRECISION = 5
MAX_QLP_COEFF_PRECISION = 15

MAX_FIXED_ORDER = 4

MAX_RICE_PARTITION_ORDER = 15
SUBSET_MAX_RICE_PARTITION_ORDER = 8

# Stream magic
STREAM_SYNC_STRING = b"fLaC"

# Metadata block types (format.h FLAC__MetadataType)
METADATA_TYPE_STREAMINFO = 0
METADATA_TYPE_PADDING = 1
METADATA_TYPE_APPLICATION = 2
METADATA_TYPE_SEEKTABLE = 3
METADATA_TYPE_VORBIS_COMMENT = 4
METADATA_TYPE_CUESHEET = 5
METADATA_TYPE_PICTURE = 6
METADATA_TYPE_UNDEFINED = 7

# Metadata block header field widths (format.c)
STREAM_METADATA_IS_LAST_LEN = 1
STREAM_METADATA_TYPE_LEN = 7
STREAM_METADATA_LENGTH_LEN = 24

# STREAMINFO field widths
STREAM_METADATA_STREAMINFO_MIN_BLOCK_SIZE_LEN = 16
STREAM_METADATA_STREAMINFO_MAX_BLOCK_SIZE_LEN = 16
STREAM_METADATA_STREAMINFO_MIN_FRAME_SIZE_LEN = 24
STREAM_METADATA_STREAMINFO_MAX_FRAME_SIZE_LEN = 24
STREAM_METADATA_STREAMINFO_SAMPLE_RATE_LEN = 20
STREAM_METADATA_STREAMINFO_CHANNELS_LEN = 3
STREAM_METADATA_STREAMINFO_BITS_PER_SAMPLE_LEN = 5
STREAM_METADATA_STREAMINFO_TOTAL_SAMPLES_LEN = 36
STREAM_METADATA_STREAMINFO_MD5SUM_LEN = 128
STREAM_METADATA_STREAMINFO_LENGTH = 34  # bytes

SEEKPOINT_SAMPLE_NUMBER_LEN = 64
SEEKPOINT_STREAM_OFFSET_LEN = 64
SEEKPOINT_FRAME_SAMPLES_LEN = 16
SEEKPOINT_LENGTH_BYTES = 18
SEEKPOINT_PLACEHOLDER = 0xFFFFFFFFFFFFFFFF  # format.c FLAC__STREAM_METADATA_SEEKPOINT_PLACEHOLDER

# Frame header (format.c:86-132)
FRAME_HEADER_SYNC = 0x3FFE
FRAME_HEADER_SYNC_LEN = 14
FRAME_HEADER_RESERVED_LEN = 1
FRAME_HEADER_BLOCKING_STRATEGY_LEN = 1
FRAME_HEADER_BLOCK_SIZE_LEN = 4
FRAME_HEADER_SAMPLE_RATE_LEN = 4
FRAME_HEADER_CHANNEL_ASSIGNMENT_LEN = 4
FRAME_HEADER_BITS_PER_SAMPLE_LEN = 3
FRAME_HEADER_ZERO_PAD_LEN = 1
FRAME_HEADER_CRC_LEN = 8
FRAME_FOOTER_CRC_LEN = 16

# Channel assignments (format.h FLAC__ChannelAssignment)
CHANNEL_ASSIGNMENT_INDEPENDENT = 0
CHANNEL_ASSIGNMENT_LEFT_SIDE = 1
CHANNEL_ASSIGNMENT_RIGHT_SIDE = 2
CHANNEL_ASSIGNMENT_MID_SIDE = 3

# Subframe types (format.h FLAC__SubframeType)
SUBFRAME_TYPE_CONSTANT = 0
SUBFRAME_TYPE_VERBATIM = 1
SUBFRAME_TYPE_FIXED = 2
SUBFRAME_TYPE_LPC = 3

# Subframe header field widths
SUBFRAME_ZERO_PAD_LEN = 1
SUBFRAME_TYPE_LEN = 6
SUBFRAME_WASTED_BITS_FLAG_LEN = 1
SUBFRAME_LPC_QLP_COEFF_PRECISION_LEN = 4
SUBFRAME_LPC_QLP_SHIFT_LEN = 5

# Subframe header 8-bit patterns before the wasted-bits flag
# (format.c FLAC__SUBFRAME_TYPE_*_BYTE_ALIGNED_MASK)
SUBFRAME_TYPE_CONSTANT_BYTE_ALIGNED_MASK = 0x00
SUBFRAME_TYPE_VERBATIM_BYTE_ALIGNED_MASK = 0x02
SUBFRAME_TYPE_FIXED_BYTE_ALIGNED_MASK = 0x10
SUBFRAME_TYPE_LPC_BYTE_ALIGNED_MASK = 0x40

# Entropy coding (format.h FLAC__EntropyCodingMethodType)
ENTROPY_CODING_METHOD_PARTITIONED_RICE = 0
ENTROPY_CODING_METHOD_PARTITIONED_RICE2 = 1
ENTROPY_CODING_METHOD_TYPE_LEN = 2
ENTROPY_CODING_METHOD_PARTITIONED_RICE_ORDER_LEN = 4
ENTROPY_CODING_METHOD_PARTITIONED_RICE_PARAMETER_LEN = 4
ENTROPY_CODING_METHOD_PARTITIONED_RICE2_PARAMETER_LEN = 5
ENTROPY_CODING_METHOD_PARTITIONED_RICE_RAW_LEN = 5
ENTROPY_CODING_METHOD_PARTITIONED_RICE_ESCAPE_PARAMETER = 15
ENTROPY_CODING_METHOD_PARTITIONED_RICE2_ESCAPE_PARAMETER = 31

# Valid sample rates for the 4-bit frame-header code (stream_encoder_framing.c:264-287)
FRAME_HEADER_SAMPLE_RATE_CODES = {
    88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11,
}

# 4-bit frame-header blocksize codes (stream_encoder_framing.c:238-258)
FRAME_HEADER_BLOCK_SIZE_CODES = {
    192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
    256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
    8192: 13, 16384: 14, 32768: 15,
}

# 3-bit frame-header bits-per-sample codes (stream_encoder_framing.c:318-326)
FRAME_HEADER_BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}
# decoder side: code -> bps (0 means "get from STREAMINFO", 3 and 7 reserved)
FRAME_HEADER_BPS_FROM_CODE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24}


def sample_rate_is_valid(sample_rate: int) -> bool:
    """FLAC__format_sample_rate_is_valid (reference format.c:213)."""
    return 0 < sample_rate <= MAX_SAMPLE_RATE


def blocksize_is_subset(blocksize: int, sample_rate: int) -> bool:
    """FLAC__format_blocksize_is_subset (reference format.c:222)."""
    if blocksize > 16384:
        return False
    if sample_rate <= 48000 and blocksize > 4608:
        return False
    return True


def sample_rate_is_subset(sample_rate: int) -> bool:
    """FLAC__format_sample_rate_is_subset (reference format.c:232).

    Subset requires the rate to be expressible in the frame header: either a
    tabled rate or one of the 8/16-bit encodable forms.
    """
    if not sample_rate_is_valid(sample_rate):
        return False
    if sample_rate in FRAME_HEADER_SAMPLE_RATE_CODES:
        return True
    return (
        (sample_rate <= 255000 and sample_rate % 1000 == 0)
        or sample_rate % 10 == 0
        or sample_rate <= 0xFFFF
    )


def max_rice_partition_order_from_blocksize(blocksize: int) -> int:
    """FLAC__format_get_max_rice_partition_order_from_blocksize (format.c:538)."""
    order = 0
    while not (blocksize & 1):
        order += 1
        blocksize >>= 1
    return min(MAX_RICE_PARTITION_ORDER, order)


def max_rice_partition_order_limited(limit: int, blocksize: int, predictor_order: int) -> int:
    """...from_blocksize_limited_max_and_predictor_order (format.c:548)."""
    order = limit
    while order > 0 and (blocksize >> order) <= predictor_order:
        order -= 1
    return order
