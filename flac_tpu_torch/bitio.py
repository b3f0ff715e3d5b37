"""Host-side bit-level I/O and UTF-8-style number coding.

The host analog of the reference src/libFLAC/bitwriter.c / bitreader.c. On the
TPU path these are replaced by the batched field packer
(flac_tpu.encode.packer) and the batched bit-gather reader
(flac_tpu.decode.bitgather); the classes here serve the host-side paths:
metadata blocks, stream headers, the robust/fallback decoder, and tests.

UTF-8-style extended number coding follows bitwriter.c:784 (32-bit, up to 6
bytes) and bitwriter.c:830 (64-bit, up to 7 bytes with 0xFE lead byte).
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Append-only MSB-first bit writer backed by a Python int accumulator."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0  # bits not yet flushed, MSB-first in the low `_nacc` bits
        self._nacc = 0

    @property
    def bit_length(self) -> int:
        return 8 * len(self._bytes) + self._nacc

    def write_bits(self, value: int, nbits: int) -> None:
        """Write the low `nbits` bits of `value` (unsigned), MSB first."""
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nacc += nbits
        while self._nacc >= 8:
            self._nacc -= 8
            self._bytes.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def write_signed_bits(self, value: int, nbits: int) -> None:
        """Two's-complement signed write (bitwriter write_raw_int32)."""
        self.write_bits(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, value: int) -> None:
        """`value` zero bits then a one bit (bitwriter.c write_unary_unsigned)."""
        self.write_bits(1, value + 1)

    def write_rice_signed(self, value: int, parameter: int) -> None:
        """Sign-fold then unary quotient + stop bit + `parameter` LSBs
        (bitwriter.c:544 write_rice_signed_block: fold is (v<<1)^(v>>31))."""
        folded = (value << 1) ^ (value >> 63) if value < 0 else (value << 1)
        q = folded >> parameter
        self.write_bits(1, q + 1)
        self.write_bits(folded & ((1 << parameter) - 1), parameter)

    def write_utf8_u32(self, val: int) -> None:
        for byte in utf8_encode(val):
            self.write_bits(byte, 8)

    def write_utf8_u64(self, val: int) -> None:
        for byte in utf8_encode(val, wide=True):
            self.write_bits(byte, 8)

    def zero_pad_to_byte(self) -> None:
        if self._nacc:
            self.write_bits(0, 8 - self._nacc)

    def is_byte_aligned(self) -> bool:
        return self._nacc == 0

    def getvalue(self) -> bytes:
        assert self._nacc == 0, "buffer not byte-aligned"
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader over a bytes-like buffer."""

    def __init__(self, data: bytes | bytearray | np.ndarray, bit_pos: int = 0) -> None:
        self.data = bytes(data)
        self.pos = bit_pos  # absolute bit position

    @property
    def bits_remaining(self) -> int:
        return 8 * len(self.data) - self.pos

    def read_bits(self, nbits: int) -> int:
        """Read `nbits` as an unsigned int."""
        if nbits == 0:
            return 0
        start_byte = self.pos >> 3
        end_byte = (self.pos + nbits + 7) >> 3
        if end_byte > len(self.data):
            raise EOFError("bit reader exhausted")
        chunk = int.from_bytes(self.data[start_byte:end_byte], "big")
        total_bits = 8 * (end_byte - start_byte)
        shift = total_bits - (self.pos - 8 * start_byte) - nbits
        self.pos += nbits
        return (chunk >> shift) & ((1 << nbits) - 1)

    def read_signed_bits(self, nbits: int) -> int:
        v = self.read_bits(nbits)
        if v >= (1 << (nbits - 1)):
            v -= 1 << nbits
        return v

    def read_unary(self) -> int:
        """Count zero bits up to the terminating one bit."""
        count = 0
        # scan byte-at-a-time for speed
        while True:
            byte_idx = self.pos >> 3
            if byte_idx >= len(self.data):
                raise EOFError("bit reader exhausted in unary")
            bit_off = self.pos & 7
            window = self.data[byte_idx] & (0xFF >> bit_off)
            if window == 0:
                count += 8 - bit_off
                self.pos += 8 - bit_off
                continue
            lead = 7 - window.bit_length() + 1  # index of highest set bit from MSB
            zeros = lead - bit_off
            count += zeros
            self.pos += zeros + 1
            return count

    def read_rice_signed(self, parameter: int) -> int:
        q = self.read_unary()
        folded = (q << parameter) | self.read_bits(parameter)
        return (folded >> 1) ^ -(folded & 1)

    def read_utf8_u64(self) -> int:
        return utf8_decode(self)

    def align_to_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def is_byte_aligned(self) -> bool:
        return (self.pos & 7) == 0


def utf8_encode(val: int, wide: bool = False) -> bytes:
    """UTF-8-style coding of a frame/sample number (bitwriter.c:784,830).

    Standard UTF-8 byte patterns extended to 36 bits with a 7-byte 0xFE form.
    """
    if val < 0x80:
        return bytes([val])
    if val < 0x800:
        return bytes([0xC0 | (val >> 6), 0x80 | (val & 0x3F)])
    if val < 0x10000:
        return bytes([0xE0 | (val >> 12), 0x80 | ((val >> 6) & 0x3F), 0x80 | (val & 0x3F)])
    if val < 0x200000:
        return bytes([0xF0 | (val >> 18), 0x80 | ((val >> 12) & 0x3F),
                      0x80 | ((val >> 6) & 0x3F), 0x80 | (val & 0x3F)])
    if val < 0x4000000:
        return bytes([0xF8 | (val >> 24), 0x80 | ((val >> 18) & 0x3F), 0x80 | ((val >> 12) & 0x3F),
                      0x80 | ((val >> 6) & 0x3F), 0x80 | (val & 0x3F)])
    if val < 0x80000000:
        return bytes([0xFC | (val >> 30), 0x80 | ((val >> 24) & 0x3F), 0x80 | ((val >> 18) & 0x3F),
                      0x80 | ((val >> 12) & 0x3F), 0x80 | ((val >> 6) & 0x3F), 0x80 | (val & 0x3F)])
    if not wide or val >= (1 << 36):
        raise ValueError(f"value {val} out of range for UTF-8 coding")
    return bytes([0xFE, 0x80 | ((val >> 30) & 0x3F), 0x80 | ((val >> 24) & 0x3F),
                  0x80 | ((val >> 18) & 0x3F), 0x80 | ((val >> 12) & 0x3F),
                  0x80 | ((val >> 6) & 0x3F), 0x80 | (val & 0x3F)])


def utf8_encoded_len(val: int) -> int:
    """Byte length of utf8_encode(val) without materializing it."""
    for length, limit in ((1, 0x80), (2, 0x800), (3, 0x10000), (4, 0x200000),
                          (5, 0x4000000), (6, 0x80000000)):
        if val < limit:
            return length
    return 7


def utf8_decode(reader: BitReader) -> int:
    """Inverse of utf8_encode, reading from a BitReader (bitreader.c:999,1054).

    Returns the decoded number; raises ValueError on malformed sequences.
    """
    b0 = reader.read_bits(8)
    if b0 < 0x80:
        return b0
    if b0 == 0xFE:
        ncont, val = 6, 0
    elif b0 >= 0xFC:
        ncont, val = 5, b0 & 0x01
    elif b0 >= 0xF8:
        ncont, val = 4, b0 & 0x03
    elif b0 >= 0xF0:
        ncont, val = 3, b0 & 0x07
    elif b0 >= 0xE0:
        ncont, val = 2, b0 & 0x0F
    elif b0 >= 0xC0:
        ncont, val = 1, b0 & 0x1F
    else:
        raise ValueError("malformed UTF-8 coded number")
    for _ in range(ncont):
        b = reader.read_bits(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("malformed UTF-8 continuation byte")
        val = (val << 6) | (b & 0x3F)
    return val
