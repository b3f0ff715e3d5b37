"""CRC-8 and CRC-16 for FLAC framing.

The analog of the reference src/libFLAC/crc.c: CRC-8 (poly x^8+x^2+x+1 = 0x07)
over frame headers, CRC-16 (poly x^16+x^15+x^2+1 = 0x8005) over whole frames.
Both MSB-first, init 0, no final xor.

Three implementations live here:

* scalar host CRC over ``bytes`` (metadata paths, small inputs),
* batched columnwise host CRC over a ``[B, L]`` byte matrix with per-row
  lengths (numpy),
* the GF(2) machinery used by the device packer: because CRC is linear over
  GF(2), CRC(M) is the XOR over set bits of ``x^(dist+width) mod G`` where
  ``dist`` is the bit's distance from the end of the message. The device
  encoder computes each bit-field's contribution with a carryless multiply
  against a precomputed ``x^d mod G`` table and XOR-reduces — a pure
  reduction, no sequential scan (replaces the byte-serial loops at
  crc.c:113-141).
"""

from __future__ import annotations

import numpy as np

CRC8_POLY = 0x07
CRC16_POLY = 0x8005


def _make_table(poly: int, width: int) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for i in range(256):
        crc = i << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & top) else (crc << 1)
        table[i] = crc & mask
    return table


CRC8_TABLE = _make_table(CRC8_POLY, 8).astype(np.uint8)
CRC16_TABLE = _make_table(CRC16_POLY, 16).astype(np.uint16)


def crc8(data: bytes | np.ndarray, init: int = 0) -> int:
    crc = init
    for b in bytes(data):
        crc = CRC8_TABLE[crc ^ b]
    return int(crc)


def crc16(data: bytes | np.ndarray, init: int = 0) -> int:
    crc = init
    for b in bytes(data):
        crc = (int(CRC16_TABLE[(crc >> 8) ^ b]) ^ (crc << 8)) & 0xFFFF
    return int(crc)


def crc16_batch(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """CRC-16 of each row of a [B, L] uint8 matrix, row i over rows[i, :lengths[i]].

    Columnwise so the inner step is vectorized over the batch.
    """
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    lengths = np.asarray(lengths)
    crc = np.zeros(rows.shape[0], dtype=np.uint32)
    maxlen = int(lengths.max(initial=0))
    for j in range(maxlen):
        nxt = (CRC16_TABLE[((crc >> 8) ^ rows[:, j]) & 0xFF].astype(np.uint32) ^ (crc << 8)) & 0xFFFF
        crc = np.where(j < lengths, nxt, crc)
    return crc.astype(np.uint16)


def crc8_batch(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """CRC-8 of each row of a [B, L] uint8 matrix (frame headers)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    lengths = np.asarray(lengths)
    crc = np.zeros(rows.shape[0], dtype=np.uint32)
    maxlen = int(lengths.max(initial=0))
    for j in range(maxlen):
        nxt = CRC8_TABLE[(crc ^ rows[:, j]) & 0xFF].astype(np.uint32)
        crc = np.where(j < lengths, nxt, crc)
    return crc.astype(np.uint8)


def x_pow_mod_table(max_power: int, poly: int, width: int) -> np.ndarray:
    """[max_power] table where entry d = x^d mod G, as a width-bit integer.

    Entry d is the CRC contribution pattern of a single set bit whose padded
    distance from the end of the message is d (after the implicit *x^width).
    """
    mask = (1 << width) - 1
    top = 1 << (width - 1)
    out = np.zeros(max_power, dtype=np.uint32)
    cur = 1  # x^0
    for d in range(max_power):
        out[d] = cur
        cur = ((cur << 1) ^ poly) if (cur & top) else (cur << 1)
        cur &= mask
    return out


def crc16_of_bits_reference(values: np.ndarray, nbits: np.ndarray) -> int:
    """Reference (slow) CRC-16 of a concatenated bit-field sequence.

    Used only in tests to validate the device-side GF(2) reduction: packs the
    fields MSB-first into bytes and runs the byte-serial CRC.
    """
    total = int(nbits.sum())
    assert total % 8 == 0
    bits = np.zeros(total, dtype=np.uint8)
    pos = 0
    for v, n in zip(values.tolist(), nbits.tolist()):
        for j in range(n):
            bits[pos + n - 1 - j] = (int(v) >> j) & 1
        pos += n
    return crc16(np.packbits(bits).tobytes())
