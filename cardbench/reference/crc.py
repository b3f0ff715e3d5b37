"""The two CRCs of a FLAC frame, as the format defines them (RFC 9639,
sections 9.1.8 and 9.3): CRC-8 (polynomial x^8 + x^2 + x + 1, 0x07) over a
frame header, CRC-16 (x^16 + x^15 + x^2 + 1, 0x8005) over a whole frame
but its last two bytes. Both start from 0, are not reflected and are not
inverted at the end.

`crc16_rows` runs many frames at once, two bytes a step: a CRC of 16 bits
after two more bytes is `TABLE16[crc ^ word]`, where TABLE16 holds the CRC
of every two-byte word from a zero register.
"""

from __future__ import annotations

import numpy as np
import torch


def _table(poly: int, width: int, index_bits: int) -> np.ndarray:
    """CRC register (width bits) after `index_bits` bits of input from a
    zero register, for every input value: the register is the input,
    shifted to the top and divided bit by bit."""
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    out = np.zeros(1 << index_bits, np.int64)
    for v in range(1 << index_bits):
        crc = v << (width - index_bits) if width >= index_bits else v
        for _ in range(index_bits):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
        out[v] = crc
    return out


CRC8_TABLE = _table(0x07, 8, 8)
_TABLE16 = None


def crc16_word_table() -> np.ndarray:
    """The CRC-16 after each two-byte word (big-endian) from a zero
    register; built on first use (65,536 entries)."""
    global _TABLE16
    if _TABLE16 is None:
        byte = _table(0x8005, 16, 8)
        hi = np.arange(1 << 16, dtype=np.int64) >> 8
        lo = np.arange(1 << 16, dtype=np.int64) & 0xFF
        # one byte at a time: crc = (crc << 8) ^ T[(crc >> 8) ^ b]
        c = byte[hi]
        _TABLE16 = ((c << 8) & 0xFFFF) ^ byte[(c >> 8) ^ lo]
    return _TABLE16


def crc8(data) -> int:
    crc = 0
    for b in bytes(data):
        crc = int(CRC8_TABLE[crc ^ b])
    return crc


def crc16(data) -> int:
    table = crc16_word_table()
    data = bytes(data)
    crc = 0
    for i in range(0, len(data) - 1, 2):
        crc = int(table[crc ^ ((data[i] << 8) | data[i + 1])])
    if len(data) % 2:
        byte = _table(0x8005, 16, 8)
        crc = ((crc << 8) & 0xFFFF) ^ int(byte[(crc >> 8) ^ data[-1]])
    return crc


def crc8_rows(buf: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """CRC-8 of buf[starts[i] : starts[i] + lengths[i]] for every i (short
    spans: a frame header is at most 16 bytes)."""
    crc = np.zeros(len(starts), np.int64)
    if len(starts) == 0:
        return crc
    for j in range(int(lengths.max())):
        live = j < lengths
        b = buf[np.minimum(starts + j, len(buf) - 1)].astype(np.int64)
        crc = np.where(live, CRC8_TABLE[crc ^ b], crc)
    return crc


def crc16_rows(buf: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """CRC-16 of buf[starts[i] : starts[i] + lengths[i]] for every i, on
    buf's device: buf is uint8 bytes as an int64 tensor, zero-padded by at
    least two bytes; the spans run in lockstep, two bytes a step."""
    dev = buf.device
    table = torch.as_tensor(crc16_word_table(), device=dev)
    byte_table = torch.as_tensor(_table(0x8005, 16, 8), device=dev)
    crc = torch.zeros(starts.shape, dtype=torch.int64, device=dev)
    if starts.numel() == 0:
        return crc
    last = buf.numel() - 1
    pairs = lengths // 2
    for j in range(int(pairs.max())):
        at = torch.clamp(starts + 2 * j, max=last - 1)
        word = (buf[at] << 8) | buf[at + 1]
        crc = torch.where(j < pairs, table[crc ^ word], crc)
    odd = (lengths % 2) == 1
    at = torch.clamp(starts + lengths - 1, min=0, max=last)
    tail = ((crc << 8) & 0xFFFF) ^ byte_table[(crc >> 8) ^ buf[at]]
    return torch.where(odd, tail, crc)
