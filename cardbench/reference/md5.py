"""The MD5 that a stream's STREAMINFO holds, from the PCM alone.

The PCM is packed as the format says: channels interleaved, each sample
little-endian in (bits + 7) // 8 bytes, two's complement. The digest is
the one that this repository's reference `flac` writes, whose MD5 core
(md5.c, SWAP_BE_WORD_TO_HOST) loads each 64-byte block's sixteen data
words big-endian, while the 64-bit bit count of the last block stays two
host-order (little-endian) words. So the digest differs from standard MD5
on every input, and `hashlib` cannot give it.

What can be used is the standard compression function: loading a block's
words big-endian is loading the byte-reversed words little-endian. So the
whole blocks go, each 4-byte word reversed, through OpenSSL's MD5 (the
library that `hashlib` runs on, reached with ctypes, whose context shows
the four state words), and the last block, with its padding and bit
count, through the compression function written out below. Without
OpenSSL every block takes the Python path, which is slow, so that a test
can hold the two paths against each other.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
import struct

import numpy as np

_S = ((7, 12, 17, 22), (5, 9, 14, 20), (4, 11, 16, 23), (6, 10, 15, 21))
_K = [int(abs(math.sin(i + 1)) * 2 ** 32) & 0xFFFFFFFF for i in range(64)]
_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def compress(state: tuple, words: list[int]) -> tuple:
    """RFC 1321's compression of one block of sixteen 32-bit words."""
    a, b, c, d = state
    for i in range(64):
        r = i // 16
        if r == 0:
            f, g = (b & c) | (~b & d), i
        elif r == 1:
            f, g = (d & b) | (~d & c), (5 * i + 1) % 16
        elif r == 2:
            f, g = b ^ c ^ d, (3 * i + 5) % 16
        else:
            f, g = c ^ (b | (~d & 0xFFFFFFFF)), (7 * i) % 16
        f &= 0xFFFFFFFF
        a, d, c, b = d, c, b, (b + _rotl((a + f + _K[i] + words[g]) & 0xFFFFFFFF,
                                          _S[r][i % 4])) & 0xFFFFFFFF
    return tuple((x + y) & 0xFFFFFFFF for x, y in zip(state, (a, b, c, d)))


class _Ctx(ctypes.Structure):
    # OpenSSL's MD5_CTX (md5.h): A, B, C, D, Nl, Nh, data[16], num
    _fields_ = [("A", ctypes.c_uint32), ("B", ctypes.c_uint32),
                ("C", ctypes.c_uint32), ("D", ctypes.c_uint32),
                ("Nl", ctypes.c_uint32), ("Nh", ctypes.c_uint32),
                ("data", ctypes.c_uint32 * 16), ("num", ctypes.c_uint32)]


def _openssl():
    name = ctypes.util.find_library("crypto")
    if name is None:
        return None
    try:
        lib = ctypes.CDLL(name)
        lib.MD5_Init.argtypes = [ctypes.POINTER(_Ctx)]
        lib.MD5_Update.argtypes = [ctypes.POINTER(_Ctx), ctypes.c_char_p, ctypes.c_size_t]
        lib.MD5_Init.restype = lib.MD5_Update.restype = ctypes.c_int
    except (OSError, AttributeError):
        return None
    return lib


_LIB = _openssl()


def pack_pcm(pcm: np.ndarray, bits: int) -> bytes:
    """int [n, channels] PCM as the bytes the MD5 covers."""
    width = (bits + 7) // 8
    flat = np.ascontiguousarray(pcm, dtype=np.int32).reshape(-1)
    if width == 3:
        return np.ascontiguousarray(flat.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]).tobytes()
    return flat.astype({1: "i1", 2: "<i2", 4: "<i4"}[width]).tobytes()


def _blocks(state: tuple, data: bytes) -> tuple:
    for i in range(0, len(data), 64):
        state = compress(state, list(struct.unpack(">16I", data[i:i + 64])))
    return state


def flac_md5(pcm: np.ndarray, bits: int, use_openssl: bool = True) -> bytes:
    """STREAMINFO's MD5 of `pcm` at `bits` bits a sample."""
    data = pack_pcm(pcm, bits)
    whole = len(data) - len(data) % 64
    if use_openssl and _LIB is not None and whole:
        swapped = np.frombuffer(data, "<u4", whole // 4).byteswap().tobytes()
        ctx = _Ctx()
        _LIB.MD5_Init(ctypes.byref(ctx))
        _LIB.MD5_Update(ctypes.byref(ctx), swapped, whole)
        state = (ctx.A, ctx.B, ctx.C, ctx.D)
    else:
        state = _blocks(_INIT, data[:whole])
    tail = data[whole:] + b"\x80"
    if len(tail) > 56:
        state = _blocks(state, tail.ljust(64, b"\x00"))
        tail = b""
    words = list(struct.unpack(">14I", tail.ljust(56, b"\x00")))
    bit_count = (len(data) * 8) & (2 ** 64 - 1)
    state = compress(state, words + [bit_count & 0xFFFFFFFF, bit_count >> 32])
    return struct.pack("<4I", *state)
