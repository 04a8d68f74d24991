"""Compressed alignment serialization.

Byte-exact reimplementation of the reference's compressed alignment
format (reference: src/compressAlignment.{hpp,cpp}): an alignment is a
sequence of streaks (skip0, skip1, n) — n consecutive matched ordinal
pairs both incrementing by one, preceded by skips relative to the end
of the previous streak. Each streak serializes in the smallest of five
little-endian formats (1/2/4/8/16 bytes), identified by the low bits
of the first byte:

format    id bits  skip bits (signed)   n-1 bits  size
0         0        2 (unsigned)         3         1
1         001      4                    5         2
2         011      10                   9         4
3         101      20                   21        8
4         111      32                   32        16
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def _streaks(ord0: np.ndarray, ord1: np.ndarray):
    """Yield (skip0, skip1, n) streaks (reference: compressAlignment.cpp:11-45)."""
    n_total = ord0.shape[0]
    if n_total == 0:
        return []
    o0 = ord0.astype(np.int64)
    o1 = ord1.astype(np.int64)
    brk = np.flatnonzero((np.diff(o0) != 1) | (np.diff(o1) != 1)) + 1
    starts = np.concatenate(([0], brk))
    ends = np.concatenate((brk, [n_total]))
    out = []
    prev0 = 0
    prev1 = 0
    for s, e in zip(starts, ends):
        skip0 = int(o0[s] - prev0)
        skip1 = int(o1[s] - prev1)
        out.append((skip0, skip1, int(e - s)))
        prev0 = int(o0[e - 1])
        prev1 = int(o1[e - 1])
    return out


def compress_alignment(ord0: np.ndarray, ord1: np.ndarray) -> bytes:
    """Serialize matched ordinal pairs to the compressed format."""
    parts = []
    for skip0, skip1, n in _streaks(ord0, ord1):
        if 0 <= skip0 <= 3 and 0 <= skip1 <= 3 and n <= 8:
            parts.append(
                struct.pack(
                    "<B", 0 | (skip0 << 1) | (skip1 << 3) | ((n - 1) << 5)
                )
            )
        elif -8 <= skip0 <= 7 and -8 <= skip1 <= 7 and n <= 32:
            parts.append(
                struct.pack(
                    "<H",
                    0b001
                    | ((skip0 & 0xF) << 3)
                    | ((skip1 & 0xF) << 7)
                    | ((n - 1) << 11),
                )
            )
        elif -512 <= skip0 <= 511 and -512 <= skip1 <= 511 and n <= 512:
            parts.append(
                struct.pack(
                    "<I",
                    0b011
                    | ((skip0 & 0x3FF) << 3)
                    | ((skip1 & 0x3FF) << 13)
                    | ((n - 1) << 23),
                )
            )
        elif (
            -(1 << 19) <= skip0 < (1 << 19)
            and -(1 << 19) <= skip1 < (1 << 19)
            and n <= (1 << 21)
        ):
            parts.append(
                struct.pack(
                    "<Q",
                    0b101
                    | ((skip0 & 0xFFFFF) << 3)
                    | ((skip1 & 0xFFFFF) << 23)
                    | ((n - 1) << 43),
                )
            )
        else:
            parts.append(struct.pack("<IiiI", 0b111, skip0, skip1, n - 1))
    return b"".join(parts)


def _sext(v: int, bits: int) -> int:
    sign = 1 << (bits - 1)
    return (v & (sign - 1)) - (v & sign)


def decompress_alignment(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of compress_alignment. Returns (ord0, ord1) uint32."""
    o0 = []
    o1 = []
    pos = 0
    cur0 = 0
    cur1 = 0
    n_bytes = len(data)
    while pos < n_bytes:
        first = data[pos]
        if (first & 1) == 0:
            w = first
            skip0 = (w >> 1) & 3
            skip1 = (w >> 3) & 3
            n = ((w >> 5) & 7) + 1
            pos += 1
        else:
            fid = first & 7
            if fid == 0b001:
                (w,) = struct.unpack_from("<H", data, pos)
                skip0 = _sext(w >> 3, 4)
                skip1 = _sext(w >> 7, 4)
                n = ((w >> 11) & 0x1F) + 1
                pos += 2
            elif fid == 0b011:
                (w,) = struct.unpack_from("<I", data, pos)
                skip0 = _sext(w >> 3, 10)
                skip1 = _sext(w >> 13, 10)
                n = ((w >> 23) & 0x1FF) + 1
                pos += 4
            elif fid == 0b101:
                (w,) = struct.unpack_from("<Q", data, pos)
                skip0 = _sext(w >> 3, 20)
                skip1 = _sext(w >> 23, 20)
                n = ((w >> 43) & 0x1FFFFF) + 1
                pos += 8
            elif fid == 0b111:
                _, skip0, skip1, nm1 = struct.unpack_from("<IiiI", data, pos)
                n = nm1 + 1
                pos += 16
            else:
                raise ValueError(f"Bad format identifier {fid:#b}")
        start0 = cur0 + skip0
        start1 = cur1 + skip1
        o0.extend(range(start0, start0 + n))
        o1.extend(range(start1, start1 + n))
        cur0 = start0 + n - 1
        cur1 = start1 + n - 1
    return np.asarray(o0, np.uint32), np.asarray(o1, np.uint32)
