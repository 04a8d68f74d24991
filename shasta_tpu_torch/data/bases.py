"""Base encoding and small sequence utilities.

Encoding follows the reference convention (reference: src/Base.hpp:44-47):
A=0, C=1, G=2, T=3, so that complement(b) == 3 - b.

All routines are vectorized numpy over flat uint8 arrays; the same
encoding is used on device (int8/int32 arrays in HBM).
"""

from __future__ import annotations

import numpy as np

# Character -> 2-bit code lookup (255 = invalid).
_CHAR_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _c, _v in [("A", 0), ("C", 1), ("G", 2), ("T", 3)]:
    _CHAR_TO_CODE[ord(_c)] = _v
    _CHAR_TO_CODE[ord(_c.lower())] = _v

_CODE_TO_CHAR = np.frombuffer(b"ACGT", dtype=np.uint8)

INVALID_BASE = np.uint8(255)


def encode_ascii(buf: np.ndarray) -> np.ndarray:
    """Map an ASCII uint8 array to 2-bit base codes (255 for invalid)."""
    return _CHAR_TO_CODE[buf]


def encode_str(s: str) -> np.ndarray:
    return encode_ascii(np.frombuffer(s.encode(), dtype=np.uint8))


def decode_to_str(codes: np.ndarray) -> str:
    return _CODE_TO_CHAR[codes].tobytes().decode()


def complement(codes: np.ndarray) -> np.ndarray:
    """Complement of base codes (A<->T, C<->G)."""
    return (3 - codes.astype(np.uint8)).astype(np.uint8)


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    return complement(codes)[::-1].copy()
