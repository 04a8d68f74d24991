"""Vectorized hash functions.

The reference hashes LowHash features with MurmurHash64A and k-mer ids
with 32-bit MurmurHash2 (reference: src/MurmurHash2.cpp, used at
src/LowHash0.cpp:349 and src/AssemblerKmers.cpp:185). Both are
public-domain algorithms (Austin Appleby); MurmurHash64A runs in the
native library and MurmurHash2 is an exact vectorized numpy
reimplementation, so candidate generation and marker downsampling
match the reference bit for bit; splitmix32 is a fast 32-bit mix.
"""

from __future__ import annotations

import numpy as np


def murmur64_features(features: np.ndarray, seed: int) -> np.ndarray:
    """MurmurHash64A over rows of little-endian uint32 words.

    ``features``: (n, m) uint32 — each row is one key of m*4 bytes.
    Returns (n,) uint64 hashes, identical to MurmurHash64A(key, 4*m, seed)
    (one threaded native pass).
    """
    from shasta_tpu_torch import native

    return native.murmur64_features_native(features, seed)


_M32 = np.uint32(0x5BD1E995)
_R32 = np.uint32(24)


def murmur32_u64(keys: np.ndarray, seed: int) -> np.ndarray:
    """32-bit MurmurHash2 of 8-byte little-endian uint64 keys.

    Matches MurmurHash2(&key, 8, seed) on a little-endian machine.
    Returns (n,) uint32.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    h = np.full(keys.shape, np.uint32(seed) ^ np.uint32(8), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for word in (
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (keys >> np.uint64(32)).astype(np.uint32),
        ):
            k = word.copy()
            k *= _M32
            k ^= k >> _R32
            k *= _M32
            h *= _M32
            h ^= k
        h ^= h >> np.uint32(13)
        h *= _M32
        h ^= h >> np.uint32(15)
    return h


def splitmix32(x: np.ndarray) -> np.ndarray:
    """Fast 32-bit finalizer-style mix."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
        x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
    return x
