"""Vectorized hash functions.

The reference hashes LowHash features with MurmurHash64A and k-mer ids
with 32-bit MurmurHash2 (reference: src/MurmurHash2.cpp, used at
src/LowHash0.cpp:349 and src/AssemblerKmers.cpp:185). Both are
public-domain algorithms (Austin Appleby); we provide exact vectorized
numpy reimplementations so candidate generation and marker
downsampling match the reference bit-for-bit, plus a fast 32-bit
mix-based hash for on-device (JAX) use where uint64 is unavailable.
"""

from __future__ import annotations

import numpy as np

_M64 = np.uint64(0xC6A4A7935BD1E995)
_R64 = np.uint64(47)


def murmur64_features(features: np.ndarray, seed: int) -> np.ndarray:
    """MurmurHash64A over rows of little-endian uint32 words.

    ``features``: (n, m) uint32 — each row is one key of m*4 bytes.
    Returns (n,) uint64 hashes, identical to MurmurHash64A(key, 4*m, seed).
    """
    features = np.ascontiguousarray(features, dtype=np.uint32)
    n, m = features.shape
    if n >= 1 << 15:
        # The native one-pass threaded implementation (bit-identical;
        # tests assert equality) — the numpy chain below makes ~12
        # full-array passes and dominates LowHash wall time.
        from shasta_tpu_torch import native

        out = native.murmur64_features_native(features, seed)
        if out is not None:
            return out
    length = np.uint64(4 * m)
    with np.errstate(over="ignore"):
        h = np.full(n, np.uint64(seed) ^ (length * _M64), dtype=np.uint64)

    # Full 8-byte chunks: pairs of uint32 words (little endian).
    with np.errstate(over="ignore"):
        for i in range(0, m - 1, 2):
            k = features[:, i].astype(np.uint64) | (
                features[:, i + 1].astype(np.uint64) << np.uint64(32)
            )
            k *= _M64
            k ^= k >> _R64
            k *= _M64
            h ^= k
            h *= _M64
        # 4-byte tail (m odd): bytes are xor'ed into h, then h *= m.
        if m % 2 == 1:
            tail = features[:, m - 1].astype(np.uint64)
            h ^= tail
            h *= _M64
        h ^= h >> _R64
        h *= _M64
        h ^= h >> _R64
    return h


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
