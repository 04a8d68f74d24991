"""FASTA/FASTQ loading into flat arrays.

The reference loads reads with a multithreaded C++ parser
(reference: src/ReadLoader.cpp) that discards reads shorter than
minReadLength, reads with invalid bases, and reads containing a base
run longer than 255 (so repeat counts fit a uint8). This module
parses FASTA with the native library (native/shasta_native.cpp
fasta_measure, fasta_fill) and FASTQ in Python.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from shasta_tpu_torch.data import bases


@dataclass
class ParsedReads:
    """Raw parse result: all reads, before any filtering."""

    names: List[str]
    # Flat ASCII sequence bytes + CSR offsets.
    seq_ascii: np.ndarray
    offsets: np.ndarray
    # Per-read metadata (remainder of the header line).
    metadata: List[str] = field(default_factory=list)
    # Pre-encoded 2-bit codes (the FASTA parser's); when set,
    # seq_ascii may be empty.
    codes: np.ndarray = None

    @property
    def read_count(self) -> int:
        return len(self.names)


def _open_maybe_gzip(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _parse_fastq(data: bytes) -> ParsedReads:
    names: List[str] = []
    metadata: List[str] = []
    chunks: List[bytes] = []
    lengths: List[int] = []
    lines = data.splitlines()
    i = 0
    n = len(lines)
    while i + 3 < n or (i < n and lines[i].startswith(b"@")):
        header = lines[i]
        if not header.startswith(b"@"):
            raise ValueError(f"Malformed FASTQ near line {i}: expected '@'")
        seq = lines[i + 1].strip()
        plus = lines[i + 2]
        if not plus.startswith(b"+"):
            raise ValueError(f"Malformed FASTQ near line {i + 2}: expected '+'")
        h = header[1:].strip().decode(errors="replace")
        name, _, meta = h.partition(" ")
        names.append(name)
        metadata.append(meta)
        chunks.append(seq)
        lengths.append(len(seq))
        i += 4
        if i >= n:
            break
    flat = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    offsets = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return ParsedReads(names=names, seq_ascii=flat, offsets=offsets, metadata=metadata)


def parse_fasta_bytes(data: bytes) -> ParsedReads:
    """Parse FASTA bytes with the native parser (reference: the
    multithreaded C++ ReadLoader, src/ReadLoader.cpp). Lines before the
    first header are ignored; codes are 255 at invalid bases."""
    from shasta_tpu_torch import native

    if not data.startswith(b">"):
        data = data[data.find(b"\n>") + 1 :] if b"\n>" in data else b""
    codes, offsets, names, metadata = native.parse_fasta_native(data)
    return ParsedReads(
        names=names,
        seq_ascii=np.zeros(0, np.uint8),
        offsets=offsets,
        metadata=metadata,
        codes=codes,
    )


def merge_parsed(parts: List[ParsedReads]) -> ParsedReads:
    """Concatenate reads from several input files (reference: the
    addReads-per-file loop at srcMain/main.cpp:544). Parts may come
    from either parser: when every part carries pre-encoded 2-bit
    codes (native path) the merge stays in code space; a mix converts
    code parts to ASCII first."""
    names: List[str] = []
    metadata: List[str] = []
    for p in parts:
        names.extend(p.names)
        metadata.extend(p.metadata if p.metadata else [""] * p.read_count)
    offsets = np.zeros(len(names) + 1, dtype=np.int64)
    lengths = (
        np.concatenate([np.diff(p.offsets) for p in parts])
        if parts
        else np.zeros(0, np.int64)
    )
    np.cumsum(lengths, out=offsets[1:])

    all_codes = parts and all(p.codes is not None for p in parts)
    if all_codes:
        return ParsedReads(
            names=names,
            seq_ascii=np.zeros(0, np.uint8),
            offsets=offsets,
            metadata=metadata,
            codes=np.concatenate([p.codes for p in parts]),
        )

    # 256-entry LUT: the native parser emits code 255 for invalid
    # bases (native/shasta_native.cpp fasta_fill), so map 0-3 to ACGT
    # and everything else to 'N' — build_read_store's invalid-base
    # filtering then treats them as on the ASCII path.
    lut = np.full(256, ord("N"), dtype=np.uint8)
    lut[:4] = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [
        p.seq_ascii if p.codes is None else lut[p.codes] for p in parts
    ]
    return ParsedReads(
        names=names,
        seq_ascii=np.concatenate(seqs) if seqs else np.zeros(0, np.uint8),
        offsets=offsets,
        metadata=metadata,
    )


def parse_file(path: str) -> ParsedReads:
    data = _open_maybe_gzip(path)
    stem = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(stem)[1].lower()
    if not data.lstrip().startswith(b">"):
        if ext in (".fastq", ".fq"):
            return _parse_fastq(data)
        # Sniff '@' for fastq content with an odd extension.
        if data[:1] == b"@" and ext not in (".fasta", ".fa", ".fna"):
            return _parse_fastq(data)
    return parse_fasta_bytes(data)
