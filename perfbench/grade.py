"""Grading of an assembly against the genome the benchmark generated: a
frozen copy of the k-mer arithmetic of
``shasta_tpu_torch/utils/accuracy.py`` (``kmer_codes``,
``canonical_kmer_codes``, ``_found_mask``, the QV and completeness of
``assembly_metrics``, and ``parse_fasta_contigs`` as ``contigs_of``, on
the file's bytes).

Merqury's estimator: every contig k-mer absent from the genome implies
at least one base error within k bases, so the per-base error is
p = 1 - (found / total)^(1/k) and QV = -10 log10(p); completeness is the
share of the genome's distinct canonical k-mers that the assembly holds.
"""

from __future__ import annotations

from typing import List

import numpy as np


def kmer_codes(seq: np.ndarray, k: int) -> np.ndarray:
    n = seq.shape[0] - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    v = np.zeros(n, np.uint64)
    s = seq.astype(np.uint64)
    for j in range(k):
        v = (v << np.uint64(2)) | s[j: n + j]
    return v


def canonical_kmer_codes(seq: np.ndarray, k: int) -> np.ndarray:
    fwd = kmer_codes(seq, k)
    rev = kmer_codes((3 - seq[::-1]).astype(np.uint8), k)[::-1]
    return np.minimum(fwd, rev)


def _found_mask(codes: np.ndarray, truth_sorted: np.ndarray) -> np.ndarray:
    if truth_sorted.shape[0] == 0:
        return np.zeros(codes.shape[0], bool)
    idx = np.minimum(np.searchsorted(truth_sorted, codes), truth_sorted.shape[0] - 1)
    return truth_sorted[idx] == codes


def contigs_of(fasta: bytes) -> List[np.ndarray]:
    """The base codes of each record of a FASTA text."""
    lut = np.full(256, 255, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
        lut[ch + 32] = i
    contigs: List[np.ndarray] = []
    cur: List[bytes] = []
    for line in fasta.splitlines():
        if line.startswith(b">"):
            if cur:
                contigs.append(lut[np.frombuffer(b"".join(cur), np.uint8)])
            cur = []
        else:
            cur.append(line.strip())
    if cur:
        contigs.append(lut[np.frombuffer(b"".join(cur), np.uint8)])
    return contigs


def qv_completeness(contigs, genome: np.ndarray, k: int = 21, qv_cap: float = 90.0) -> dict:
    """{qv, base_error, completeness, contig_kmers, missing_kmers} of
    ``contigs`` against ``genome``; ``base_error`` is the estimate p
    (1 where the contigs hold no k-mer)."""
    truth_sorted = np.unique(canonical_kmer_codes(genome, k))
    total = missing = 0
    found_truth = np.zeros(truth_sorted.shape[0], bool)
    for c in contigs:
        codes = canonical_kmer_codes(np.asarray(c, np.uint8), k)
        ok = _found_mask(codes, truth_sorted)
        total += codes.shape[0]
        missing += int((~ok).sum())
        if codes.shape[0]:
            found_truth[np.searchsorted(truth_sorted, codes[ok])] = True
    p = 1.0 - (1.0 - missing / total) ** (1.0 / k) if total else 1.0
    if total == 0:
        qv = 0.0
    elif missing == 0:
        qv = qv_cap
    else:
        qv = min(-10.0 * np.log10(max(p, 1e-12)), qv_cap)
    completeness = float(found_truth.sum()) / truth_sorted.shape[0] if truth_sorted.shape[0] else 0.0
    return {"qv": float(qv), "base_error": float(p), "completeness": completeness,
            "contig_kmers": int(total), "missing_kmers": int(missing)}
