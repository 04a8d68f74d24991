"""Synthetic genome / read-set generation for tests and the chip smoke run.

A copy of the JAX package's test generators (same seeds, same defaults,
same random streams), kept inside the port so that ``chip_smoke.py``
needs nothing outside ``shasta_tpu_torch``.

Gives ground truth to validate the assembler end-to-end: sample a
random genome, draw overlapping reads (optionally with errors and from
both strands), and check that the assembled contigs reconstruct the
genome.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from shasta_tpu_torch.data import bases as B

ALPHA = "ACGT"


def random_genome(length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=length, endpoint=False).astype(np.uint8)


def sample_reads(
    genome: np.ndarray,
    n_reads: int,
    read_length: int,
    seed: int = 1,
    error_rate: float = 0.0,
    both_strands: bool = True,
    circular: bool = False,
    vectorized: bool = False,
) -> List[np.ndarray]:
    """Sample reads uniformly from the genome (code arrays).

    ``vectorized`` switches the error applier to the O(n) numpy passes
    (different RNG realization than the loop version — existing tests
    and goldens pin the loop's stream, benches use the fast one)."""
    rng = np.random.default_rng(seed)
    g_len = genome.shape[0]
    reads = []
    max_start = g_len if circular else g_len - read_length
    starts = rng.integers(0, max(1, max_start), size=n_reads)
    for s in starts:
        if circular:
            idx = (np.arange(read_length) + s) % g_len
            r = genome[idx]
        else:
            r = genome[s : s + read_length].copy()
        if error_rate > 0:
            r = (
                apply_errors_vec(r, rng, error_rate)
                if vectorized
                else apply_errors(r, rng, error_rate)
            )
        if both_strands and rng.random() < 0.5:
            r = B.reverse_complement(r)
        reads.append(r)
    return reads


def apply_errors(read: np.ndarray, rng, rate: float) -> np.ndarray:
    """Apply substitution/insertion/deletion errors (1/3 each)."""
    out = []
    i = 0
    n = read.shape[0]
    err = rng.random(2 * n)
    kinds = rng.integers(0, 3, size=2 * n)
    subs = rng.integers(1, 4, size=2 * n)
    j = 0
    while i < n:
        if err[j] < rate:
            kind = kinds[j]
            if kind == 0:  # substitution
                out.append((read[i] + subs[j]) % 4)
                i += 1
            elif kind == 1:  # insertion
                out.append(subs[j] % 4)
            else:  # deletion
                i += 1
        else:
            out.append(read[i])
            i += 1
        j += 1
    return np.array(out, dtype=np.uint8)


def apply_errors_vec(
    read: np.ndarray,
    rng,
    rate: float,
    mix: Tuple[float, float, float] = (1 / 3, 1 / 3, 1 / 3),
    homopolymer_bias: float = 0.0,
) -> np.ndarray:
    """Vectorized substitution/insertion/deletion errors with a
    configurable mix (sub, ins, del). O(n) numpy passes — the loop
    version (:func:`apply_errors`) costs minutes per Gb and is kept
    only because existing tests pin its RNG stream.

    ``homopolymer_bias``: probability that an inserted base copies its
    left neighbor (a homopolymer-length error — real ONT's dominant
    error mode, which the RLE representation absorbs; 0 = uniform
    random insertions, harsher than real data after RLE)."""
    n = read.shape[0]
    p_sub = rate * mix[0]
    p_del = rate * mix[2]
    u = rng.random(n)
    is_del = u < p_del
    is_sub = (u >= p_del) & (u < p_del + p_sub)
    is_ins = rng.random(n) < rate * mix[1]
    base = read.copy()
    ns = int(is_sub.sum())
    base[is_sub] = (base[is_sub] + rng.integers(1, 4, ns)) % 4
    counts = (~is_del).astype(np.int64) + is_ins
    ends = np.cumsum(counts)
    out = np.empty(int(ends[-1]) if n else 0, np.uint8)
    # Each position contributes (optional inserted base, then the kept
    # base): the inserted base lands at ends-counts, the kept base at
    # ends-1 — disjoint slots by construction.
    out[ends[~is_del] - 1] = base[~is_del]
    ins_pos = (ends - counts)[is_ins]
    ins_val = rng.integers(0, 4, ins_pos.shape[0]).astype(np.uint8)
    if homopolymer_bias > 0.0 and ins_pos.shape[0]:
        copy_left = rng.random(ins_pos.shape[0]) < homopolymer_bias
        left = base[np.maximum(np.flatnonzero(is_ins) - 1, 0)]
        ins_val = np.where(copy_left, left, ins_val)
    out[ins_pos] = ins_val
    return out


def sample_reads_ont(
    genome: np.ndarray,
    coverage: float,
    *,
    seed: int = 1,
    error_rate: float = 0.05,
    mix: Tuple[float, float, float] = (0.2, 0.5, 0.3),
    median_length: int = 25000,
    sigma: float = 0.55,
    min_length: int = 3000,
    both_strands: bool = True,
    homopolymer_bias: float = 0.9,
) -> List[np.ndarray]:
    """Reads that look like real Oxford Nanopore data: log-normal
    lengths (median ``median_length``, 5th-95th percentile roughly
    0.4-2.5x at sigma 0.55), indel-dominated errors concentrated in
    homopolymer runs, both strands.

    Calibration (measured by 14-mer survival on the RLE sequence —
    exactly what the marker pipeline sees): the defaults (raw 5%
    error, 20/50/30 sub/ins/del, 90% of insertions homopolymer-length)
    leave ~2.2% post-RLE error — the Guppy5-super-class regime
    conf/Nanopore-May2022.conf targets; real ONT concentrates errors
    in homopolymers, which run-length encoding absorbs by design
    (reference: docs/ComputationalMethods.html "Marker alignments").
    Harsher presets: (0.06, (0.25, 0.45, 0.30), hb=0.85) ~3.0% RLE;
    uniform indels (hb=0) at 7% leave ~5.8% RLE error, beyond any
    LowHash parameterization the reference ships."""
    rng = np.random.default_rng(seed)
    g_len = genome.shape[0]
    target = coverage * g_len
    reads: List[np.ndarray] = []
    drawn = 0.0
    while drawn < target:
        want = max(int((target - drawn) / median_length) + 1, 1)
        want = min(want, 4096)
        lens = np.exp(
            rng.normal(np.log(median_length), sigma, size=want)
        ).astype(np.int64)
        lens = np.clip(lens, min_length, max(g_len - 1, min_length))
        starts = rng.integers(0, np.maximum(g_len - lens, 1))
        for s, L in zip(starts, lens):
            r = genome[int(s) : int(s) + int(L)]
            if error_rate > 0:
                r = apply_errors_vec(
                    r, rng, error_rate, mix,
                    homopolymer_bias=homopolymer_bias,
                )
            if both_strands and rng.random() < 0.5:
                r = B.reverse_complement(r)
            reads.append(r)
            drawn += L
            if drawn >= target:
                break
    return reads


def write_fasta(path: str, reads: List[np.ndarray], prefix: str = "read") -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">{prefix}-{i}\n")
            f.write(B.decode_to_str(r))
            f.write("\n")
