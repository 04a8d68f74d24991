"""The benchmark's read generator: a frozen copy, so that a change to the
program cannot change the traffic it is measured on.

``random_genome`` and ``apply_errors_vec`` are copies of
``shasta_tpu_torch/utils/synth.py`` (the same random streams). The reads
follow ``synth.sample_reads_ont``'s model (log-normal lengths, that
error model at its defaults, both strands; there calibrated to about
2.2 % error after run-length encoding, the Guppy-5 super-accuracy class
that Shasta's ``Nanopore-May2022`` targets), with one change: the read
lengths are drawn once from a configuration's ``length_seed``
(``read_lengths``), so that every ``--seed`` gives the same amount of
work; the seed moves the genome, the reads' starts, strands and errors,
and their order (``sample_reads_fixed``).

Base codes: A=0, C=1, G=2, T=3 (complement = 3 - code).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def random_genome(length: int, seed: int = 0) -> np.ndarray:
    """Copy of ``synth.random_genome``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=length, endpoint=False).astype(np.uint8)


def apply_errors_vec(
    read: np.ndarray,
    rng,
    rate: float,
    mix: Tuple[float, float, float] = (1 / 3, 1 / 3, 1 / 3),
    homopolymer_bias: float = 0.0,
) -> np.ndarray:
    """Copy of ``synth.apply_errors_vec``: substitutions, insertions and
    deletions at ``rate`` in the proportions ``mix``; an inserted base
    copies its left neighbour with probability ``homopolymer_bias``."""
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
    out[ends[~is_del] - 1] = base[~is_del]
    ins_pos = (ends - counts)[is_ins]
    ins_val = rng.integers(0, 4, ins_pos.shape[0]).astype(np.uint8)
    if homopolymer_bias > 0.0 and ins_pos.shape[0]:
        copy_left = rng.random(ins_pos.shape[0]) < homopolymer_bias
        left = base[np.maximum(np.flatnonzero(is_ins) - 1, 0)]
        ins_val = np.where(copy_left, left, ins_val)
    out[ins_pos] = ins_val
    return out


def read_lengths(g_len: int, coverage: float, median_length: int, sigma: float,
                 min_length: int, seed: int) -> np.ndarray:
    """Log-normal read lengths (``synth.sample_reads_ont``'s law, clipped to
    [min_length, g_len - 1]) drawn until they cover ``coverage`` x g_len."""
    rng = np.random.default_rng(seed)
    target = coverage * g_len
    out: List[int] = []
    drawn = 0
    while drawn < target:
        L = int(np.exp(rng.normal(np.log(median_length), sigma)))
        L = min(max(L, min_length), max(g_len - 1, min_length))
        out.append(L)
        drawn += L
    return np.asarray(out, np.int64)


def sample_reads_fixed(
    genome: np.ndarray,
    lengths: Sequence[int],
    *,
    seed: int,
    error_rate: float,
    mix: Tuple[float, float, float],
    homopolymer_bias: float,
) -> List[np.ndarray]:
    """One read of each length in ``lengths``, in an order drawn from
    ``seed``, at a uniform start, with ``apply_errors_vec``'s errors, on
    a strand drawn with probability 1/2."""
    rng = np.random.default_rng(seed)
    g_len = genome.shape[0]
    lens = np.asarray(lengths, np.int64)[rng.permutation(len(lengths))]
    starts = rng.integers(0, np.maximum(g_len - lens, 1))
    rev = rng.random(lens.shape[0]) < 0.5
    reads = []
    for s, L, rv in zip(starts, lens, rev):
        r = apply_errors_vec(genome[int(s): int(s) + int(L)], rng, error_rate, mix,
                             homopolymer_bias=homopolymer_bias)
        reads.append(reverse_complement(r) if rv else r)
    return reads


def write_fasta(path: str, reads: Sequence[np.ndarray], prefix: str = "read") -> None:
    """Write ``reads`` as FASTA, one line a read."""
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">%s-%d\n" % (prefix.encode(), i) + _ACGT[r].tobytes() + b"\n")
