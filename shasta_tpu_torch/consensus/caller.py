"""Per-column consensus callers over (base, strand, repeat count) coverage.

Counterpart of the reference ConsensusCaller hierarchy
(reference: src/ConsensusCaller.hpp:50-58, src/SimpleConsensusCaller.cpp,
src/MedianConsensusCaller.cpp, src/Coverage.cpp). A coverage column is
represented as parallel arrays instead of a CoverageData vector, so a
whole batch of columns can be called at once.

Symbols: 0..3 = ACGT, 4 = gap ('-'). A gap entry must carry repeat
count 0 (reference: Coverage.cpp:9-17).

Tie-breaking matches the reference exactly:
- mostFrequentBase: scan base values ascending, strictly-greater wins
  (reference: Coverage.cpp:72-90) — ties go to the smaller base value.
- mostFrequentRepeatCount: scan repeat counts ascending, strictly-
  greater wins — ties go to the smaller count.
"""

from __future__ import annotations

import numpy as np

GAP = 4


def most_frequent_base(bases: np.ndarray) -> int:
    """Coverage::mostFrequentBase over one column."""
    counts = np.bincount(bases, minlength=5)[:5]
    return int(np.argmax(counts))  # argmax takes first max = smallest value


def most_frequent_repeat_count(
    bases: np.ndarray, repeats: np.ndarray, base: int
) -> int:
    """Coverage::mostFrequentRepeatCount(base)."""
    sel = repeats[bases == base]
    if sel.shape[0] == 0:
        return 0
    counts = np.bincount(sel)
    return int(np.argmax(counts))


class ModalConsensusCaller:
    """reference: src/SimpleConsensusCaller.cpp — most frequent base,
    then most frequent repeat count for that base."""

    name = "Modal"

    def __call__(self, bases: np.ndarray, repeats: np.ndarray):
        b = most_frequent_base(bases)
        if b == GAP:
            return GAP, 0
        return b, most_frequent_repeat_count(bases, repeats, b)

    def repeat_count(self, repeats: np.ndarray) -> int:
        """Consensus repeat count when the base is fixed (vertex
        assembly: all markers share the k-mer base)."""
        if repeats.shape[0] == 0:
            return 0
        return int(np.argmax(np.bincount(repeats)))

    def repeat_counts_batch(self, repeats: np.ndarray, max_repeat: int = 256):
        """Vectorized consensus over rows of a (n, coverage) repeat
        matrix (entries < 0 are missing)."""
        n = repeats.shape[0]
        out = np.zeros(n, dtype=np.int32)
        r = np.where(repeats < 0, 0, repeats)
        w = np.where(repeats < 0, 0, 1)
        hist = np.zeros((n, max_repeat), dtype=np.int32)
        rows = np.repeat(np.arange(n), repeats.shape[1])
        np.add.at(hist, (rows, r.ravel().clip(0, max_repeat - 1)), w.ravel())
        out = np.argmax(hist, axis=1).astype(np.int32)
        return out


class MedianConsensusCaller:
    """reference: src/MedianConsensusCaller.cpp — most frequent base,
    median repeat count (rounded up at half) among reads with that base."""

    name = "Median"

    def __call__(self, bases: np.ndarray, repeats: np.ndarray):
        b = most_frequent_base(bases)
        if b == GAP:
            return GAP, 0
        sel = np.sort(repeats[bases == b])
        n = sel.shape[0]
        if n == 0:
            return b, 0
        # Upper median, like the reference's choice of element n/2.
        return b, int(sel[n // 2])

    def repeat_count(self, repeats: np.ndarray) -> int:
        if repeats.shape[0] == 0:
            return 0
        s = np.sort(repeats)
        return int(s[s.shape[0] // 2])


def get_consensus_caller(spec: str):
    """Select a caller from a spec string, like the reference's
    ``Modal|Median|Bayesian:name`` (reference: src/Assembler.hpp:2388)."""
    if spec == "Modal":
        return ModalConsensusCaller()
    if spec == "Median":
        return MedianConsensusCaller()
    if spec.startswith("Bayesian:"):
        from shasta_tpu_torch.consensus.bayesian import BayesianConsensusCaller

        return BayesianConsensusCaller(spec.split(":", 1)[1])
    raise ValueError(f"Unknown consensus caller {spec!r}")
