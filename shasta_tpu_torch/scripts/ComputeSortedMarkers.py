#!/usr/bin/env python
"""Compute and store, for each oriented read, its markers sorted by
k-mer id (reference: scripts/ComputeSortedMarkers.py ->
Assembler::computeSortedMarkers, src/Assembler.hpp:616-621)."""
import sys

import numpy as np

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    m = a.markers
    n_or = m.oriented_read_count
    # Single global sort keyed by (oriented read, kmer id) preserves the
    # CSR layout while ordering within each read by k-mer.
    orid_of = np.repeat(np.arange(n_or, dtype=np.int64), np.diff(m.offsets))
    order = np.lexsort((m.kmer_ids, orid_of))
    a.store.save_stage(
        "SortedMarkers",
        {
            "kmer_ids": m.kmer_ids[order],
            "positions": m.positions[order],
            "offsets": m.offsets,
        },
    )
    print(f"Sorted markers stored for {n_or} oriented reads.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
