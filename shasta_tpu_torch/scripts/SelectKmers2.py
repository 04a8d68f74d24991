#!/usr/bin/env python
"""Re-run per-read over-enrichment (method 2) marker k-mer selection
(reference: scripts/SelectKmers2.py).

Usage: SelectKmers2.py <runDir>
"""
import sys

from _common import open_run
from shasta_tpu_torch.data.kmers import select_kmers_2


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ck = a.config.kmers
    a.kmer_table = select_kmers_2(a.reads, ck.k, ck.probability, seed=ck.seed)
    a.store.save_stage("Kmers", a.kmer_table.arrays())
    print(f"Selected {a.kmer_table.marker_count} marker k-mers "
          "(method 2, per-read over-enrichment filter).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
