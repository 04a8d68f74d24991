#!/usr/bin/env python
"""Print one oriented read as FASTA
(reference: scripts/WriteOrientedRead.py).

Usage: WriteOrientedRead.py <runDir> <readId> <strand>
"""
import sys

from _common import open_run
from shasta_tpu_torch.data import bases as B


def main(argv=None) -> int:
    a, args = open_run(argv)
    rid = int(args[1])
    strand = int(args[2]) if len(args) > 2 else 0
    seq = a.reads.read_raw(rid, strand)
    print(f">{a.reads.names[rid]}-{strand}")
    print(B.decode_to_str(seq))
    return 0


if __name__ == "__main__":
    sys.exit(main())
