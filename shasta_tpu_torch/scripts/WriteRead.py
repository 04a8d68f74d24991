#!/usr/bin/env python
"""Print one read as FASTA (reference: scripts/WriteRead.py).

Usage: WriteRead.py <runDir> <readId>
"""
import sys

from _common import open_run
from shasta_tpu_torch.data import bases as B


def main(argv=None) -> int:
    a, args = open_run(argv)
    rid = int(args[1])
    seq = a.reads.read_raw(rid)
    print(f">{a.reads.names[rid]}")
    print(B.decode_to_str(seq))
    return 0


if __name__ == "__main__":
    sys.exit(main())
