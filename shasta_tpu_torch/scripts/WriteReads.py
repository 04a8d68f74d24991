#!/usr/bin/env python
"""Write all stored reads as FASTA (reference: scripts/WriteReads.py).

Usage: WriteReads.py <runDir> [output.fasta]
"""
import os
import sys

from _common import open_run
from shasta_tpu_torch.data import bases as B


def main(argv=None) -> int:
    a, args = open_run(argv)
    out = args[1] if len(args) > 1 else os.path.join(a.run_dir, "Reads.fasta")
    with open(out, "w") as f:
        for rid in range(a.reads.read_count):
            f.write(f">{a.reads.names[rid]}\n")
            f.write(B.decode_to_str(a.reads.read_raw(rid)) + "\n")
    print(f"Wrote {a.reads.read_count} reads to {out}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
