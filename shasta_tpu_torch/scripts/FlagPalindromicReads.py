#!/usr/bin/env python
"""Flag palindromic reads (reference: scripts/FlagPalindromicReads.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.ops.palindrome import flag_palindromic_reads


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.reads.is_palindromic = flag_palindromic_reads(a.markers, device=a.device)
    a.store.save_stage("Reads", a.reads.arrays())
    print(f"Flagged {int(a.reads.is_palindromic.sum())} palindromic reads.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
