"""LowHash's candidates held to the plain reference at a cell's size, on
each seed given: the program's candidates with a read in a block of
reads drawn from the seed, against ``reference_lowhash.candidates``
restricted to that block (every feature still hashed and bucketed),
``MinHash.alignmentCandidatesPerRead``'s cap left out on both sides.

    python3 perfbench/check_lowhash.py --workload hifi.assemble --seeds 1,2 --reads 64

Prints one JSON line a seed: the block's candidates on each side, and
how many differ (a candidate on one side only, or its frequency). The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import drivers, harness, reference_lowhash  # noqa: E402

FIELDS = ("read_id0", "read_id1", "same_strand", "frequency")


def reading(cfg: dict, traffic: dict, seed: int, n_reads: int, device) -> dict:
    from shasta_tpu_torch.pipeline.assemble import Assembler

    work = tempfile.mkdtemp(prefix="perfbench-lowhash-")
    try:
        inputs = drivers.Inputs(cfg, traffic, seed, work)
        conf = drivers.assembly_config(cfg)
        # LowHash's own output: alignmentCandidatesPerRead's cap keeps
        # the highest frequencies over all reads, which a block of reads
        # cannot see, so it is switched off here.
        conf.min_hash.alignment_candidates_per_read = 0
        a = Assembler(os.path.join(work, "run"), conf, device=device)
        a.add_reads([inputs.fasta])
        a.select_kmers()
        a.find_markers()
        a.flag_palindromic_reads()
        t0 = time.monotonic()
        a.find_alignment_candidates()
        t_program = time.monotonic() - t0
        c, pal = a.candidates, a.reads.is_palindromic.copy()
        n = int(inputs.kept.shape[0])
        del a
        block = np.sort(np.random.default_rng(inputs.s_sample).choice(n, n_reads, replace=False))
        touch = np.isin(c.read_id0, block) | np.isin(c.read_id1, block)
        got = {f: getattr(c, f)[touch] for f in FIELDS}
        t0 = time.monotonic()
        want = reference_lowhash.candidates(inputs.markers(range(n)), n, pal,
                                            reference_lowhash.LowHashParams.from_config(cfg),
                                            reads=block.tolist())
        t_ref = time.monotonic() - t0
        key = lambda d: set(zip(*(d[f].tolist() for f in FIELDS)))  # noqa: E731
        differ = len(key(got) ^ key(want))
        return {"seed": seed, "reads": n, "block": n_reads, "palindromic": int(pal.sum()),
                "program": int(got["read_id0"].shape[0]), "reference": int(want["read_id0"].shape[0]),
                "differ": differ, "program_s": round(t_program, 3), "reference_s": round(t_ref, 1)}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 perfbench/check_lowhash.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--reads", type=int, default=64)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = harness.load_spec()
    w = harness.cell(spec, args.workload)
    cfg, traffic = harness.config_of(spec, w), harness.traffic_of(w)
    bad = 0
    for s in args.seeds.split(","):
        r = reading(cfg, traffic, int(s), args.reads, args.device)
        bad += r["differ"]
        print(json.dumps(r), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
