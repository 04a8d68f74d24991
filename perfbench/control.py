"""The check's controls, at a cell's own size, on each seed given. Each
has to come out as not correct; the benchmark's own runs never run them.

- Alignments (every cell): the reference put in the program's place
  with phase 2's band narrowed (``reference.align(band="control")``),
  judged as the program's answers are (``reference.sound``).
- Assemblies (``assemble`` cells): the program with a stage that the
  configuration states skipped (``ASSEMBLY_CONTROLS``), graded as the
  window's assemblies are (``drivers.assembly_checks``), beside the
  program as configured.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed and control: its numbers, and the sample's
size.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import List

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import drivers, harness, reference  # noqa: E402

# (options group, field, value) of the program's configuration.
ASSEMBLY_CONTROLS = {
    # Every marker graph edge's sequence copied from one read (its
    # shortest interval): no alignment of the reads' sequences and no
    # consensus caller on the edges.
    "edge_consensus_skipped": ("assembly", "marker_graph_edge_length_threshold_for_consensus", 0),
}


def control_reading(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The sampled candidates of one seed (set up as the cell's window
    would find them), aligned by the reference and by the control."""
    from shasta_tpu_torch.pipeline.assemble import Assembler

    work = tempfile.mkdtemp(prefix="perfbench-control-")
    try:
        inputs = drivers.Inputs(cfg, traffic, seed, work)
        a = Assembler(os.path.join(work, "run"), drivers.assembly_config(cfg), device=device)
        a.add_reads([inputs.fasta])
        a.select_kmers()
        a.find_markers()
        a.flag_palindromic_reads()
        a.find_alignment_candidates()
        c = a.candidates
        q = inputs.sample(c.read_id0, c.read_id1, traffic["check"]["random"],
                          traffic["check"]["longest"])
        cands = list(zip(c.read_id0[q].tolist(), c.read_id1[q].tolist(),
                         c.same_strand[q].tolist()))
        del a, c
        drivers.release_device(device)
        mk = inputs.markers({r for p in cands for r in p[:2]})
        classed, stated, ctl = (reference.align(mk, cands, inputs.params, device, band=b)
                                for b in ("class", "stated", "control"))
        bad = sum(not reference.sound(*abc) for abc in zip(classed, stated, ctl))
        # How often the program's class padding moves a sound answer.
        moved = sum(not reference.same(c, s) for c, s in zip(classed, stated))
        return {"seed": seed, "mismatched_alignments": bad, "sample": len(cands),
                "reference_aligned": sum(c is not None for c in classed),
                "stated_differs_from_class": moved}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def assembly_readings(cfg: dict, traffic: dict, seed: int, device) -> List[dict]:
    """One seed's reads assembled by the program as configured and under
    each of ``ASSEMBLY_CONTROLS``, each graded against the genome."""
    from shasta_tpu_torch.pipeline.assemble import run_assembly

    work = tempfile.mkdtemp(prefix="perfbench-control-")
    try:
        inputs = drivers.Inputs(cfg, traffic, seed, work)
        out = []
        for name in ("as_configured",) + tuple(ASSEMBLY_CONTROLS):
            conf = drivers.assembly_config(cfg)
            if name in ASSEMBLY_CONTROLS:
                group, key, value = ASSEMBLY_CONTROLS[name]
                setattr(getattr(conf, group), key, value)
            rd = os.path.join(work, name)
            run_assembly([inputs.fasta], rd, conf, device=device)
            with open(os.path.join(rd, "Assembly.fasta"), "rb") as f:
                data = f.read()
            shutil.rmtree(rd)
            checks = drivers.assembly_checks([data], inputs.genome, traffic["check"]["assembly"])
            out.append({"seed": seed, "run": name,
                        **{k: c["value"] for k, c in checks.items()}})
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 perfbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    spec = harness.load_spec()
    w = harness.cell(spec, args.workload)
    cfg, traffic = harness.config_of(spec, w), harness.traffic_of(w)
    for s in args.seeds.split(","):
        print(json.dumps(control_reading(cfg, traffic, int(s), "cuda")), flush=True)
        if traffic["driver"] == "assemble":
            for line in assembly_readings(cfg, traffic, int(s), "cuda"):
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
