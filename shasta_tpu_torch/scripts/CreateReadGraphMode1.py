#!/usr/bin/env python
"""Create the read graph in mode-1 style: phase the assembly graph
bubbles, drop alignments joining reads assigned to opposite bubble
branches, then apply the usual kNN selection
(reference: scripts/CreateReadGraphMode1.py ->
Assembler::createReadGraphMode1, which uses assembly-graph bubble
analysis to separate haplotypes before the kNN)."""
import sys

import numpy as np

from _common import open_run
from shasta_tpu_torch.graph import read_graph as RG
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph
from shasta_tpu_torch.graph.mode2 import find_bubbles, phase_bubbles


def main(argv=None) -> int:
    a, _ = open_run(argv)
    al = a.alignments
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    bubbles = find_bubbles(ag, a.marker_graph)
    phase_bubbles(bubbles)

    # Haplotype assignment per oriented read from the phased bubbles.
    hap = {}
    for b in bubbles:
        if b.component < 0:
            continue
        side0, side1 = (b.reads0, b.reads1) if b.phase >= 0 else (b.reads1, b.reads0)
        for orid in side0.tolist():
            hap.setdefault((b.component, orid), 0)
        for orid in side1.tolist():
            hap.setdefault((b.component, orid), 1)

    # Drop alignments whose reads have opposite haplotypes in a component.
    by_comp = {}
    for (comp, orid), h in hap.items():
        by_comp.setdefault(comp, {})[orid] = h
    n = al.count
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        orid0 = 2 * int(al.read_id0[i])
        orid1 = 2 * int(al.read_id1[i]) + (0 if al.same_strand[i] else 1)
        for assign in by_comp.values():
            h0, h1 = assign.get(orid0), assign.get(orid1)
            if h0 is not None and h1 is not None and h0 != h1:
                keep[i] = False
                break

    from shasta_tpu_torch.pipeline.iterative import _subset_alignments

    sub = np.flatnonzero(keep)
    knn = RG.select_alignments_knn(
        _subset_alignments(al, sub),
        a.reads.read_count,
        a.config.read_graph.max_alignment_count,
    )
    final = np.zeros(n, dtype=bool)
    final[sub[knn]] = True
    a.read_graph = RG.build_read_graph(al, a.reads.read_count, final)
    a.store.save_stage("ReadGraph", a.read_graph.arrays())
    print(f"Mode-1 read graph: dropped {int((~keep).sum())} cross-haplotype "
          f"alignments; {a.read_graph.edge_count} edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
