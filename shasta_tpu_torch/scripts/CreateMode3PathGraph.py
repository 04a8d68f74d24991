#!/usr/bin/env python
"""Build the mode-3 Jaccard graph and assembly paths from the stored
mode-3 graph (reference: scripts/CreateMode3PathGraph.py)."""
import os
import sys

from _common import open_run
from shasta_tpu_torch.graph import mode3_path as M3P
from shasta_tpu_torch.graph.mode3 import Mode3Graph


def main(argv=None) -> int:
    a, _ = open_run(argv)
    m3 = Mode3Graph.from_arrays(a.store.load_stage("Mode3"))
    conn = M3P.Mode3Connectivity(m3, a.marker_graph, a.markers)
    edges = M3P.create_jaccard_graph(conn)
    paths = M3P.find_jaccard_paths(m3.segment_count, edges)
    out = os.path.join(a.run_dir, "Mode3-JaccardGraph.csv")
    M3P.write_jaccard_edges_csv(out, edges)
    print(f"Jaccard graph: {len(edges)} edges, {len(paths)} paths. Wrote {out}")

    # Journey-snippet PathGraph with partition + one detangle iteration
    # (reference: mode3::PathGraph, src/mode3-PathGraph.cpp).
    from shasta_tpu_torch.graph.mode3_pathgraph import create_mode3_path_graph

    pg = create_mode3_path_graph(m3, out_dir=a.run_dir)
    print(
        f"PathGraph: {len(pg.vertices)} vertices, {len(pg.edges)} edges "
        f"after one detangle iteration (outputs in {a.run_dir})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
