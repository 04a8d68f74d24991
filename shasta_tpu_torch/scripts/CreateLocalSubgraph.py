#!/usr/bin/env python
"""Extract a distance-bounded local subgraph from a Graphviz dot file
(reference: scripts/CreateLocalSubgraph.py).

Usage: CreateLocalSubgraph.py <input.dot> <startVertex> <maxDistance>
"""
import re
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 3:
        print(__doc__)
        return 1
    path, start, max_distance = argv[0], argv[1], int(argv[2])

    edge_re = re.compile(r'^\s*"?([\w.]+)"?\s*->\s*"?([\w.]+)"?')
    adj = {}
    lines = []
    with open(path) as f:
        for line in f:
            m = edge_re.match(line)
            if m:
                u, v = m.group(1), m.group(2)
                adj.setdefault(u, set()).add(v)
                adj.setdefault(v, set()).add(u)
                lines.append((u, v, line))

    dist = {start: 0}
    frontier = [start]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj.get(u, ()):
                if v not in dist and dist[u] < max_distance:
                    dist[v] = dist[u] + 1
                    nxt.append(v)
        frontier = nxt

    out = path.rsplit(".", 1)[0] + f"-local-{start}-{max_distance}.dot"
    with open(out, "w") as f:
        f.write("digraph LocalSubgraph {\n")
        for u, v, line in lines:
            if u in dist and v in dist:
                f.write(line)
        f.write("}\n")
    print(f"{len(dist)} vertices within distance {max_distance}. Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
