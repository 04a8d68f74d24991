"""Interactive HTTP explorer over a persisted run directory.

Counterpart of ``shasta_tpu/http/explore.py`` for the port, copied line
for line with its imports repointed; the pages are the JAX explorer's,
byte for byte, on the same run directory (a run directory written by
either package). The on-demand alignment pages run the port's alignment
engine on the explorer's ``device`` (the card unless the caller asks for
the CPU).

Counterpart of the reference's explore command (reference:
srcMain/main.cpp:1288-1370, src/HttpServer.cpp:40, endpoint table at
src/AssemblerHttpServer.cpp:209-250). Reattaches to the stage store
(the reference reattaches to its mmapped Data/ via accessAllSoft,
src/Assembler.hpp:2341) and serves exploration pages:

- /                     assembly summary
- /read?readId=&strand= read sequence, markers
- /alignments?readId=   alignment table entries for a read
- /readGraph?readId=    read graph neighborhood
- /markerGraph?vertexId= local marker graph info
- /assemblySummary.json the summary JSON
"""

from __future__ import annotations

import html
import inspect
import json
import os
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_STYLE = """
<style>
body { font-family: sans-serif; margin: 2em; }
table { border-collapse: collapse; }
td, th { border: 1px solid #999; padding: 2px 8px; }
h1 { color: #205080; }
code { background: #eee; }
</style>
"""


class Explorer:
    def __init__(self, run_dir: str, paf_file: str | None = None, device="cuda"):
        from shasta_tpu_torch.data.store import RunStore
        from shasta_tpu_torch.ops.align_kernel import resolve_device
        from shasta_tpu_torch.data.reads import ReadStore
        from shasta_tpu_torch.data.markers import MarkerStore
        from shasta_tpu_torch.graph.read_graph import ReadGraph
        from shasta_tpu_torch.graph.marker_graph import MarkerGraph
        from shasta_tpu_torch.ops.align import AlignmentStore

        self.run_dir = run_dir
        # Where the on-demand alignments run: "cuda" (the kernels) or "cpu".
        self.device = resolve_device(device)
        self.store = RunStore(run_dir, create=False)
        # Tolerant stage access, like accessAllSoft.
        self.reads = self._soft(lambda: ReadStore.from_arrays(self.store.load_stage("Reads")))
        self.markers = self._soft(lambda: MarkerStore.from_arrays(self.store.load_stage("Markers")))
        self.alignments = self._soft(lambda: AlignmentStore.from_arrays(self.store.load_stage("Alignments")))
        self.read_graph = self._soft(lambda: ReadGraph.from_arrays(self.store.load_stage("ReadGraph")))
        self.marker_graph = self._soft(lambda: MarkerGraph.from_arrays(self.store.load_stage("MarkerGraph")))
        from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph

        self.assembly_graph = self._soft(
            lambda: AssemblyGraph.from_arrays(self.store.load_stage("AssemblyGraph"))
        )

        # Optional reference-alignment overlay (reference:
        # --alignmentsPafFile, AssemblerHttpServer-Alignments.cpp:567).
        self.reference_overlaps = None
        if paf_file:
            from shasta_tpu_torch.io.paf import load_paf

            names = self.reads.names if self.reads is not None else None
            self.reference_overlaps = load_paf(paf_file, names)
            if self.reference_overlaps.skipped_reads:
                print(
                    f"WARNING: skipped {self.reference_overlaps.skipped_reads} "
                    "PAF lines naming reads not used in the assembly"
                )

    @staticmethod
    def _soft(fn):
        try:
            return fn()
        except Exception:
            return None

    # ----- pages -----

    def page_index(self, q) -> str:
        parts = [f"<h1>shasta_tpu assembly: {html.escape(self.run_dir)}</h1>"]
        summary_path = os.path.join(self.run_dir, "AssemblySummary.json")
        if os.path.exists(summary_path):
            with open(summary_path) as f:
                summary = json.load(f)
            parts.append("<table>")
            for k, v in summary.items():
                if isinstance(v, dict):
                    continue
                parts.append(f"<tr><th>{html.escape(str(k))}</th><td>{html.escape(str(v))}</td></tr>")
            parts.append("</table>")
        groups = {
            "Reads": [
                "/read?readId=0&strand=0", "/blastRead?readId=0&strand=0",
            ],
            "Alignments": [
                "/alignments?readId=0", "/alignment?readId0=0&readId1=1",
                "/exploreAlignmentCoverage?readId=0&strand=0",
                "/computeAllAlignments?readId=0",
                "/exploreAlignmentCandidateGraph?readId=0",
                "/exploreAlignmentGraph?readId=0",
                "/alignSequencesInBaseRepresentation",
                "/assessAlignments", "/alignmentMatrix?readId0=0&readId1=1",
            ],
            "Read graph": [
                "/readGraph?readId=0", "/localReadGraph?readId=0&strand=0",
            ],
            "Marker graph": [
                "/markerGraph?vertexId=0", "/localMarkerGraph?vertexId=0",
                "/markerGraphEdge?edgeId=0",
                "/exploreMarkerCoverage?readId=0&strand=0",
                "/inducedAlignment?readId0=0&readId1=1",
                "/followReadInMarkerGraph?readId=0&strand=0",
                "/exploreMarkerConnectivity?readId=0&strand=0&ordinal=0",
            ],
            "Assembly graph": [
                "/assemblyGraph?segment=0", "/assemblyGraphEdge?edgeId=0",
                "/exploreAssemblyGraphEdgesSupport?edgeId=0",
                "/compressedAssemblyGraph?edgeId=0",
            ],
            "Mode 3": [
                "/mode3?segmentId=0", "/mode3Segment?segmentId=0",
                "/mode3SegmentPair?segmentId0=0&segmentId1=1",
                "/mode3Link?linkId=0",
                "/mode3MetaAlignment?readId0=0&readId1=1",
                "/mode3AssemblyPath?segmentId=0",
                "/mode3LinkAssembly?linkId=0",
            ],
            "Data": ["/assemblySummary.json"],
        }
        for title, links in groups.items():
            items = ", ".join(
                f'<a href="{u}">{u.split("?")[0]}</a>' for u in links
            )
            parts.append(f"<p><b>{title}:</b> {items}</p>")
        return "".join(parts)

    def page_read(self, q) -> str:
        if self.reads is None:
            return "<p>Reads not available.</p>"
        # The reference's exploreRead accepts a read NAME as well as a
        # numeric id (readIdsSortedByName lookup, reference
        # src/Reads.cpp getReadId). Non-numeric readId = name lookup.
        rid_str = q.get("readId", ["0"])[0]
        try:
            rid = int(rid_str)
        except ValueError:
            matches = [i for i, n in enumerate(self.reads.names)
                       if n == rid_str or n.split()[0] == rid_str]
            if not matches:
                return f"<p>No read named <code>{html.escape(rid_str)}</code>.</p>"
            rid = matches[0]
        strand = int(q.get("strand", ["0"])[0])
        if not (0 <= rid < self.reads.read_count):
            return f"<p>Invalid read id {rid}.</p>"
        from shasta_tpu_torch.data import bases as B

        rle = self.reads.read_rle(rid, strand)
        counts = self.reads.read_repeat_counts(rid, strand)
        raw = self.reads.read_raw(rid, strand)
        out = [f"<h1>Read {rid}-{strand}</h1>"]
        name = self.reads.names[rid] if rid < len(self.reads.names) else ""
        out.append(f"<p>Name: <code>{html.escape(name)}</code></p>")
        out.append(
            f"<p>Raw length {raw.shape[0]}, RLE length {rle.shape[0]}, "
            f"palindromic={bool(self.reads.is_palindromic[rid])}, "
            f"chimeric={bool(self.reads.is_chimeric[rid])}</p>"
        )
        if self.markers is not None:
            kk, pp = self.markers.get(2 * rid + strand)
            out.append(f"<p>{kk.shape[0]} markers.</p>")
        seq = B.decode_to_str(raw[:5000])
        out.append(f"<p>Raw sequence (first 5000):</p><pre>{seq}</pre>")
        return "".join(out)

    def page_alignments(self, q) -> str:
        if self.alignments is None:
            return "<p>Alignments not available.</p>"
        rid = int(q.get("readId", ["0"])[0])
        al = self.alignments
        sel = np.flatnonzero((al.read_id0 == rid) | (al.read_id1 == rid))
        out = [f"<h1>Alignments of read {rid}</h1>", "<table>",
               "<tr><th>id</th><th>read0</th><th>read1</th><th>sameStrand</th>"
               "<th>markers</th><th>range0</th><th>range1</th></tr>"]
        for i in sel:
            out.append(
                f"<tr><td>{i}</td><td>{al.read_id0[i]}</td><td>{al.read_id1[i]}</td>"
                f"<td>{bool(al.same_strand[i])}</td><td>{al.marker_count[i]}</td>"
                f"<td>{al.first0[i]}-{al.last0[i]}</td>"
                f"<td>{al.first1[i]}-{al.last1[i]}</td></tr>"
            )
        out.append("</table>")
        return "".join(out)

    def page_read_graph(self, q) -> str:
        if self.read_graph is None:
            return "<p>Read graph not available.</p>"
        rid = int(q.get("readId", ["0"])[0])
        strand = int(q.get("strand", ["0"])[0])
        orid = 2 * rid + strand
        if not (0 <= orid < self.read_graph.n_oriented_reads):
            return f"<p>Invalid oriented read {rid}-{strand}.</p>"
        eids, others = self.read_graph.neighbors(orid)
        out = [f"<h1>Read graph neighborhood of {rid}-{strand}</h1>", "<table>",
               "<tr><th>edge</th><th>neighbor</th><th>alignmentId</th></tr>"]
        for e, o in zip(eids, others):
            out.append(
                f"<tr><td>{e}</td><td>{o >> 1}-{o & 1}</td>"
                f"<td>{self.read_graph.alignment_id[e]}</td></tr>"
            )
        out.append("</table>")
        return "".join(out)

    def page_marker_graph(self, q) -> str:
        if self.marker_graph is None:
            return "<p>Marker graph not available.</p>"
        vid = int(q.get("vertexId", ["0"])[0])
        mg = self.marker_graph
        if not (0 <= vid < mg.vertex_count):
            return f"<p>Invalid vertex id {vid}.</p>"
        markers = mg.vertex_marker_ids(vid)
        out = [f"<h1>Marker graph vertex {vid}</h1>"]
        out.append(
            f"<p>Coverage {markers.shape[0]}, reverse complement vertex "
            f"{mg.rc_vertex[vid]}</p>"
        )
        if mg.source is not None:
            outgoing = np.flatnonzero(mg.source == vid)
            incoming = np.flatnonzero(mg.target == vid)
            out.append("<h2>Edges</h2><table><tr><th>edge</th><th>dir</th>"
                       "<th>other</th><th>coverage</th><th>alive</th></tr>")
            alive = mg.alive()
            for e in outgoing:
                out.append(f"<tr><td>{e}</td><td>out</td><td>{mg.target[e]}</td>"
                           f"<td>{mg.coverage[e]}</td><td>{bool(alive[e])}</td></tr>")
            for e in incoming:
                out.append(f"<tr><td>{e}</td><td>in</td><td>{mg.source[e]}</td>"
                           f"<td>{mg.coverage[e]}</td><td>{bool(alive[e])}</td></tr>")
            out.append("</table>")
        return "".join(out)


    def page_assembly_graph(self, q) -> str:
        """Local assembly graph around a start segment (reference:
        exploreAssemblyGraph, src/AssemblerHttpServer-AssemblyGraph.cpp)."""
        ag = self.assembly_graph
        if ag is None:
            return "<p>Assembly graph not available.</p>"
        start = int(q.get("segment", ["0"])[0])
        max_distance = int(q.get("maxDistance", ["3"])[0])
        if not (0 <= start < ag.edge_count):
            return f"<p>Segment id out of range (0..{ag.edge_count - 1}).</p>"

        # BFS over segments connected head-to-tail.
        import numpy as np

        by_src = {}
        by_tgt = {}
        for e in range(ag.edge_count):
            by_src.setdefault(int(ag.source_v[e]), []).append(e)
            by_tgt.setdefault(int(ag.target_v[e]), []).append(e)

        def neighbors(e):
            out = []
            out.extend(by_src.get(int(ag.target_v[e]), []))
            out.extend(by_tgt.get(int(ag.source_v[e]), []))
            return [x for x in out if x != e]

        levels, edges = _local_bfs(start, neighbors, max_distance)

        def label(e):
            n = int(ag.chain_offsets[e + 1] - ag.chain_offsets[e])
            return f"{e} ({n})"

        layout = q.get("layout", ["force"])[0]
        svg = None
        if layout != "layered":
            # Laid-out view (reference: the graphviz-laid
            # LocalAssemblyGraph SVG, AssemblerHttpServer-
            # AssemblyGraph.cpp): segments drawn as bars whose length
            # tracks their marker-path length, positioned by the
            # force-directed pass, colored by average edge coverage.
            # The BFS edge list carries both orientations; only draw
            # real head-to-tail adjacencies.
            def link_info(u, v):
                if int(ag.target_v[u]) == int(ag.source_v[v]):
                    return (1.5, "")
                return None

            svg = _svg_segment_graph(
                levels,
                edges,
                seg_len=lambda e: int(
                    ag.chain_offsets[e + 1] - ag.chain_offsets[e]
                ),
                seg_color=self._segment_coverage_color,
                highlight=start,
                href="exploreAssemblyGraphEdge?edgeId=",
                link_info=link_info,
            )
        if svg is None:  # layered requested, or force budget exceeded
            svg = _svg_layered_graph(
                levels, edges, label_of=label, highlight=start
            )
        rows = [
            "<h2>Local assembly graph</h2>",
            f"<p>Start segment {start}, distance {max_distance}; "
            f"label = segment id; bar length tracks marker-path "
            f"length; color = average marker-graph edge coverage "
            f'(darker = higher). <a href="?segment={start}'
            f'&maxDistance={max_distance}&layout='
            f'{"layered" if layout != "layered" else "force"}">'
            f'{"layered" if layout != "layered" else "laid-out"} '
            f"view</a></p>",
            svg,
            '<form>Segment <input name=segment value="%d"> '
            'Max distance <input name=maxDistance value="%d"> '
            "<input type=submit></form>" % (start, max_distance),
        ]
        return "\n".join(rows)

    def _segment_coverage_color(self, e: int) -> str:
        """Average marker-graph edge coverage of a segment -> a
        green shade (reference colors local assembly graphs by
        coverage, AssemblerHttpServer-AssemblyGraph.cpp)."""
        ag = self.assembly_graph
        mg = self.marker_graph
        try:
            chain = ag.chain(e)
            cov = float(np.mean(mg.coverage[chain])) if chain.shape[0] else 0.0
        except Exception:
            cov = 0.0
        shade = int(max(40, 200 - 10 * cov))
        return f"rgb({shade},{min(255, shade + 60)},{shade})"

    def page_alignment(self, q) -> str:
        """Compute and display one alignment (reference:
        exploreAlignment, src/AssemblerHttpServer-Align.cpp)."""
        if self.markers is None:
            return "<p>Markers not available.</p>"
        import numpy as np

        r0 = int(q.get("readId0", ["0"])[0])
        s0 = int(q.get("strand0", ["0"])[0])
        r1 = int(q.get("readId1", ["1"])[0])
        s1 = int(q.get("strand1", ["0"])[0])
        form = (
            "<form>Read 0 <input name=readId0 value=%d size=6> strand "
            "<input name=strand0 value=%d size=2> Read 1 "
            "<input name=readId1 value=%d size=6> strand "
            "<input name=strand1 value=%d size=2> <input type=submit value=Align>"
            "</form>" % (r0, s0, r1, s1)
        )
        n_reads = self.markers.oriented_read_count // 2
        if not (0 <= r0 < n_reads and 0 <= r1 < n_reads):
            return form + f"<p>Read ids must be in 0..{n_reads - 1}.</p>"
        if r0 == r1:
            return form + "<p>Choose two distinct reads.</p>"
        from shasta_tpu_torch.data.kmers import KmerTable
        from shasta_tpu_torch.ops.align import AlignParams, align_candidates

        kt = self._soft(
            lambda: KmerTable.from_arrays(self.store.load_stage("Kmers"))
        )
        if kt is None:
            return form + "<p>K-mer table not available.</p>"
        lo, hi = (r0, r1) if r0 <= r1 else (r1, r0)
        st = align_candidates(
            self.markers,
            np.array([lo], np.int32),
            np.array([hi], np.int32),
            np.array([s0 == s1], bool),
            AlignParams(min_aligned_marker_count=0),
            kt.downsampling_hash_table(),
            device=self.device,
        )
        if st.count == 0:
            return form + "<p>No alignment found.</p>"
        o0, o1 = st.ordinals(0)
        rows = [
            form,
            f"<h2>Alignment of ({r0},{s0}) and ({r1},{s1})</h2>",
            f"<p>{o0.shape[0]} aligned markers; ordinal offsets "
            f"{int(st.min_offset[0])}..{int(st.max_offset[0])}; "
            f"max skip {int(st.max_skip_v[0])}, max drift {int(st.max_drift_v[0])}.</p>",
            "<table><tr><th>Ordinal0</th><th>Ordinal1</th></tr>",
        ]
        step = max(1, o0.shape[0] // 200)
        for i in range(0, o0.shape[0], step):
            rows.append(f"<tr><td>{int(o0[i])}</td><td>{int(o1[i])}</td></tr>")
        rows.append("</table>")
        return "\n".join(rows)


def _svg_layered_graph(levels, edges, label_of=str, highlight=None):
    """Minimal layered SVG: BFS levels as columns (stand-in for the
    reference's graphviz layouts, runCommandWithTimeout + dot)."""
    pos = {}
    for col, level in enumerate(levels):
        for row, v in enumerate(sorted(level)):
            pos[v] = (80 + col * 160, 40 + row * 48)
    width = 160 * len(levels) + 80
    height = 48 * max((len(l) for l in levels), default=1) + 60
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}">'
    ]
    for u, v in edges:
        if u in pos and v in pos:
            (x1, y1), (x2, y2) = pos[u], pos[v]
            parts.append(
                f'<line x1="{x1}" y1="{y1}" x2="{x2}" y2="{y2}" '
                'stroke="#888" stroke-width="1.5"/>'
            )
    for v, (x, y) in pos.items():
        color = "#e33" if v == highlight else "#2a6"
        parts.append(
            f'<circle cx="{x}" cy="{y}" r="14" fill="{color}"/>'
            f'<text x="{x}" y="{y + 4}" font-size="9" text-anchor="middle" '
            f'fill="white">{label_of(v)}</text>'
        )
    parts.append("</svg>")
    return "".join(parts)


# Above this many segments the O(n^2) force layout would hog the
# 4-core host (dense all-pairs repulsion temporaries); fall back to
# the cheap layered view instead.
_FORCE_LAYOUT_MAX_SEGMENTS = 400


def _svg_segment_graph(
    levels,
    edges,
    seg_len,
    seg_color,
    highlight=None,
    href=None,
    link_info=None,
    seg_title=None,
):
    """Laid-out local graph: each segment is a bar whose desired
    length grows with its size, positioned by the numpy
    force-directed pass (reference analog: the graphviz/neato-laid
    LocalAssemblyGraph SVGs; the TPU build lays out with its own
    Fruchterman-Reingold — http/explore_more.py:_force_layout).

    ``link_info(u, v)`` returns (stroke_width, title) for a drawable
    directed connection, or None to skip — the BFS edge list carries
    both orientations of each adjacency, and only the caller knows
    which direction is real. ``seg_title(s)`` appends to the segment
    tooltip. Returns None when the neighborhood exceeds the force-
    layout budget (callers fall back to the layered view)."""
    from shasta_tpu_torch.http.explore_more import _force_layout

    segs = sorted({v for level in levels for v in level})
    if not segs:
        return "<p>Empty neighborhood.</p>"
    if len(segs) > _FORCE_LAYOUT_MAX_SEGMENTS:
        return None
    idx = {s: i for i, s in enumerate(segs)}
    n = len(segs)
    disp = [30.0 + 10.0 * (max(seg_len(s), 1) ** 0.5) for s in segs]
    aux = [(2 * i, 2 * i + 1, disp[i]) for i in range(n)]
    links = []
    for (u, v) in sorted(set(edges)):
        if u not in idx or v not in idx or u == v:
            continue
        info = link_info(u, v) if link_info is not None else (1.5, "")
        if info is None:
            continue
        aux.append((2 * idx[u] + 1, 2 * idx[v], 40.0))
        links.append((idx[u], idx[v], info[0], info[1]))
    pos = _force_layout(2 * n, aux, seed=(highlight or 0) + 1)
    lo = pos.min(0)
    span = np.maximum(pos.max(0) - lo, 1e-6)
    size = min(1200.0, 260.0 + 90.0 * (n ** 0.5))
    pos = (pos - lo) / span * (size - 80.0) + 40.0

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size:.0f}" '
        f'height="{size:.0f}" style="background:#fafafa">'
    ]
    for i0, i1, w, title in links:
        x1, y1 = pos[2 * i0 + 1]
        x2, y2 = pos[2 * i1]
        dx, dy = x2 - x1, y2 - y1
        cx1, cy1 = x1 + 0.25 * dx - 0.15 * dy, y1 + 0.25 * dy + 0.15 * dx
        cx2, cy2 = x1 + 0.75 * dx - 0.15 * dy, y1 + 0.75 * dy + 0.15 * dx
        t = f"<title>{title}</title>" if title else ""
        parts.append(
            f'<path d="M{x1:.1f},{y1:.1f} C{cx1:.1f},{cy1:.1f} '
            f'{cx2:.1f},{cy2:.1f} {x2:.1f},{y2:.1f}" fill="none" '
            f'stroke="#557" stroke-width="{w:.1f}" opacity="0.7">{t}</path>'
        )
    for s in segs:
        i = idx[s]
        x1, y1 = pos[2 * i]
        x2, y2 = pos[2 * i + 1]
        color = "#e33" if s == highlight else seg_color(s)
        extra = seg_title(s) if seg_title is not None else ""
        parts.append(
            f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" '
            f'y2="{y2:.1f}" stroke="{color}" stroke-width="9" '
            f'stroke-linecap="round">'
            f"<title>segment {s}, {seg_len(s)} marker-graph edges"
            f"{extra}</title></line>"
        )
        mx, my = (x1 + x2) / 2, (y1 + y2) / 2
        text = (
            f'<a href="{href}{s}">{s}</a>' if href else str(s)
        )
        parts.append(
            f'<text x="{mx:.1f}" y="{my - 7:.1f}" font-size="10" '
            f'text-anchor="middle" fill="#222">{text}</text>'
        )
    parts.append("</svg>")
    return "".join(parts)


def _local_bfs(start, neighbors, max_distance):
    levels = [[start]]
    seen = {start}
    edges = []
    for d in range(max_distance):
        nxt = []
        for u in levels[-1]:
            for v in neighbors(u):
                edges.append((u, v))
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
        if not nxt:
            break
        levels.append(nxt)
    return levels, edges


class _LocalViews:
    """Local subgraph pages mixed into the Explorer."""

    def page_local_read_graph(self, q) -> str:
        """Local read graph with reference-grade rendering (reference:
        exploreReadGraph, src/AssemblerHttpServer-ReadGraph.cpp +
        LocalReadGraph.cpp): chimeric reads red, palindromic orange,
        cross-strand edges dashed, inconsistent-alignment edges purple,
        edge width tracks aligned marker count, click-through to the
        read and alignment pages."""
        if self.read_graph is None:
            return "<p>Read graph not available.</p>"
        rid = int(q.get("readId", ["0"])[0])
        strand = int(q.get("strand", ["0"])[0])
        dist = int(q.get("maxDistance", ["2"])[0])
        start = 2 * rid + strand
        g = self.read_graph
        if not (0 <= start < g.n_oriented_reads):
            return f"<p>Invalid read id {rid}-{strand}.</p>"

        def neighbors(v):
            _, other = g.neighbors(v)
            return [int(x) for x in other]

        levels, _tree = _local_bfs(start, neighbors, dist)
        dist_of = {}
        for d, level in enumerate(levels):
            for v in level:
                dist_of[v] = d
        node_arr = np.array(sorted(dist_of), dtype=np.int64)
        eids = np.flatnonzero(
            np.isin(g.orid0, node_arr) & np.isin(g.orid1, node_arr)
        )
        # Each undirected adjacency is stored as an RC edge pair; draw
        # each once.
        seen = set()
        pos = {}
        for col, level in enumerate(levels):
            for row, v in enumerate(sorted(level)):
                pos[v] = (90 + col * 170, 50 + row * 52)
        width = 170 * len(levels) + 110
        height = 52 * max((len(l) for l in levels), default=1) + 70
        parts = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}">'
        ]
        al = self.alignments
        for e in eids:
            u, v = int(g.orid0[e]), int(g.orid1[e])
            # Key on the normalized pair: a self-RC adjacency stores
            # its RC twin as (v, u) and would otherwise draw twice.
            if (min(u, v), max(u, v)) in seen:
                continue
            seen.add((min(u, v), max(u, v)))
            (x1, y1), (x2, y2) = pos[u], pos[v]
            aid = int(g.alignment_id[e])
            nm = (
                int(al.marker_count[aid])
                if al is not None and aid < al.count
                else 0
            )
            w = 1.0 + min(4.0, np.log2(max(nm, 1)) / 2)
            stroke = "#909" if bool(g.inconsistent[e]) else "#777"
            dash = ' stroke-dasharray="6,3"' if bool(
                g.crosses_strands[e]
            ) else ""
            href = (
                f"alignment?readId0={u >> 1}&strand0={u & 1}"
                f"&readId1={v >> 1}&strand1={v & 1}"
            )
            parts.append(
                f'<a href="{href}"><line x1="{x1}" y1="{y1}" x2="{x2}" '
                f'y2="{y2}" stroke="{stroke}" stroke-width="{w:.1f}"{dash}>'
                f"<title>alignment {aid}: {u >> 1}-{u & 1} &#8596; "
                f"{v >> 1}-{v & 1}, {nm} aligned markers"
                f"{', crosses strands' if g.crosses_strands[e] else ''}"
                f"{', inconsistent' if g.inconsistent[e] else ''}"
                "</title></line></a>"
            )
        reads = self.reads
        for v, (x, y) in pos.items():
            r = v >> 1
            chim = reads is not None and bool(reads.is_chimeric[r])
            palin = reads is not None and bool(reads.is_palindromic[r])
            fill = "#d33" if chim else ("#e90" if palin else "#2a6")
            stroke = "#000" if v == start else (
                "#33e" if dist_of[v] == dist else "none"
            )
            flag = (
                ", chimeric" if chim else (", palindromic" if palin else "")
            )
            parts.append(
                f'<a href="read?readId={r}&strand={v & 1}">'
                f'<circle cx="{x}" cy="{y}" r="15" fill="{fill}" '
                f'stroke="{stroke}" stroke-width="2">'
                f"<title>read {r} strand {v & 1}, distance {dist_of[v]}"
                f"{flag}</title></circle>"
                f'<text x="{x}" y="{y + 4}" font-size="9" '
                f'text-anchor="middle" fill="white">{r}-{v & 1}</text></a>'
            )
        parts.append("</svg>")
        form = (
            "<form>Read <input name=readId value=%d size=8> "
            "Strand <input name=strand value=%d size=2> "
            "Max distance <input name=maxDistance value=%d size=3> "
            "<input type=submit value=Update></form>" % (rid, strand, dist)
        )
        return (
            f"<h1>Local read graph around {rid}-{strand} "
            f"(distance {dist})</h1>" + form
            + f"<p>{len(pos)} oriented reads, {len(seen)} edges; red = "
            "chimeric, orange = palindromic, dashed = crosses strands, "
            "purple = inconsistent alignment, width &#8776; aligned "
            "marker count; click a read or an edge.</p>" + "".join(parts)
        )

    def _vertex_kmer_str(self, vid: int) -> str:
        """RLE k-mer of a marker-graph vertex (all its markers share
        it), decoded from the first marker's packed id."""
        mg = self.marker_graph
        if self.markers is None:
            return ""
        mids = mg.vertex_marker_ids(vid)
        if mids.shape[0] == 0:
            return ""
        kid = int(self.markers.kmer_ids[int(mids[0])])
        k = self.markers.k
        return "".join("ACGT"[(kid >> (2 * (k - 1 - i))) & 3] for i in range(k))

    def page_local_marker_graph(self, q) -> str:
        """Local marker graph with reference-grade rendering
        (reference: exploreMarkerGraph + LocalMarkerGraph-Write.cpp):
        directed edges with arrowheads and coverage-scaled widths,
        vertices colored by coverage or BFS distance, optional marker
        k-mer labels, tooltips, and click-through to the vertex/edge
        detail pages."""
        if self.marker_graph is None or self.marker_graph.source is None:
            return "<p>Marker graph not available.</p>"
        vid = int(q.get("vertexId", ["0"])[0])
        dist = int(q.get("maxDistance", ["3"])[0])
        color_by = q.get("color", ["coverage"])[0]
        labels = q.get("label", ["id"])[0]
        mg = self.marker_graph
        if not (0 <= vid < mg.vertex_count):
            return f"<p>Invalid vertex id {vid}.</p>"
        alive = mg.alive()
        out_lists = {}

        def neighbors(v):
            if v not in out_lists:
                outs = np.flatnonzero((mg.source == v) & alive)
                ins = np.flatnonzero((mg.target == v) & alive)
                out_lists[v] = [int(mg.target[e]) for e in outs] + [
                    int(mg.source[e]) for e in ins
                ]
            return out_lists[v]

        levels, _tree_edges = _local_bfs(vid, neighbors, dist)
        dist_of = {}
        for d, level in enumerate(levels):
            for v in level:
                dist_of[v] = d

        # All alive edges with both endpoints in the neighborhood (the
        # BFS tree alone would hide cycles/bubbles the reference shows).
        node_arr = np.array(sorted(dist_of), dtype=np.int64)
        in_set_s = np.isin(mg.source, node_arr) & alive
        in_set = np.flatnonzero(in_set_s & np.isin(mg.target, node_arr))

        # Layered positions: BFS distance = column.
        pos = {}
        for col, level in enumerate(levels):
            for row, v in enumerate(sorted(level)):
                pos[v] = (90 + col * 190, 50 + row * 52)
        width = 190 * len(levels) + 120
        height = 52 * max((len(l) for l in levels), default=1) + 70

        def vcolor(v):
            if color_by == "distance":
                d = dist_of[v]
                shade = int(230 - 170 * (d / max(dist, 1)))
                return f"rgb({shade},{shade},255)" if v != vid else "#e33"
            cov = int(mg.vertex_marker_ids(v).shape[0])
            shade = int(max(40, 210 - 12 * cov))
            return f"rgb({shade},{min(255, shade + 55)},{shade})"

        parts = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}">',
            '<defs><marker id="arrow" viewBox="0 0 10 10" refX="9" '
            'refY="5" markerWidth="7" markerHeight="7" orient="auto">'
            '<path d="M0,0 L10,5 L0,10 z" fill="#666"/></marker></defs>',
        ]
        for e in in_set:
            u, v = int(mg.source[e]), int(mg.target[e])
            (x1, y1), (x2, y2) = pos[u], pos[v]
            cov = int(mg.coverage[e])
            w = 1.0 + min(4.0, np.log2(max(cov, 1)))
            mx, my = (x1 + x2) / 2, (y1 + y2) / 2 - (14 if u != v else 30)
            parts.append(
                f'<a href="exploreMarkerGraphEdge?edgeId={e}">'
                f'<path d="M{x1},{y1} Q{mx},{my} {x2},{y2}" fill="none" '
                f'stroke="#666" stroke-width="{w:.1f}" '
                'marker-end="url(#arrow)">'
                f"<title>edge {e}: {u} &#8594; {v}, coverage {cov}"
                "</title></path></a>"
            )
        show_seq = labels == "sequence" and self.markers is not None
        k = self.markers.k if self.markers is not None else 0
        half_w = (7 * k + 14) // 2 if show_seq else 16
        for v, (x, y) in pos.items():
            cov = int(mg.vertex_marker_ids(v).shape[0])
            stroke = (
                "#e33" if v == vid
                else ("#33e" if dist_of[v] == dist else "#333")
            )
            seq = self._vertex_kmer_str(v) if show_seq else ""
            label = seq if show_seq else str(v)
            parts.append(
                f'<a href="exploreMarkerGraphVertex?vertexId={v}">'
                f'<rect x="{x - half_w}" y="{y - 13}" width="{2 * half_w}" '
                f'height="26" rx="8" fill="{vcolor(v)}" stroke="{stroke}" '
                'stroke-width="2">'
                f"<title>vertex {v}, coverage {cov}, distance "
                f"{dist_of[v]}{', ' + seq if seq else ''}</title></rect>"
                f'<text x="{x}" y="{y + 4}" font-size="10" '
                'font-family="monospace" text-anchor="middle" '
                f'fill="black">{label}</text></a>'
            )
        parts.append("</svg>")
        form = (
            "<form>Start vertex <input name=vertexId value=%d size=8> "
            "Max distance <input name=maxDistance value=%d size=3> "
            "Label <select name=label>"
            "<option value=id%s>vertex id</option>"
            "<option value=sequence%s>marker sequence</option></select> "
            "Color <select name=color>"
            "<option value=coverage%s>coverage</option>"
            "<option value=distance%s>distance</option></select> "
            "<input type=submit value=Update></form>"
        ) % (
            vid, dist,
            " selected" if labels == "id" else "",
            " selected" if labels == "sequence" else "",
            " selected" if color_by == "coverage" else "",
            " selected" if color_by == "distance" else "",
        )
        return (
            f"<h1>Local marker graph around vertex {vid} "
            f"(distance {dist})</h1>" + form
            + f"<p>{len(pos)} vertices, {in_set.shape[0]} edges; "
            "arrow = edge direction, width &#8776; log coverage; "
            "red outline = start, blue outline = distance boundary; "
            "click a vertex or edge for its detail page.</p>" + "".join(parts)
        )


    def page_alignment_matrix(self, q) -> str:
        """Marker dot plot of two oriented reads (stand-in for the
        reference's PNG alignment-matrix display,
        src/PngImage.{hpp,cpp} + exploreAlignment)."""
        if self.markers is None:
            return "<p>Markers not available.</p>"
        r0 = int(q.get("readId0", ["0"])[0])
        s0 = int(q.get("strand0", ["0"])[0])
        r1 = int(q.get("readId1", ["1"])[0])
        s1 = int(q.get("strand1", ["0"])[0])
        k0, _ = self.markers.get(2 * r0 + s0)
        k1, _ = self.markers.get(2 * r1 + s1)
        n0, n1 = k0.shape[0], k1.shape[0]
        if n0 == 0 or n1 == 0:
            return "<p>No markers.</p>"
        scale = max(1, max(n0, n1) // 800)
        w, h = n0 // scale + 20, n1 // scale + 20
        dots = []
        # Dot positions: shared k-mers (frequency-capped for display).
        import collections

        pos1 = collections.defaultdict(list)
        for j, kv in enumerate(k1):
            pos1[int(kv)].append(j)
        count = 0
        for i, kv in enumerate(k0):
            for j in pos1.get(int(kv), ()):
                dots.append(
                    f'<rect x="{10 + i // scale}" y="{10 + j // scale}" '
                    'width="1" height="1" fill="#138"/>'
                )
                count += 1
                if count > 200000:
                    break
            if count > 200000:
                break
        svg = (
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
            f'height="{h}" style="background:#f8f8f8">' + "".join(dots) + "</svg>"
        )
        return (
            f"<h1>Alignment matrix {r0}-{s0} vs {r1}-{s1}</h1>"
            f"<p>{n0} x {n1} markers, {count} dots.</p>" + svg
        )


Explorer.page_local_read_graph = _LocalViews.page_local_read_graph
Explorer.page_local_marker_graph = _LocalViews.page_local_marker_graph
Explorer._vertex_kmer_str = _LocalViews._vertex_kmer_str
Explorer.page_alignment_matrix = _LocalViews.page_alignment_matrix

# Extended page families (alignment assessment, marker/assembly graph
# drill-down, mode 3) live in explore_more; mix them in here.
from shasta_tpu_torch.http import explore_more as _more  # noqa: E402

for _mixin in (
    _more._AlignmentViews,
    _more._MarkerGraphViews,
    _more._AssemblyGraphViews,
    _more._Mode3Views,
):
    for _name in dir(_mixin):
        if _name.startswith("page_") or _name.startswith("_"):
            if not hasattr(Explorer, _name):
                # getattr_static keeps a staticmethod static (the JAX
                # package's getattr turns _Mode3Views._find_m3_link into a
                # method, so /mode3 raises on a segment with links:
                # ROADMAP.md, queue 3).
                setattr(Explorer, _name, inspect.getattr_static(_mixin, _name))


# Route table: our short names plus the reference's endpoint names
# (src/AssemblerHttpServer.cpp:216-250) as aliases.
def _routes(explorer: "Explorer"):
    e = explorer
    table = {
        "/": e.page_index,
        "/index": e.page_index,
        "/exploreSummary": e.page_index,
        "/read": e.page_read,
        "/exploreRead": e.page_read,
        "/blastRead": e.page_blast_read,
        "/alignments": e.page_alignments,
        "/exploreAlignments": e.page_alignments,
        "/alignment": e.page_alignment,
        "/exploreAlignment": e.page_alignment,
        "/exploreAlignmentCoverage": e.page_alignment_coverage,
        "/computeAllAlignments": e.page_compute_all_alignments,
        "/exploreAlignmentCandidateGraph": e.page_candidate_graph,
        "/exploreAlignmentGraph": e.page_alignment_graph,
        "/alignSequencesInBaseRepresentation": e.page_align_sequences_base,
        "/alignSequencesInMarkerRepresentation":
            e.page_align_sequences_markers,
        "/assessAlignments": e.page_assess_alignments,
        "/readGraph": e.page_read_graph,
        "/exploreReadGraph": e.page_local_read_graph,
        "/localReadGraph": e.page_local_read_graph,
        "/markerGraph": e.page_marker_graph,
        "/exploreMarkerGraph": e.page_local_marker_graph,
        "/exploreMarkerGraphVertex": e.page_marker_graph,
        "/exploreMarkerGraphEdge": e.page_marker_graph_edge,
        "/markerGraphEdge": e.page_marker_graph_edge,
        "/exploreMarkerCoverage": e.page_marker_coverage,
        "/exploreMarkerGraphInducedAlignment": e.page_induced_alignment,
        "/inducedAlignment": e.page_induced_alignment,
        "/followReadInMarkerGraph": e.page_follow_read,
        "/exploreMarkerConnectivity": e.page_marker_connectivity,
        "/localMarkerGraph": e.page_local_marker_graph,
        "/alignmentMatrix": e.page_alignment_matrix,
        "/assemblyGraph": e.page_assembly_graph,
        "/exploreAssemblyGraph": e.page_assembly_graph,
        "/exploreAssemblyGraphEdge": e.page_assembly_graph_edge,
        "/assemblyGraphEdge": e.page_assembly_graph_edge,
        "/exploreAssemblyGraphEdgesSupport":
            e.page_assembly_graph_edges_support,
        "/exploreCompressedAssemblyGraph": e.page_compressed_assembly_graph,
        "/compressedAssemblyGraph": e.page_compressed_assembly_graph,
        "/exploreMode3AssemblyGraph": e.page_mode3,
        "/mode3": e.page_mode3,
        "/exploreMode3AssemblyGraphSegment": e.page_mode3_segment,
        "/mode3Segment": e.page_mode3_segment,
        "/exploreMode3AssemblyGraphSegmentPair": e.page_mode3_segment_pair,
        "/mode3SegmentPair": e.page_mode3_segment_pair,
        "/exploreMode3AssemblyGraphLink": e.page_mode3_link,
        "/mode3Link": e.page_mode3_link,
        "/exploreMode3MetaAlignment": e.page_mode3_meta_alignment,
        "/mode3MetaAlignment": e.page_mode3_meta_alignment,
        "/exploreMode3AssemblyPath": e.page_mode3_assembly_path,
        "/mode3AssemblyPath": e.page_mode3_assembly_path,
        "/exploreMode3LinkAssembly": e.page_mode3_link_assembly,
        "/mode3LinkAssembly": e.page_mode3_link_assembly,
    }
    return table


def make_handler(explorer: Explorer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            try:
                if url.path == "/assemblySummary.json":
                    p = os.path.join(explorer.run_dir, "AssemblySummary.json")
                    with open(p, "rb") as f:
                        body = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                fn = _routes(explorer).get(url.path)
                if fn is None:
                    self.send_response(404)
                    self.end_headers()
                    self.wfile.write(b"Not found")
                    return
                body = ("<html><head>" + _STYLE + "</head><body>" + fn(q) + "</body></html>").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(body)
            except BrokenPipeError:
                pass
            except Exception as e:  # show errors in the page, like the reference
                body = f"<pre>Error: {html.escape(repr(e))}</pre>".encode()
                self.send_response(500)
                self.end_headers()
                self.wfile.write(body)

    return Handler


def _peer_uid(client_address) -> int | None:
    """Best-effort UID of the local process owning the client socket,
    via /proc/net/tcp{,6} (the reference restricts "user" access to
    connections from the same user, src/HttpServer.hpp:25-70)."""
    host, port = client_address[0], client_address[1]
    try:
        import socket
        import struct

        if ":" in host:
            # ::1 / ::ffff:127.0.0.1 in /proc/net/tcp6 hex layout.
            packed = socket.inet_pton(socket.AF_INET6, host)
            words = struct.unpack("<4I", packed)
            want = "".join(f"{w:08X}" for w in words)
            proc = "/proc/net/tcp6"
        else:
            want = f"{struct.unpack('<I', socket.inet_aton(host))[0]:08X}"
            proc = "/proc/net/tcp"
        want_local = f"{want}:{port:04X}"
        with open(proc) as f:
            next(f)
            for line in f:
                fields = line.split()
                if fields[1] == want_local:
                    return int(fields[7])
    except Exception:
        return None
    return None


def run_explorer(
    run_dir: str,
    port: int = 17100,
    access: str = "user",
    paf_file: str | None = None,
    device="cuda",
):
    """Serve the explorer. ``access`` mirrors the reference's
    --exploreAccess (srcMain/main.cpp:1349-1368): "user" = local
    connections from the same user only (default), "local" = any local
    user, "unrestricted" = any computer. ``device``: where the on-demand
    alignments run."""
    if access not in ("user", "local", "unrestricted"):
        raise ValueError(
            "Invalid value specified for --exploreAccess. Only use this "
            "option if you understand its security implications."
        )
    bind = "" if access == "unrestricted" else "127.0.0.1"
    explorer = Explorer(run_dir, paf_file=paf_file, device=device)
    handler = make_handler(explorer)
    if access == "user":
        my_uid = os.getuid()
        orig_do_get = handler.do_GET

        def guarded_do_GET(self):
            uid = _peer_uid(self.client_address)
            if uid is not None and uid != my_uid:
                self.send_response(403)
                self.end_headers()
                self.wfile.write(b"Access restricted to the same user.")
                return
            orig_do_get(self)

        handler.do_GET = guarded_do_GET
    server = HTTPServer((bind, port), handler)
    shown = bind or "0.0.0.0"
    print(f"Exploring {run_dir} at http://{shown}:{port}/")
    if access == "user":
        print(
            "Only accepting local connections originating from a process "
            "owned by the same user running the server."
        )
    elif access == "local":
        print("Accepting local connections from any user.")
    else:
        print("Accepting connections from any computer, any user.")
    server.serve_forever()
