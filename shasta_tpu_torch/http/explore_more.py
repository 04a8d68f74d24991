"""Explorer pages beyond the core set: alignment assessment, marker
graph drill-down, assembly graph drill-down, and mode-3 views.

Counterpart of ``shasta_tpu/http/explore_more.py``, copied line for line
with its imports repointed to the port; the on-demand alignments run on
the explorer's ``device``.

Each page mirrors a reference endpoint from the function table at
src/AssemblerHttpServer.cpp:209-250; the per-page reference file is
cited on the method. Pages are mixed into
:class:`shasta_tpu_torch.http.explore.Explorer` (see routes there).
"""

from __future__ import annotations

import html
import numpy as np


def _svg_series(values, width=760, height=120, color="#205080"):
    """Tiny inline SVG line plot for per-position series."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        return "<p>(empty)</p>"
    if v.size > width:
        # Downsample by max over equal chunks.
        chunks = np.array_split(v, width)
        v = np.array([c.max() for c in chunks])
    top = max(1.0, float(v.max()))
    n = v.size
    pts = " ".join(
        f"{10 + i * (width - 20) / max(1, n - 1):.1f},"
        f"{height - 10 - (val / top) * (height - 30):.1f}"
        for i, val in enumerate(v)
    )
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" style="background:#f8f8f8">'
        f'<polyline points="{pts}" fill="none" stroke="{color}" '
        'stroke-width="1.5"/>'
        f'<text x="12" y="16" font-size="11">max {top:.0f}</text></svg>'
    )


def _hist_table(values, edges, title):
    v = np.asarray(values)
    h, _ = np.histogram(v, bins=edges)
    rows = [f"<h3>{title}</h3>", "<table><tr><th>bin</th><th>count</th></tr>"]
    for i, c in enumerate(h):
        rows.append(
            f"<tr><td>{edges[i]}-{edges[i + 1]}</td><td>{int(c)}</td></tr>"
        )
    rows.append("</table>")
    return "".join(rows)


def _ors(q, key, default="0"):
    return int(q.get(key, [default])[0])


class _AlignmentViews:
    """Alignment-centric pages (reference:
    src/AssemblerHttpServer-Align.cpp)."""

    def _candidates(self):
        from shasta_tpu_torch.ops.lowhash import CandidatePairs

        return self._soft(
            lambda: CandidatePairs.from_arrays(
                self.store.load_stage("AlignmentCandidates")
            )
        )

    def page_alignment_coverage(self, q) -> str:
        """Per-ordinal alignment coverage of one oriented read
        (reference: exploreAlignmentCoverage)."""
        if self.alignments is None or self.markers is None:
            return "<p>Alignments not available.</p>"
        rid = _ors(q, "readId")
        strand = _ors(q, "strand")
        al = self.alignments
        kk, _ = self.markers.get(2 * rid + strand)
        n = kk.shape[0]
        cov = np.zeros(n + 1, np.int64)
        sel0 = np.flatnonzero(al.read_id0 == rid)
        sel1 = np.flatnonzero(al.read_id1 == rid)
        # Read appears as side 0 (stored on strand 0): flip the ordinal
        # range when viewing strand 1.
        for sel, first, last in (
            (sel0, al.first0, al.last0),
            (sel1, al.first1, al.last1),
        ):
            for i in sel:
                f, l = int(first[i]), int(last[i])
                if strand == 1:
                    f, l = n - 1 - l, n - 1 - f
                f = max(0, min(f, n - 1))
                l = max(0, min(l, n - 1))
                cov[f] += 1
                cov[l + 1] -= 1
        cov = np.cumsum(cov[:-1])
        form = (
            '<form>Read <input name=readId value="%d" size=6> strand '
            '<input name=strand value="%d" size=2> <input type=submit>'
            "</form>" % (rid, strand)
        )
        return (
            f"<h1>Alignment coverage of read {rid}-{strand}</h1>" + form
            + f"<p>{sel0.size + sel1.size} alignments over {n} markers; "
            f"mean coverage {cov.mean():.1f}.</p>" + _svg_series(cov)
        )

    def page_candidate_graph(self, q) -> str:
        """Local alignment-candidate graph (reference:
        exploreAlignmentCandidateGraph)."""
        cand = self._candidates()
        if cand is None:
            return "<p>Alignment candidates not available.</p>"
        rid = _ors(q, "readId")
        dist = _ors(q, "maxDistance", "2")
        from shasta_tpu_torch.http.explore import _local_bfs, _svg_layered_graph

        by_read = {}
        for i in range(cand.count):
            by_read.setdefault(int(cand.read_id0[i]), []).append(
                int(cand.read_id1[i])
            )
            by_read.setdefault(int(cand.read_id1[i]), []).append(
                int(cand.read_id0[i])
            )
        levels, edges = _local_bfs(rid, lambda v: by_read.get(v, []), dist)
        n_nodes = sum(len(l) for l in levels)
        ref_note = ""
        ref = getattr(self, "reference_overlaps", None)
        if ref is not None:
            true_pairs = ref.read_pairs()
            shown = {(min(a, b), max(a, b)) for a, b in edges}
            n_true = sum(1 for p in shown if p in true_pairs)
            missing = sorted(
                b for (a, b) in true_pairs if a == rid and (a, b) not in shown
            ) + sorted(a for (a, b) in true_pairs if b == rid and (a, b) not in shown)
            ref_note = (
                f"<p>Reference overlay: {n_true}/{len(shown)} displayed edges "
                f"are true reference overlaps"
                + (
                    f"; true partners of read {rid} missing from candidates: "
                    + ", ".join(str(m) for m in missing[:50])
                    if missing
                    else "; no true partner of this read is missing"
                )
                + ".</p>"
            )
        return (
            f"<h1>Alignment candidate graph around read {rid}</h1>"
            f"<p>{cand.count} candidate pairs total; {n_nodes} reads within "
            f"distance {dist}.</p>" + ref_note
            + _svg_layered_graph(levels, edges, highlight=rid)
        )

    def page_alignment_graph(self, q) -> str:
        """Local graph over all COMPUTED alignments, before read-graph
        selection (reference: exploreAlignmentGraph)."""
        if self.alignments is None:
            return "<p>Alignments not available.</p>"
        rid = _ors(q, "readId")
        dist = _ors(q, "maxDistance", "2")
        from shasta_tpu_torch.http.explore import _local_bfs, _svg_layered_graph

        al = self.alignments
        by_read = {}
        for i in range(al.read_id0.shape[0]):
            by_read.setdefault(int(al.read_id0[i]), []).append(
                int(al.read_id1[i])
            )
            by_read.setdefault(int(al.read_id1[i]), []).append(
                int(al.read_id0[i])
            )
        levels, edges = _local_bfs(rid, lambda v: by_read.get(v, []), dist)
        return (
            f"<h1>Alignment graph around read {rid}</h1>"
            f"<p>{al.read_id0.shape[0]} stored alignments.</p>"
            + _svg_layered_graph(levels, edges, highlight=rid)
        )

    def page_compute_all_alignments(self, q) -> str:
        """Compute alignments of one read against all its candidate
        partners (reference: computeAllAlignments)."""
        if self.markers is None:
            return "<p>Markers not available.</p>"
        rid = _ors(q, "readId")
        form = (
            '<form>Read <input name=readId value="%d" size=6> '
            "<input type=submit value=Compute></form>" % rid
        )
        cand = self._candidates()
        if cand is None:
            return form + "<p>Alignment candidates not available.</p>"
        sel = np.flatnonzero((cand.read_id0 == rid) | (cand.read_id1 == rid))
        if sel.size == 0:
            return form + f"<p>No candidates involve read {rid}.</p>"
        from shasta_tpu_torch.data.kmers import KmerTable
        from shasta_tpu_torch.ops.align import AlignParams, align_candidates

        kt = self._soft(
            lambda: KmerTable.from_arrays(self.store.load_stage("Kmers"))
        )
        if kt is None:
            return form + "<p>K-mer table not available.</p>"
        st = align_candidates(
            self.markers,
            cand.read_id0[sel],
            cand.read_id1[sel],
            cand.same_strand[sel],
            AlignParams(min_aligned_marker_count=0),
            kt.downsampling_hash_table(),
            device=self.device,
        )
        rows = [
            form,
            f"<h1>All alignments of read {rid}</h1>",
            f"<p>{sel.size} candidates, {st.count} alignments computed.</p>",
            "<table><tr><th>read0</th><th>read1</th><th>sameStrand</th>"
            "<th>markers</th><th>range0</th><th>range1</th></tr>",
        ]
        for i in range(st.count):
            rows.append(
                f"<tr><td>{st.read_id0[i]}</td><td>{st.read_id1[i]}</td>"
                f"<td>{bool(st.same_strand[i])}</td><td>{st.marker_count[i]}"
                f"</td><td>{st.first0[i]}-{st.last0[i]}</td>"
                f"<td>{st.first1[i]}-{st.last1[i]}</td></tr>"
            )
        rows.append("</table>")
        return "".join(rows)

    def page_assess_alignments(self, q) -> str:
        """Candidate/alignment funnel statistics (reference:
        assessAlignments, src/AssemblerHttpServer-Align.cpp)."""
        al = self.alignments
        cand = self._candidates()
        parts = ["<h1>Alignment assessment</h1>", "<table>"]
        n_cand = cand.count if cand is not None else 0
        n_al = al.read_id0.shape[0] if al is not None else 0
        n_rg = (
            self.read_graph.alignment_id.shape[0] // 2
            if self.read_graph is not None
            else 0
        )
        parts.append(f"<tr><th>Alignment candidates</th><td>{n_cand}</td></tr>")
        parts.append(f"<tr><th>Stored alignments</th><td>{n_al}</td></tr>")
        parts.append(
            f"<tr><th>Read graph edges (pairs)</th><td>{n_rg}</td></tr>"
        )
        parts.append("</table>")
        if al is not None and n_al:
            mc = al.marker_count
            parts.append(
                _hist_table(
                    mc,
                    [0, 10, 20, 40, 80, 160, 320, 640, 1 << 30],
                    "Aligned marker count",
                )
            )
        if cand is not None and n_cand:
            parts.append(
                _hist_table(
                    cand.frequency,
                    [0, 2, 4, 8, 16, 32, 1 << 30],
                    "Candidate LowHash frequency",
                )
            )
        ref = getattr(self, "reference_overlaps", None)
        if ref is not None and cand is not None and n_cand:
            true_pairs = ref.read_pairs()
            cand_pairs = {
                (min(int(a), int(b)), max(int(a), int(b)))
                for a, b in zip(cand.read_id0, cand.read_id1)
            }
            tp = len(cand_pairs & true_pairs)
            parts.append("<h2>Against the reference PAF overlay</h2><table>")
            parts.append(
                f"<tr><th>True reference overlaps</th><td>{len(true_pairs)}</td></tr>"
                f"<tr><th>Candidates confirmed by reference</th><td>{tp}</td></tr>"
                f"<tr><th>Candidate precision</th>"
                f"<td>{tp / max(len(cand_pairs), 1):.3f}</td></tr>"
                f"<tr><th>Candidate recall</th>"
                f"<td>{tp / max(len(true_pairs), 1):.3f}</td></tr>"
            )
            parts.append("</table>")
        return "".join(parts)

    def page_align_sequences_base(self, q) -> str:
        """Align two pasted base sequences (reference:
        alignSequencesInBaseRepresentation)."""
        s0 = q.get("sequence0", [""])[0].strip().upper()
        s1 = q.get("sequence1", [""])[0].strip().upper()
        form = (
            "<form><p>Sequence 0:<br>"
            f'<textarea name=sequence0 rows=4 cols=80>{html.escape(s0)}'
            "</textarea></p><p>Sequence 1:<br>"
            f'<textarea name=sequence1 rows=4 cols=80>{html.escape(s1)}'
            "</textarea></p><input type=submit value=Align></form>"
        )
        if not s0 or not s1:
            return "<h1>Align two sequences (base representation)</h1>" + form
        if len(s0) > 4000 or len(s1) > 4000:
            return form + "<p>Sequences must be at most 4000 bases.</p>"
        a = np.frombuffer(s0.encode(), np.uint8)
        b = np.frombuffer(s1.encode(), np.uint8)
        # Banded-free O(nm) edit alignment, vectorized over rows.
        n, m = a.size, b.size
        prev = np.arange(m + 1, dtype=np.int32)
        for i in range(1, n + 1):
            cur = np.empty(m + 1, np.int32)
            cur[0] = i
            sub = prev[:-1] + (b != a[i - 1])
            np.minimum(sub, prev[1:] + 1, out=cur[1:])
            # In-row gap dependency via running minimum.
            cur[1:] = np.minimum.accumulate(
                cur[1:] - np.arange(1, m + 1)
            ) + np.arange(1, m + 1)
            prev = cur
        dist = int(prev[m])
        ident = 100.0 * (max(n, m) - dist) / max(n, m)
        return (
            "<h1>Align two sequences (base representation)</h1>" + form
            + f"<p>Edit distance {dist} over {n} x {m} bases "
            f"(~{ident:.1f}% identity).</p>"
        )

    def page_align_sequences_markers(self, q) -> str:
        """Align two oriented reads in marker representation with the
        production kernel (reference:
        alignSequencesInMarkerRepresentation)."""
        return self.page_alignment(q)

    def page_blast_read(self, q) -> str:
        """Locate a read range in the assembly by exact-seed search
        (reference: blastRead shells out to blastn; this environment
        has no blast, so a built-in 31-base seed search against the
        assembled segments serves the same purpose)."""
        if self.reads is None or self.assembly_graph is None:
            return "<p>Reads or assembly not available.</p>"
        rid = _ors(q, "readId")
        strand = _ors(q, "strand")
        begin = _ors(q, "beginPosition")
        end = _ors(q, "endPosition", "0") or None
        form = (
            '<form>Read <input name=readId value="%d" size=6> strand '
            '<input name=strand value="%d" size=2> begin '
            '<input name=beginPosition value="%d" size=8> end '
            '<input name=endPosition value="%s" size=8> '
            "<input type=submit value=Search></form>"
            % (rid, strand, begin, end if end else "")
        )
        raw = self.reads.read_raw(rid, strand)
        if end is None:
            end = raw.shape[0]
        end = int(end)
        piece = raw[begin:end]
        K = 31
        if piece.shape[0] < K:
            return form + "<p>Range too short.</p>"
        # Seed table over the query.
        mult = 4 ** np.arange(K, dtype=np.int64)
        qk = {}
        vals = piece.astype(np.int64)
        kv = np.convolve(vals, mult[::-1], "valid") if False else None
        # Rolling hash without convolution overflow: polynomial mod 2^63.
        codes = vals
        h = np.zeros(piece.shape[0] - K + 1, np.int64)
        acc = 0
        for i in range(K):
            acc = acc * 4 + int(codes[i])
        h[0] = acc
        topmult = 4 ** (K - 1)
        for i in range(1, h.shape[0]):
            acc = (acc - int(codes[i - 1]) * topmult) * 4 + int(codes[i + K - 1])
            h[i] = acc
        for i, v in enumerate(h):
            qk.setdefault(int(v), []).append(i)
        ag = self.assembly_graph
        hits = {}
        for e in range(ag.edge_count):
            if not ag.is_assembled_edge(e):
                continue
            seq = ag.raw_sequence(e).astype(np.int64)
            if seq.shape[0] < K:
                continue
            acc = 0
            for i in range(K):
                acc = acc * 4 + int(seq[i])
            if acc in qk:
                for qp in qk[acc]:
                    hits.setdefault((e, 0 - qp), []).append((qp, 0))
            for i in range(1, seq.shape[0] - K + 1):
                acc = (acc - int(seq[i - 1]) * topmult) * 4 + int(seq[i + K - 1])
                if acc in qk:
                    for qp in qk[acc]:
                        hits.setdefault((e, i - qp), []).append((qp, i))
        rows = [
            f"<h1>Locate read {rid}-{strand} [{begin},{end}) in the "
            "assembly</h1>",
            form,
            f"<p>{len(hits)} (segment, diagonal) seed groups.</p>",
            "<table><tr><th>segment</th><th>offset</th><th>seeds</th>"
            "<th>query range</th><th>segment range</th></tr>",
        ]
        for (e, diag), hs in sorted(
            hits.items(), key=lambda kv: -len(kv[1])
        )[:50]:
            qps = [p for p, _ in hs]
            sps = [p for _, p in hs]
            rows.append(
                f"<tr><td>{e}</td><td>{diag}</td><td>{len(hs)}</td>"
                f"<td>{min(qps)}-{max(qps) + K}</td>"
                f"<td>{min(sps)}-{max(sps) + K}</td></tr>"
            )
        rows.append("</table>")
        return "".join(rows)


class _MarkerGraphViews:
    """Marker-graph drill-down pages (reference:
    src/AssemblerHttpServer-MarkerGraph.cpp)."""

    def page_marker_graph_edge(self, q) -> str:
        """Edge detail: flags, coverage, marker intervals, consensus
        (reference: exploreMarkerGraphEdge)."""
        mg = self.marker_graph
        if mg is None or mg.source is None:
            return "<p>Marker graph not available.</p>"
        eid = _ors(q, "edgeId")
        if not (0 <= eid < mg.edge_count):
            return f"<p>Edge id out of range (0..{mg.edge_count - 1}).</p>"
        u, v = int(mg.source[eid]), int(mg.target[eid])
        parts = [
            f"<h1>Marker graph edge {eid}</h1>",
            "<table>",
            f"<tr><th>source</th><td><a href='/markerGraph?vertexId={u}'>{u}"
            "</a></td></tr>",
            f"<tr><th>target</th><td><a href='/markerGraph?vertexId={v}'>{v}"
            "</a></td></tr>",
            f"<tr><th>coverage</th><td>{int(mg.coverage[eid])}</td></tr>",
        ]
        for flag in ("removed_tr", "pruned", "superbubble",
                     "low_coverage_cross"):
            arr = getattr(mg, flag, None)
            if arr is not None:
                parts.append(
                    f"<tr><th>{flag}</th><td>{bool(arr[eid])}</td></tr>"
                )
        parts.append("</table>")
        # Marker intervals: oriented reads with consecutive markers in
        # source then target vertex.
        moff = self.markers.offsets if self.markers is not None else None
        if moff is not None:
            parts.append(
                "<h2>Marker intervals</h2><table><tr><th>oriented read</th>"
                "<th>ordinal0</th><th>ordinal1</th></tr>"
            )
            mu = mg.vertex_marker_ids(u)
            mv = set(mg.vertex_marker_ids(v).tolist())
            orid_u = np.searchsorted(moff, mu, side="right") - 1
            for gm, orid in zip(mu.tolist(), orid_u.tolist()):
                if gm + 1 in mv:
                    o0 = gm - int(moff[orid])
                    parts.append(
                        f"<tr><td>{orid >> 1}-{orid & 1}</td>"
                        f"<td>{o0}</td><td>{o0 + 1}</td></tr>"
                    )
            parts.append("</table>")
        cons = self._soft(
            lambda: self._edge_consensus()
        )
        if cons is not None:
            from shasta_tpu_torch.data import bases as B

            seq, rep, overlap = cons.get(eid)
            if overlap > 0:
                parts.append(f"<p>Vertex k-mers overlap by {overlap}.</p>")
            else:
                parts.append(
                    f"<p>Consensus fill ({seq.shape[0]} RLE bases): "
                    f"<code>{B.decode_to_str(seq[:500])}</code></p>"
                )
        return "".join(parts)

    def _edge_consensus(self):
        if getattr(self, "_edge_cons_cache", None) is None:
            from shasta_tpu_torch.graph.assembly_graph import EdgeConsensus

            self._edge_cons_cache = EdgeConsensus.from_arrays(
                self.store.load_stage("EdgeConsensus")
            )
        return self._edge_cons_cache

    def page_marker_coverage(self, q) -> str:
        """Per-ordinal marker-graph vertex coverage of one oriented
        read (reference: exploreMarkerCoverage)."""
        mg = self.marker_graph
        if mg is None or self.markers is None:
            return "<p>Marker graph not available.</p>"
        rid = _ors(q, "readId")
        strand = _ors(q, "strand")
        orid = 2 * rid + strand
        moff = self.markers.offsets
        lo, hi = int(moff[orid]), int(moff[orid + 1])
        vt = mg.vertex_table[lo:hi]
        vcov = mg.vertex_coverage()
        cov = np.where(vt >= 0, vcov[np.clip(vt, 0, None)], 0)
        form = (
            '<form>Read <input name=readId value="%d" size=6> strand '
            '<input name=strand value="%d" size=2> <input type=submit>'
            "</form>" % (rid, strand)
        )
        in_graph = int((vt >= 0).sum())
        return (
            f"<h1>Marker coverage of read {rid}-{strand}</h1>" + form
            + f"<p>{hi - lo} markers, {in_graph} in marker graph vertices; "
            f"mean vertex coverage {cov.mean():.1f}.</p>" + _svg_series(cov)
        )

    def page_induced_alignment(self, q) -> str:
        """Induced alignment of two oriented reads through shared
        marker graph vertices (reference:
        exploreMarkerGraphInducedAlignment)."""
        mg = self.marker_graph
        if mg is None or self.markers is None:
            return "<p>Marker graph not available.</p>"
        r0, s0 = _ors(q, "readId0"), _ors(q, "strand0")
        r1, s1 = _ors(q, "readId1", "1"), _ors(q, "strand1")
        form = (
            '<form>Read0 <input name=readId0 value="%d" size=6> strand '
            '<input name=strand0 value="%d" size=2> Read1 '
            '<input name=readId1 value="%d" size=6> strand '
            '<input name=strand1 value="%d" size=2> <input type=submit>'
            "</form>" % (r0, s0, r1, s1)
        )
        from shasta_tpu_torch.graph.analysis import induced_alignment

        o0, o1 = induced_alignment(
            self.markers, mg, 2 * r0 + s0, 2 * r1 + s1
        )
        rows = [
            f"<h1>Induced alignment of {r0}-{s0} and {r1}-{s1}</h1>",
            form,
            f"<p>{o0.shape[0]} marker pairs share a vertex.</p>",
            "<table><tr><th>ordinal0</th><th>ordinal1</th></tr>",
        ]
        step = max(1, o0.shape[0] // 200)
        for i in range(0, o0.shape[0], step):
            rows.append(f"<tr><td>{int(o0[i])}</td><td>{int(o1[i])}</td></tr>")
        rows.append("</table>")
        return "".join(rows)

    def page_follow_read(self, q) -> str:
        """The chain of marker graph vertices visited by one oriented
        read (reference: followReadInMarkerGraph)."""
        mg = self.marker_graph
        if mg is None or self.markers is None:
            return "<p>Marker graph not available.</p>"
        rid = _ors(q, "readId")
        strand = _ors(q, "strand")
        orid = 2 * rid + strand
        moff = self.markers.offsets
        lo, hi = int(moff[orid]), int(moff[orid + 1])
        vt = mg.vertex_table[lo:hi]
        vcov = mg.vertex_coverage()
        form = (
            '<form>Read <input name=readId value="%d" size=6> strand '
            '<input name=strand value="%d" size=2> <input type=submit>'
            "</form>" % (rid, strand)
        )
        rows = [
            f"<h1>Read {rid}-{strand} in the marker graph</h1>", form,
            f"<p>{hi - lo} markers, {int((vt >= 0).sum())} in vertices.</p>",
            "<table><tr><th>ordinal</th><th>vertex</th><th>coverage</th></tr>",
        ]
        sel = np.flatnonzero(vt >= 0)
        step = max(1, sel.shape[0] // 300)
        for i in sel[::step]:
            v = int(vt[i])
            rows.append(
                f"<tr><td>{i}</td>"
                f"<td><a href='/markerGraph?vertexId={v}'>{v}</a></td>"
                f"<td>{int(vcov[v])}</td></tr>"
            )
        rows.append("</table>")
        return "".join(rows)

    def page_marker_connectivity(self, q) -> str:
        """Markers connected to one marker by shared vertices
        (reference: exploreMarkerConnectivity,
        src/MarkerConnectivityGraph.hpp)."""
        mg = self.marker_graph
        if mg is None or self.markers is None:
            return "<p>Marker graph not available.</p>"
        rid = _ors(q, "readId")
        strand = _ors(q, "strand")
        ordinal = _ors(q, "ordinal")
        orid = 2 * rid + strand
        moff = self.markers.offsets
        gm = int(moff[orid]) + ordinal
        form = (
            '<form>Read <input name=readId value="%d" size=6> strand '
            '<input name=strand value="%d" size=2> ordinal '
            '<input name=ordinal value="%d" size=6> <input type=submit>'
            "</form>" % (rid, strand, ordinal)
        )
        if not (moff[orid] <= gm < moff[orid + 1]):
            return form + "<p>Ordinal out of range.</p>"
        v = int(mg.vertex_table[gm])
        if v < 0:
            return (
                form
                + f"<p>Marker ({rid}-{strand}, {ordinal}) is not in any "
                "marker graph vertex.</p>"
            )
        members = mg.vertex_marker_ids(v)
        orids = np.searchsorted(moff, members, side="right") - 1
        rows = [
            f"<h1>Marker connectivity of ({rid}-{strand}, {ordinal})</h1>",
            form,
            f"<p>Vertex <a href='/markerGraph?vertexId={v}'>{v}</a>, "
            f"{members.shape[0]} connected markers.</p>",
            "<table><tr><th>oriented read</th><th>ordinal</th></tr>",
        ]
        for m, o in zip(members.tolist(), orids.tolist()):
            rows.append(
                f"<tr><td>{o >> 1}-{o & 1}</td><td>{m - int(moff[o])}</td></tr>"
            )
        rows.append("</table>")
        return "".join(rows)


class _AssemblyGraphViews:
    """Assembly-graph drill-down pages (reference:
    src/AssemblerHttpServer-AssemblyGraph.cpp)."""

    def page_assembly_graph_edge(self, q) -> str:
        """Segment detail (reference: exploreAssemblyGraphEdge)."""
        ag = self.assembly_graph
        if ag is None:
            return "<p>Assembly graph not available.</p>"
        eid = _ors(q, "edgeId")
        if not (0 <= eid < ag.edge_count):
            return f"<p>Edge id out of range (0..{ag.edge_count - 1}).</p>"
        chain = ag.chain(eid)
        parts = [
            f"<h1>Assembly graph edge (segment) {eid}</h1>", "<table>",
            f"<tr><th>marker graph edges</th><td>{chain.shape[0]}</td></tr>",
            f"<tr><th>source vertex</th><td>{int(ag.source_v[eid])}</td></tr>",
            f"<tr><th>target vertex</th><td>{int(ag.target_v[eid])}</td></tr>",
            f"<tr><th>reverse complement</th><td>{int(ag.rc_edge[eid])}</td></tr>",
            f"<tr><th>circular</th><td>{bool(ag.is_circular[eid])}</td></tr>",
            f"<tr><th>assembled copy</th><td>{ag.is_assembled_edge(eid)}</td></tr>",
        ]
        if ag.seg_raw_offsets is not None:
            seq = ag.raw_sequence(eid)
            parts.append(
                f"<tr><th>raw length</th><td>{seq.shape[0]}</td></tr>"
            )
        parts.append("</table>")
        head = ", ".join(str(int(x)) for x in chain[:40])
        parts.append(
            f"<p>Chain (first 40 marker graph edges): {head}"
            f"{' ...' if chain.shape[0] > 40 else ''}</p>"
        )
        if ag.seg_raw_offsets is not None:
            from shasta_tpu_torch.data import bases as B

            seq = ag.raw_sequence(eid)
            parts.append(
                f"<p>Sequence (first 1000):</p>"
                f"<pre>{B.decode_to_str(seq[:1000])}</pre>"
            )
        return "".join(parts)

    def page_assembly_graph_edges_support(self, q) -> str:
        """Oriented reads supporting a segment's chain (reference:
        exploreAssemblyGraphEdgesSupport)."""
        ag = self.assembly_graph
        mg = self.marker_graph
        if ag is None or mg is None or self.markers is None:
            return "<p>Assembly graph not available.</p>"
        eid = _ors(q, "edgeId")
        if not (0 <= eid < ag.edge_count):
            return f"<p>Edge id out of range (0..{ag.edge_count - 1}).</p>"
        chain = ag.chain(eid)
        moff = self.markers.offsets
        # Supporting oriented reads: markers of the chain's vertices.
        counts = {}
        for mge in chain.tolist():
            u = int(mg.source[mge])
            for gm in mg.vertex_marker_ids(u).tolist():
                orid = int(np.searchsorted(moff, gm, side="right") - 1)
                counts[orid] = counts.get(orid, 0) + 1
        rows = [
            f"<h1>Support of segment {eid}</h1>",
            f"<p>{chain.shape[0]} marker graph edges, "
            f"{len(counts)} supporting oriented reads.</p>",
            "<table><tr><th>oriented read</th><th>vertices visited</th>"
            "<th>fraction of chain</th></tr>",
        ]
        for orid, c in sorted(counts.items(), key=lambda kv: -kv[1])[:100]:
            rows.append(
                f"<tr><td>{orid >> 1}-{orid & 1}</td><td>{c}</td>"
                f"<td>{c / max(1, chain.shape[0]):.2f}</td></tr>"
            )
        rows.append("</table>")
        return "".join(rows)

    def page_compressed_assembly_graph(self, q) -> str:
        """Local view of the bubble-chain condensation (reference:
        exploreCompressedAssemblyGraph,
        src/AssemblerHttpServer-CompressedAssemblyGraph.cpp)."""
        ag = self.assembly_graph
        if ag is None:
            return "<p>Assembly graph not available.</p>"
        from shasta_tpu_torch.graph.analysis import compress_assembly_graph
        from shasta_tpu_torch.http.explore import _local_bfs, _svg_layered_graph

        cg = compress_assembly_graph(ag)
        start = _ors(q, "edgeId")
        dist = _ors(q, "maxDistance", "3")
        if cg.edge_count == 0:
            return "<p>Compressed assembly graph is empty.</p>"
        start = min(start, cg.edge_count - 1)
        by_v = {}
        for e in range(cg.edge_count):
            by_v.setdefault(int(cg.source_v[e]), []).append(e)
            by_v.setdefault(int(cg.target_v[e]), []).append(e)

        def neighbors(e):
            out = by_v.get(int(cg.target_v[e]), []) + by_v.get(
                int(cg.source_v[e]), []
            )
            return [x for x in out if x != e]

        levels, edges = _local_bfs(start, neighbors, dist)
        members = cg.members_of(start)
        return (
            f"<h1>Compressed assembly graph around edge {start}</h1>"
            f"<p>{cg.edge_count} compressed edges; edge {start} bundles "
            f"{members.shape[0]} assembly edges: "
            f"{', '.join(str(int(m)) for m in members[:30])}.</p>"
            + _svg_layered_graph(
                levels,
                edges,
                label_of=lambda e: f"{e} ({cg.members_of(e).shape[0]})",
                highlight=start,
            )
        )


def _force_layout(n: int, edges, iterations: int = 200, seed: int = 1):
    """Fruchterman-Reingold-style force layout in numpy (the TPU
    build's stand-in for the reference's neato/fruchterman_reingold
    layouts, mode3-LocalAssemblyGraph.cpp:1026-1090 +
    boost/graph/fruchterman_reingold.hpp). ``edges`` are
    (u, v, desired_length) springs; all-pairs repulsion keeps
    non-adjacent components apart. Deterministic per seed."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0.0, 1.0, (n, 2))
    if not edges:
        return pos
    eu = np.array([e[0] for e in edges], np.int64)
    ev = np.array([e[1] for e in edges], np.int64)
    el = np.array([e[2] for e in edges], np.float64)
    k = float(np.mean(el))
    pos *= k
    for it in range(iterations):
        d = pos[:, None, :] - pos[None, :, :]
        dist2 = (d * d).sum(-1)
        np.fill_diagonal(dist2, np.inf)
        rep = (k * k / dist2)[:, :, None] * d / np.sqrt(dist2)[:, :, None]
        disp = np.nan_to_num(rep).sum(1)
        dv = pos[eu] - pos[ev]
        dist = np.sqrt((dv * dv).sum(-1)) + 1e-9
        f = ((dist - el) / dist)[:, None] * dv  # spring toward length
        np.subtract.at(disp, eu, f)
        np.add.at(disp, ev, f)
        t = 0.12 * k * (1.0 - it / iterations) + 1e-3
        norm = np.sqrt((disp * disp).sum(-1)) + 1e-9
        pos = pos + disp / norm[:, None] * np.minimum(norm, t)[:, None]
    return pos


class _Mode3Views:
    """Mode 3 assembly pages (reference:
    src/AssemblerHttpServer-Mode3.cpp)."""

    def _mode3(self):
        if getattr(self, "_mode3_cache", None) is None:
            from shasta_tpu_torch.graph.mode3 import Mode3Graph

            def load():
                arrays = dict(self.store.load_stage("Mode3"))
                self._mode3_clusters = arrays.pop("cluster_id", None)
                self._mode3_jclusters = arrays.pop("jaccard_cluster_id", None)
                return Mode3Graph.from_arrays(arrays)

            self._mode3_cache = self._soft(load)
        return self._mode3_cache

    def page_mode3(self, q) -> str:
        """Local mode-3 segment/link graph, drawn the way the
        reference's mode3::LocalAssemblyGraph does (reference:
        mode3-LocalAssemblyGraph.cpp:513-1100): segments are thick
        length-proportional lines positioned by a force-directed
        layout (own Fruchterman-Reingold pass — the TPU build has no
        graphviz), links are cubic Bezier curves with
        coverage-proportional thickness, and segments are colored by
        raw Jaccard similarity to the start segment. ``layout=layered``
        falls back to the BFS-column view."""
        m3 = self._mode3()
        if m3 is None:
            return "<p>Mode 3 data not available (mode-3 runs only).</p>"
        from shasta_tpu_torch.http.explore import _local_bfs, _svg_layered_graph

        start = _ors(q, "segmentId")
        dist = _ors(q, "maxDistance", "3")
        layout = q.get("layout", ["force"])[0]
        if not (0 <= start < m3.segment_count):
            return f"<p>Segment id out of range (0..{m3.segment_count - 1}).</p>"
        by_s = {}
        for i in range(m3.link_count):
            by_s.setdefault(int(m3.link_source[i]), []).append(
                int(m3.link_target[i])
            )
            by_s.setdefault(int(m3.link_target[i]), []).append(
                int(m3.link_source[i])
            )
        levels, edges = _local_bfs(start, lambda v: by_s.get(v, []), dist)
        # Color-by options (reference: LocalAssemblyGraph::SvgOptions
        # segmentColoring choices, mode3-LocalAssemblyGraph.cpp:821-868).
        color_by = q.get("colorBy", ["jaccard"])[0]
        legend = {
            "jaccard": f"raw Jaccard similarity with segment {start}",
            "commonCount": f"common oriented reads with segment {start}",
            "coverage": "average oriented-read coverage",
        }.get(color_by, "raw Jaccard similarity")
        header = (
            f"<h1>Mode 3 assembly graph around segment {start}</h1>"
            f"<p>{m3.segment_count} segments, {m3.link_count} links. "
            f"Segment color = {legend} "
            f"(red = start, green/dark = high, grey = low/none); "
            f"link thickness = transition coverage. "
            f'<a href="?segmentId={start}&maxDistance={dist}'
            f'&layout=layered">layered view</a></p>'
            f"<form>Segment <input name=segmentId value={start} size=8> "
            f"Max distance <input name=maxDistance value={dist} size=4> "
            f"Color by <select name=colorBy>"
            + "".join(
                f"<option value={v}{' selected' if v == color_by else ''}>"
                f"{v}</option>"
                for v in ("jaccard", "commonCount", "coverage")
            )
            + "</select> <input type=submit></form>"
        )
        svg = None
        if layout != "layered":
            svg = self._mode3_force_svg(
                m3, start, levels, edges, color_by=color_by
            )
        if svg is None:  # layered requested, or force budget exceeded
            svg = _svg_layered_graph(levels, edges, highlight=start)
        return header + svg

    def _mode3_force_svg(self, m3, start, levels, edges, color_by="jaccard"):
        """The laid-out view: segments as length-proportional bars with
        Jaccard coloring and coverage-thick links (reference:
        LocalAssemblyGraph::computeLayout + writeSvg,
        mode3-LocalAssemblyGraph.cpp:513-1090; rendering shared with
        the mode-0 view via explore._svg_segment_graph)."""
        from shasta_tpu_torch.http.explore import _svg_segment_graph

        segs = sorted({v for level in levels for v in level})
        # Per-segment color metric vs the start segment (reference:
        # SvgOptions segmentColoring). ``metric`` holds the RAW value
        # for the tooltip; ``norm`` its [0, 1] normalization for color.
        metric = {}
        norm = {}
        label = "rawJaccard"
        fmt = "{:.2f}"
        try:
            from shasta_tpu_torch.graph.mode3_path import Mode3Connectivity

            conn = getattr(self, "_mode3_conn_cache", None)
            if conn is None:
                conn = Mode3Connectivity(m3, self.marker_graph, self.markers)
                self._mode3_conn_cache = conn
            if color_by == "coverage":
                label = "oriented reads"
                fmt = "{:.0f}"
                for s in segs:
                    metric[s] = float(conn.segment_orids(s).shape[0])
                    norm[s] = min(1.0, metric[s] / 60.0)
            elif color_by == "commonCount":
                label = "common reads"
                fmt = "{:.0f}"
                n0 = max(1, conn.segment_orids(start).shape[0])
                for s in segs:
                    if s != start:
                        info = conn.analyze_segment_pair(start, s)
                        metric[s] = float(info.common_count)
                        norm[s] = min(1.0, metric[s] / n0)
            else:
                for s in segs:
                    if s != start:
                        info = conn.analyze_segment_pair(start, s)
                        metric[s] = conn.raw_jaccard(info)
                        norm[s] = metric[s]
        except Exception:
            pass

        def seg_color(s):
            j = norm.get(s)
            if j is None:
                return "#999"
            g = int(100 + 155 * min(1.0, max(0.0, j)))
            return f"rgb(60,{g},80)"

        def seg_title(s):
            if s not in metric:
                return ""
            return f", {label} {fmt.format(metric[s])}"

        covs = [
            int(m3.transition_offsets[li + 1] - m3.transition_offsets[li])
            for li in range(m3.link_count)
        ]
        maxcov = max(covs) if covs else 1

        def link_info(u, v):
            # The BFS edge list carries both orientations of every
            # adjacency; only real source->target links draw.
            li = self._find_m3_link(m3, u, v)
            if li is None:
                return None
            cov = covs[li]
            return (1.0 + 3.0 * cov / max(1, maxcov), f"link coverage {cov}")

        return _svg_segment_graph(
            levels,
            edges,
            seg_len=lambda s: int(m3.ag.chain(s).shape[0]),
            seg_color=seg_color,
            highlight=start,
            href="mode3Segment?segmentId=",
            link_info=link_info,
            seg_title=seg_title,
        )

    @staticmethod
    def _find_m3_link(m3, u, v):
        sel = np.flatnonzero((m3.link_source == u) & (m3.link_target == v))
        return int(sel[0]) if sel.shape[0] else None

    def page_mode3_segment(self, q) -> str:
        """Segment detail (reference: exploreMode3AssemblyGraphSegment)."""
        m3 = self._mode3()
        if m3 is None:
            return "<p>Mode 3 data not available.</p>"
        sid = _ors(q, "segmentId")
        if not (0 <= sid < m3.segment_count):
            return f"<p>Segment id out of range.</p>"
        chain = m3.ag.chain(sid)
        ins = np.flatnonzero(m3.link_target == sid)
        outs = np.flatnonzero(m3.link_source == sid)
        # Oriented reads visiting this segment (from journeys).
        js = m3.journey_segments
        jo = m3.journey_offsets
        hits = np.flatnonzero(js == sid)
        orids = np.searchsorted(jo, hits, side="right") - 1
        parts = [
            f"<h1>Mode 3 segment {sid}</h1>", "<table>",
            f"<tr><th>marker graph edges</th><td>{chain.shape[0]}</td></tr>",
            f"<tr><th>oriented reads</th><td>{np.unique(orids).shape[0]}</td></tr>",
        ]
        if getattr(self, "_mode3_clusters", None) is not None:
            parts.append(
                f"<tr><th>cluster</th><td>{int(self._mode3_clusters[sid])}</td></tr>"
            )
        parts.append("</table>")
        parts.append(
            "<h2>Links</h2><table><tr><th>link</th><th>dir</th>"
            "<th>other segment</th><th>coverage</th></tr>"
        )
        for i in outs.tolist():
            parts.append(
                f"<tr><td><a href='/mode3Link?linkId={i}'>{i}</a></td>"
                f"<td>out</td><td>{int(m3.link_target[i])}</td>"
                f"<td>{int(m3.link_coverage[i])}</td></tr>"
            )
        for i in ins.tolist():
            parts.append(
                f"<tr><td><a href='/mode3Link?linkId={i}'>{i}</a></td>"
                f"<td>in</td><td>{int(m3.link_source[i])}</td>"
                f"<td>{int(m3.link_coverage[i])}</td></tr>"
            )
        parts.append("</table>")
        return "".join(parts)

    def page_mode3_link(self, q) -> str:
        """Link detail with transitions (reference:
        exploreMode3AssemblyGraphLink)."""
        m3 = self._mode3()
        if m3 is None:
            return "<p>Mode 3 data not available.</p>"
        lid = _ors(q, "linkId")
        if not (0 <= lid < m3.link_count):
            return f"<p>Link id out of range (0..{m3.link_count - 1}).</p>"
        parts = [
            f"<h1>Mode 3 link {lid}</h1>", "<table>",
            f"<tr><th>source</th><td><a href='/mode3Segment?segmentId="
            f"{int(m3.link_source[lid])}'>{int(m3.link_source[lid])}</a></td></tr>",
            f"<tr><th>target</th><td><a href='/mode3Segment?segmentId="
            f"{int(m3.link_target[lid])}'>{int(m3.link_target[lid])}</a></td></tr>",
            f"<tr><th>coverage</th><td>{int(m3.link_coverage[lid])}</td></tr>",
        ]
        if m3.link_adjacent is not None:
            parts.append(
                f"<tr><th>segments adjacent</th>"
                f"<td>{bool(m3.link_adjacent[lid])}</td></tr>"
            )
            parts.append(
                f"<tr><th>separation</th>"
                f"<td>{int(m3.link_separation[lid])}</td></tr>"
            )
        parts.append("</table>")
        if m3.transition_offsets is not None:
            lo = int(m3.transition_offsets[lid])
            hi = int(m3.transition_offsets[lid + 1])
            parts.append(
                "<h2>Transitions</h2><table><tr><th>oriented read</th>"
                "<th>exit position</th><th>exit ordinal</th>"
                "<th>entry position</th><th>entry ordinal</th></tr>"
            )
            for t in range(lo, hi):
                orid = int(m3.t_orid[t])
                parts.append(
                    f"<tr><td>{orid >> 1}-{orid & 1}</td>"
                    f"<td>{int(m3.t_pos0[t])}</td><td>{int(m3.t_ord0[t])}</td>"
                    f"<td>{int(m3.t_pos1[t])}</td><td>{int(m3.t_ord1[t])}</td>"
                    "</tr>"
                )
            parts.append("</table>")
        return "".join(parts)

    def page_mode3_segment_pair(self, q) -> str:
        """Segment pair analysis (reference:
        exploreMode3AssemblyGraphSegmentPair)."""
        m3 = self._mode3()
        if m3 is None:
            return "<p>Mode 3 data not available.</p>"
        s0 = _ors(q, "segmentId0")
        s1 = _ors(q, "segmentId1", "1")
        form = (
            '<form>Segment0 <input name=segmentId0 value="%d" size=8> '
            'Segment1 <input name=segmentId1 value="%d" size=8> '
            "<input type=submit></form>" % (s0, s1)
        )
        if not (0 <= s0 < m3.segment_count and 0 <= s1 < m3.segment_count):
            return form + "<p>Segment ids out of range.</p>"
        from shasta_tpu_torch.graph.mode3 import (
            analyze_segment_pair,
            segment_oriented_read_infos,
        )

        if getattr(self, "_mode3_infos", None) is None:
            self._mode3_infos = segment_oriented_read_infos(
                m3, self.marker_graph
            )
        info_offsets, info_orids, info_avg, seg_lengths = self._mode3_infos
        read_marker_counts = np.diff(self.markers.offsets)
        info = analyze_segment_pair(
            s0, s1, info_offsets, info_orids, info_avg, seg_lengths,
            read_marker_counts,
        )
        rows = [f"<h1>Mode 3 segment pair {s0}, {s1}</h1>", form, "<table>"]
        for name in (
            "total_count", "common_count", "offset",
            "unexplained_count", "short_count",
        ):
            rows.append(
                f"<tr><th>{name}</th><td>{getattr(info, name)}</td></tr>"
            )
        rows.append(f"<tr><th>jaccard</th><td>{info.jaccard():.3f}</td></tr>")
        rows.append(
            "<tr><th>max unexplained fraction</th>"
            f"<td>{info.maximum_unexplained_fraction():.3f}</td></tr>"
        )
        rows.append("</table>")
        return "".join(rows)

    def page_mode3_meta_alignment(self, q) -> str:
        """Meta-alignment of two oriented reads' segment journeys
        (reference: exploreMode3MetaAlignment)."""
        m3 = self._mode3()
        if m3 is None:
            return "<p>Mode 3 data not available.</p>"
        r0, s0 = _ors(q, "readId0"), _ors(q, "strand0")
        r1, s1 = _ors(q, "readId1", "1"), _ors(q, "strand1")
        form = (
            '<form>Read0 <input name=readId0 value="%d" size=6> strand '
            '<input name=strand0 value="%d" size=2> Read1 '
            '<input name=readId1 value="%d" size=6> strand '
            '<input name=strand1 value="%d" size=2> <input type=submit>'
            "</form>" % (r0, s0, r1, s1)
        )
        j0 = m3.journey(2 * r0 + s0)
        j1 = m3.journey(2 * r1 + s1)
        common = set(j0.tolist()) & set(j1.tolist())
        rows = [
            f"<h1>Meta-alignment of {r0}-{s0} and {r1}-{s1}</h1>", form,
            f"<p>Journeys: {j0.shape[0]} and {j1.shape[0]} segments, "
            f"{len(common)} shared.</p>",
            "<table><tr><th>position0</th><th>position1</th>"
            "<th>segment</th></tr>",
        ]
        pos1 = {int(s): i for i, s in enumerate(j1.tolist())}
        for i, s in enumerate(j0.tolist()):
            if s in common:
                rows.append(
                    f"<tr><td>{i}</td><td>{pos1.get(int(s), '')}</td>"
                    f"<td><a href='/mode3Segment?segmentId={s}'>{s}</a></td>"
                    "</tr>"
                )
        rows.append("</table>")
        return "".join(rows)

    def page_mode3_assembly_path(self, q) -> str:
        """Assembly path starting at a segment (reference:
        exploreMode3AssemblyPath)."""
        m3 = self._mode3()
        if m3 is None:
            return "<p>Mode 3 data not available.</p>"
        sid = _ors(q, "segmentId")
        form = (
            '<form>Start segment <input name=segmentId value="%d" size=8> '
            "<input type=submit value=Walk></form>" % sid
        )
        if not (0 <= sid < m3.segment_count):
            return form + "<p>Segment id out of range.</p>"
        from shasta_tpu_torch.graph.mode3_path import (
            Mode3Connectivity,
            create_assembly_path,
        )

        conn = Mode3Connectivity(m3, self.marker_graph, self.markers)
        back = create_assembly_path(conn, sid, 1)
        fwd = create_assembly_path(conn, sid, 0)
        segments = back[::-1] + fwd[1:]
        rows = [
            f"<h1>Mode 3 assembly path through segment {sid}</h1>", form,
            f"<p>{len(segments)} path segments.</p>",
            "<table><tr><th>position</th><th>segment</th>"
            "<th>primary</th></tr>",
        ]
        for i, p in enumerate(segments):
            rows.append(
                f"<tr><td>{i}</td><td><a href='/mode3Segment?segmentId="
                f"{p.id}'>{p.id}</a></td>"
                f"<td>{p.is_primary}</td></tr>"
            )
        rows.append("</table>")
        return "".join(rows)

    def page_mode3_link_assembly(self, q) -> str:
        """Link assembly detail (reference: exploreMode3LinkAssembly):
        how the sequence across a link would be assembled."""
        m3 = self._mode3()
        if m3 is None:
            return "<p>Mode 3 data not available.</p>"
        lid = _ors(q, "linkId")
        if not (0 <= lid < m3.link_count):
            return f"<p>Link id out of range (0..{m3.link_count - 1}).</p>"
        parts = [f"<h1>Mode 3 link {lid} assembly</h1>"]
        adj = (
            bool(m3.link_adjacent[lid])
            if m3.link_adjacent is not None
            else None
        )
        if adj:
            parts.append(
                "<p>Segments are adjacent in the marker graph: the link "
                "contributes no extra sequence (trivial link).</p>"
            )
        else:
            sep = (
                int(m3.link_separation[lid])
                if m3.link_separation is not None
                else 0
            )
            lo = hi = 0
            if m3.transition_offsets is not None:
                lo = int(m3.transition_offsets[lid])
                hi = int(m3.transition_offsets[lid + 1])
            parts.append(
                f"<p>Non-trivial link, separation {sep}, {hi - lo} "
                "transitions: link sequence is assembled by MSA of the "
                "transition reads between their exit and entry ordinals "
                "(see PathAssembler._assemble_nontrivial_link).</p>"
            )
            if hi > lo:
                parts.append(
                    "<table><tr><th>oriented read</th><th>exit ordinal</th>"
                    "<th>entry ordinal</th><th>span</th></tr>"
                )
                for t in range(lo, hi):
                    orid = int(m3.t_orid[t])
                    o0, o1 = int(m3.t_ord0[t]), int(m3.t_ord1[t])
                    parts.append(
                        f"<tr><td>{orid >> 1}-{orid & 1}</td><td>{o0}</td>"
                        f"<td>{o1}</td><td>{o1 - o0}</td></tr>"
                    )
                parts.append("</table>")
        return "".join(parts)
