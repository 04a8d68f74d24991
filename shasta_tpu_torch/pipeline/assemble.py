"""The end-to-end assembly pipeline, modes 0, 2 and 3.

Counterpart of ``shasta_tpu/pipeline/assemble.py``: the stage-by-stage
``Assembler`` API and ``run_assembly`` (reference: srcMain/main.cpp:516-830,
mode0Assembly at :845-1045, mode2Assembly at :1049 and mode3Assembly at
:1116), addReads through the GFA/FASTA output.
Every stage persists its outputs to the run directory's stage store in
the JAX package's ``Data/`` format, so a run directory written by either
package can be reattached by the other
(``cls.from_arrays(store.load_stage(name))`` for each stage).

The alignment DP runs on the ``device`` (CUDA kernels, or their plain
PyTorch version on the CPU): method 3's engine, method 4's grouped
route and the palindrome pass. Methods 0 and 1, iterative assembly and
every other stage are host code (numpy and the native library), as in
the JAX package.

With a ``mesh`` (``parallel/mesh.py``: one rank of a torch.distributed
world, every rank running this pipeline) the collective-bearing stages
run sharded over the ranks: the LowHash bucket exchange, the alignment
batches and the union-find hooking rounds, with output identical to one
device.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from shasta_tpu_torch.data.kmers import LAST_BUILD, KmerTable, select_kmers_random
from shasta_tpu_torch.data.markers import MarkerStore, find_markers
from shasta_tpu_torch.data.reads import ReadStore, build_read_store
from shasta_tpu_torch.data.store import RunStore
from shasta_tpu_torch.graph import assembly_graph as AG
from shasta_tpu_torch.graph import marker_graph as MG
from shasta_tpu_torch.graph import read_graph as RG
from shasta_tpu_torch.io import fasta as FIO
from shasta_tpu_torch.ops import lowhash as LH
from shasta_tpu_torch.ops.align import COLLECT, AlignParams, AlignmentStore, align_candidates
from shasta_tpu_torch.ops.align_kernel import resolve_device
from shasta_tpu_torch.pipeline.config import AssemblyConfig
from shasta_tpu_torch.utils.perf import PerformanceLog, malloc_trim, span
from shasta_tpu_torch.consensus.caller import get_consensus_caller


def _same_device(a, b) -> bool:
    """Whether two devices are one ("cuda" names the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    import torch

    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def auto_min_coverage(
    coverage_histogram: np.ndarray,
    fallback: int = 5,
    min_area_fraction: float = 0.08,
    area_start_index: int = 2,
) -> int:
    """Pick MarkerGraph.minCoverage from the disjoint-sets coverage
    histogram when the configured value is 0 (reference: PeakFinder
    topographic prominence, src/PeakFinder.cpp, used at
    src/AssemblerMarkerGraph.cpp:230-250); falls back to 5 like the
    reference when no significant peak exists."""
    from shasta_tpu_torch.utils.peakfinder import PeakFinderException, find_x_cutoff

    h = np.asarray(coverage_histogram, dtype=np.float64)
    try:
        return max(
            2,
            find_x_cutoff(
                h,
                min_area_fraction=min_area_fraction,
                area_start_index=area_start_index,
            ),
        )
    except PeakFinderException:
        return fallback


class Assembler:
    """Holds pipeline state; method names mirror the reference's
    Assembler stages (reference: src/Assembler.hpp).

    ``device`` is where the alignment engine runs: "cuda" by default
    (the CUDA kernels; raises when there is no card), or "cpu" (the
    plain PyTorch version). The host stages are numpy either way.

    ``mesh``: a :class:`~shasta_tpu_torch.parallel.mesh.Mesh`, under which
    the collective-bearing stages (LowHash bucket all-to-all, alignment
    batches, union-find hooking rounds) run sharded over its ranks (the
    counterpart of the reference's thread pool, reference:
    src/MultithreadedObject.hpp:33-99); output is identical to the
    single-device path. The rank's device is then the mesh's, and a
    ``device`` given beside it must be that one."""

    def __init__(
        self,
        run_dir: str,
        config: Optional[AssemblyConfig] = None,
        device=None,
        mesh=None,
    ):
        if mesh is None:
            self.device = resolve_device("cuda" if device is None else device)
        else:
            self.device = mesh.device
            if device is not None and not _same_device(resolve_device(device), mesh.device):
                raise ValueError(
                    f"device={device!r} differs from the mesh's device {mesh.device}"
                )
        self.mesh = mesh
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.store = RunStore(run_dir)
        self.config = config or AssemblyConfig()
        self.log = PerformanceLog(os.path.join(run_dir, "performance.log"))

        self.reads: Optional[ReadStore] = None
        self.kmer_table = None
        self.markers: Optional[MarkerStore] = None
        self.candidates: Optional[LH.CandidatePairs] = None
        self.alignments: Optional[AlignmentStore] = None
        self.read_graph: Optional[RG.ReadGraph] = None
        self.marker_graph: Optional[MG.MarkerGraph] = None
        self.assembly_graph: Optional[AG.AssemblyGraph] = None
        self.vertex_repeats: Optional[np.ndarray] = None
        self.edge_consensus: Optional[AG.EdgeConsensus] = None
        self.min_coverage_used: int = 0
        # Actionable post-stage diagnoses (reference:
        # scripts/GenerateFeedback.py run after an assembly); surfaced
        # in the log as WARNINGs and in AssemblySummary.json.
        self.feedback: List[str] = []
        self.lowhash_stats: Dict = {}
        self.log.memprobe = self._memory_inventory

    _MEM_STORES = (
        "reads", "markers", "candidates", "alignments", "read_graph",
        "marker_graph", "assembly_graph", "vertex_repeats",
        "edge_consensus", "mode2_graph",
    )

    def _memory_inventory(self) -> str:
        """Array bytes held per pipeline store (SHASTA_TORCH_MEMPROF)."""
        from shasta_tpu_torch.utils.perf import obj_nbytes

        parts = []
        for name in self._MEM_STORES:
            nb = obj_nbytes(getattr(self, name, None))
            if nb > (1 << 20):
                parts.append((nb, f"{name}={nb / 2**20:.0f}MB"))
        parts.sort(key=lambda x: -x[0])
        return " ".join(p for _, p in parts)

    def test(self) -> bool:
        """Built-in self-test (reference: Assembler::test via
        scripts/Test.py, src/Assembler.hpp:2429): quick in-memory
        checks of the core invariants — union-find convergence versus
        a sequential oracle, reverse-complement involution, compressed
        alignment round-trip, and a tiny end-to-end strand-symmetric
        marker graph."""
        import numpy as np

        rng = np.random.default_rng(0)

        # Union-find stress vs a sequential DSU oracle.
        n = 2000
        u = rng.integers(0, n, 5000)
        v = rng.integers(0, n, 5000)
        label = MG.union_find_labels(n, u, v)
        parent = list(range(n))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b in zip(u.tolist(), v.tolist()):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        oracle = np.array([find(x) for x in range(n)])
        # Components must partition identically.
        _, la = np.unique(label, return_inverse=True)
        _, lb = np.unique(oracle, return_inverse=True)
        assert np.array_equal(la, lb), "union-find mismatch"

        # Reverse complement involution.
        from shasta_tpu_torch.data.kmers import reverse_complement_kmers

        for k in (4, 8, 12, 15):
            ids = rng.integers(0, 1 << (2 * k), 10000).astype(np.uint32)
            rc2 = reverse_complement_kmers(
                reverse_complement_kmers(ids, k), k
            )
            assert np.array_equal(rc2, ids), f"rc involution failed at k={k}"

        # Compressed alignment round-trip.
        from shasta_tpu_torch.data.compress_alignment import (
            compress_alignment,
            decompress_alignment,
        )

        o1 = np.sort(rng.choice(5000, 800, replace=False)).astype(np.uint32)
        o0 = (o1 + rng.integers(0, 50)).astype(np.uint32)
        r0, r1 = decompress_alignment(compress_alignment(o0, o1))
        assert np.array_equal(r0, o0) and np.array_equal(r1, o1)

        return True

    # ----- stages -----

    def add_reads(self, input_files: List[str]) -> None:
        with self.log.stage("addReads"):
            parsed_list = [FIO.parse_file(p) for p in input_files]
            merged = FIO.merge_parsed(parsed_list) if len(parsed_list) > 1 else parsed_list[0]
            self.reads = build_read_store(
                merged,
                min_read_length=self.config.reads.min_read_length,
                representation=self.config.reads.representation,
            )
            if self.config.reads.desired_coverage > 0:
                from shasta_tpu_torch.data.reads import apply_desired_coverage

                before = self.reads.read_count
                self.reads = apply_desired_coverage(
                    self.reads, self.config.reads.desired_coverage
                )
                self.log.line(
                    f"Coverage adjustment kept {self.reads.read_count} of "
                    f"{before} reads."
                )
            self.store.save_stage("Reads", self.reads.arrays())
            # ReadLengthHistogram.csv (reference: srcMain/main.cpp:561).
            lens = self.reads.raw_lengths
            if lens.shape[0]:
                hist = np.bincount(lens // 1000)
                with open(
                    os.path.join(self.run_dir, "ReadLengthHistogram.csv"), "w"
                ) as f:
                    f.write("LengthKb,Frequency\n")
                    for i, c in enumerate(hist):
                        if c:
                            f.write(f"{i},{c}\n")

    @property
    def kmer_table(self) -> Optional[KmerTable]:
        """The k-mer table. Every table set here is given the run's
        device, where its downsampling hash table is built."""
        return self._kmer_table

    @kmer_table.setter
    def kmer_table(self, table: Optional[KmerTable]) -> None:
        if table is not None:
            table.device = self.device
        self._kmer_table = table

    def select_kmers(self) -> None:
        ck = self.config.kmers
        with self.log.stage("selectKmers"):
            method = ck.generation_method
            if method == 0:
                self.kmer_table = select_kmers_random(
                    ck.k, ck.probability, seed=ck.seed
                )
            elif method == 1:
                from shasta_tpu_torch.data.kmers import select_kmers_frequency

                self.kmer_table = select_kmers_frequency(
                    self.reads, ck.k, ck.probability, seed=ck.seed,
                    enrichment_threshold=ck.enrichment_threshold,
                )
            elif method == 2:
                from shasta_tpu_torch.data.kmers import select_kmers_2

                self.kmer_table = select_kmers_2(
                    self.reads, ck.k, ck.probability, seed=ck.seed,
                    enrichment_threshold=ck.enrichment_threshold,
                )
            elif method == 3:
                # K-mers from a file, one sequence per line
                # (reference: --Kmers.file).
                from shasta_tpu_torch.data import bases as B2
                from shasta_tpu_torch.data.kmers import select_kmers_from_ids
                from shasta_tpu_torch.data.markers import rolling_kmers_flat

                ids = []
                with open(ck.file) as f:
                    for line in f:
                        seq = line.strip().upper()
                        if len(seq) == ck.k:
                            codes = B2.encode_str(seq)
                            ids.append(int(rolling_kmers_flat(codes, ck.k)[0]))
                self.kmer_table = select_kmers_from_ids(ck.k, np.array(ids))
            elif method == 4:
                from shasta_tpu_torch.data.kmers import select_kmers_4

                self.kmer_table = select_kmers_4(
                    self.reads, ck.k, ck.probability, seed=ck.seed,
                    distance_threshold=ck.distance_threshold,
                )
            else:
                raise ValueError(f"Unsupported Kmers.generationMethod {method}")
            self.store.save_stage("Kmers", self.kmer_table.arrays())

    def find_markers(self) -> None:
        with self.log.stage("findMarkers"):
            self.markers = find_markers(self.reads, self.kmer_table)
            self.store.save_stage("Markers", self.markers.arrays())

    def flag_palindromic_reads(self) -> None:
        from shasta_tpu_torch.ops.palindrome import flag_palindromic_reads

        cr = self.config.reads
        with self.log.stage("flagPalindromicReads"):
            if cr.palindromic_reads_skip_flagging:
                self.reads.is_palindromic = np.zeros(
                    self.reads.read_count, dtype=bool
                )
                return
            self.reads.is_palindromic = flag_palindromic_reads(
                self.markers,
                aligned_fraction_threshold=(
                    cr.palindromic_reads_aligned_fraction_threshold
                ),
                near_diagonal_fraction_threshold=(
                    cr.palindromic_reads_near_diagonal_fraction_threshold
                ),
                delta_threshold=cr.palindromic_reads_delta_threshold,
                device=self.device,
            )

    def find_alignment_candidates(self) -> None:
        cm = self.config.min_hash
        with self.log.stage("findAlignmentCandidatesLowHash"):
            params = LH.LowHashParams(
                m=cm.m,
                hash_fraction=cm.hash_fraction,
                iteration_count=cm.min_hash_iteration_count,
                log2_bucket_count=cm.log2_min_hash_bucket_count,
                min_bucket_size=cm.min_bucket_size,
                max_bucket_size=cm.max_bucket_size,
                min_frequency=cm.min_frequency,
            )
            lh_stats: Dict = {}
            if cm.all_pairs:
                # MinHash.allPairs: every read pair on both relative
                # strands, skipping LowHash (reference:
                # AssemblerHttpServer/computeAllAlignments semantics
                # for tiny runs).
                self.candidates = LH.all_pairs_candidates(
                    self.reads.read_count, self.reads.is_palindromic
                )
            elif self.mesh is not None and cm.version == 0:
                # (A 1-rank mesh runs the same sharded code, so a single
                # card's mesh run exercises this path.) LowHash buckets
                # exchanged via all-to-all (reference analog: the
                # shared-memory bucket fill, src/LowHash0.cpp:169-182).
                # Produces the identical candidate set as the host path.
                from shasta_tpu_torch.parallel.mesh import sharded_find_candidates

                self.candidates = sharded_find_candidates(
                    self.mesh, self.markers, params, self.reads.is_palindromic
                )
            elif cm.version == 1:
                # LowHash1: records common-feature ordinals per
                # candidate (reference: AssemblerLowHash.cpp:137).
                with_ords = LH.find_candidates_lowhash1(
                    self.markers, params, self.reads.is_palindromic
                )
                self.candidates = with_ords.pairs
                self.store.save_stage(
                    "CandidateFeatureOrdinals",
                    {
                        "ord0": with_ords.feature_ord0,
                        "ord1": with_ords.feature_ord1,
                        "offsets": with_ords.feature_offsets,
                    },
                )
            else:
                self.candidates = LH.find_candidates_lowhash(
                    self.markers, params, self.reads.is_palindromic, lh_stats,
                    device=self.device,
                )
            if (
                not cm.all_pairs
                and cm.alignment_candidates_per_read > 0
                and self.candidates.count
                > cm.alignment_candidates_per_read * self.reads.read_count
            ):
                # MinHash.alignmentCandidatesPerRead: cap the global
                # candidate budget like the reference's early stop
                # (reference: LowHash0.cpp candidate-count stopping
                # criterion), keeping the highest-frequency pairs.
                keep_n = int(
                    cm.alignment_candidates_per_read * self.reads.read_count
                )
                before = self.candidates.count
                self.candidates = LH.cap_candidates(self.candidates, keep_n)
                self.log.line(
                    f"Candidate cap kept {self.candidates.count} of "
                    f"{before} (alignmentCandidatesPerRead)."
                )
            if "bucket_histogram" in lh_stats:
                with open(
                    os.path.join(self.run_dir, "LowHashBucketHistogram.csv"), "w"
                ) as f:
                    f.write("BucketSize,Frequency\n")
                    for sz, n in enumerate(lh_stats["bucket_histogram"]):
                        if n:
                            f.write(f"{sz},{n}\n")
                rs = lh_stats["read_stats"]
                with open(
                    os.path.join(self.run_dir, "ReadLowHashStatistics.csv"), "w"
                ) as f:
                    f.write("ReadId,Strand,Sparse,Good,Crowded\n")
                    for orid in range(rs.shape[0]):
                        f.write(
                            f"{orid >> 1},{orid & 1},{rs[orid,0]},"
                            f"{rs[orid,1]},{rs[orid,2]}\n"
                        )
            delta = self.config.align.same_channel_read_alignment_suppress_delta_threshold
            if delta > 0:
                before = self.candidates.count
                self.candidates = LH.suppress_alignment_candidates(
                    self.reads.metadata, self.candidates, delta
                )
                self.log.line(
                    f"Suppressed {before - self.candidates.count} "
                    "same-channel candidates."
                )
            self.store.save_stage("AlignmentCandidates", self.candidates.arrays())
            # Starvation check: the reference records per-read LowHash
            # statistics (src/LowHash0.cpp:57) and its feedback script
            # flags runs whose MinHash phase starved
            # (scripts/GenerateFeedback.py:72-77); act on it here
            # instead of only recording the CSV.
            fb_msgs, self.lowhash_stats = LH.candidate_feedback(
                self.candidates,
                self.reads.read_count,
                cm.m,
                self.reads.is_palindromic,
            )
            for msg in fb_msgs:
                self.log.line("WARNING: " + msg)
                # stderr: the assemble CLI's stdout carries the
                # summary JSON.
                print("WARNING: " + msg, file=sys.stderr, flush=True)
            self.feedback.extend(fb_msgs)

    def compute_alignments(self) -> None:
        from shasta_tpu_torch.parallel.context import use_mesh

        ca = self.config.align
        with self.log.stage("computeAlignments"), use_mesh(self.mesh):
            params = AlignParams(
                match_score=ca.match_score,
                mismatch_score=ca.mismatch_score,
                gap_score=ca.gap_score,
                downsampling_factor=ca.downsampling_factor,
                band_extend=ca.band_extend,
                max_band=ca.max_band,
                min_aligned_marker_count=ca.min_aligned_marker_count,
                min_aligned_fraction=ca.min_aligned_fraction,
                max_skip=ca.max_skip,
                max_drift=ca.max_drift,
                max_trim=ca.max_trim,
                suppress_containments=ca.suppress_containments,
            )
            if ca.align_method in (0, 1):
                # Legacy/debug methods, host implementation.
                from shasta_tpu_torch.ops.align_other import align_candidates_method

                self.alignments = align_candidates_method(
                    self.markers,
                    self.candidates.read_id0,
                    self.candidates.read_id1,
                    self.candidates.same_strand,
                    params,
                    ca.align_method,
                    max_marker_frequency=ca.max_marker_frequency,
                )
            elif ca.align_method == 4:
                # Sparse cell analysis finds the bands; the same
                # batched banded DP engine aligns them
                # (reference: Align4.cpp).
                from shasta_tpu_torch.ops.align_other import align_candidates_method4

                self.alignments = align_candidates_method4(
                    self.markers,
                    self.candidates.read_id0,
                    self.candidates.read_id1,
                    self.candidates.same_strand,
                    params,
                    delta_x=ca.align4_delta_x,
                    delta_y=ca.align4_delta_y,
                    min_entry_count=ca.align4_min_entry_count_per_cell,
                    max_distance_from_boundary=(
                        ca.align4_max_distance_from_boundary
                    ),
                    device=self.device,
                )
            else:
                # Method 3: band discovery from downsampled markers
                # feeding the banded DP engine.
                ds_table = self.kmer_table.downsampling_hash_table()
                self.log.line(
                    f"Downsampling hash table for k {LAST_BUILD['k']}: built once in "
                    f"this process on the {LAST_BUILD['path']}, in "
                    f"{LAST_BUILD['seconds']:.3f} s."
                )
                self.alignments = align_candidates(
                    self.markers,
                    self.candidates.read_id0,
                    self.candidates.read_id1,
                    self.candidates.same_strand,
                    params,
                    ds_table,
                    device=self.device,
                )
                self.log.line(
                    f"Phase-2 batches collected on the device: {COLLECT['device']}, "
                    f"drained early and collected on the host: {COLLECT['host']}."
                )
            with span("stage:align.store"):
                # reference: Alignment::checkStrictlyIncreasing
                # (src/Alignment.hpp:48), enforced after every compute.
                if not self.alignments.check_strictly_increasing():
                    raise RuntimeError(
                        "Alignment ordinals are not strictly increasing; "
                        "this indicates a bug in the alignment kernel."
                    )
                self.store.save_stage("Alignments", self.alignments.arrays())
                gc.collect()
                malloc_trim()

    def release_candidates(self) -> None:
        """Drop the in-memory candidate pairs (persisted in the stage
        store; ``alignmentCandidateCount`` survives for the summary)."""
        if self.candidates is not None:
            self.n_candidates = int(self.candidates.count)
            self.candidates = None

    def release_alignments(self) -> None:
        """Drop the in-memory alignment store (persisted in the stage
        store; the count survives for the summary)."""
        if self.alignments is not None:
            self.n_alignments = int(self.alignments.count)
            self.alignments = None

    def create_read_graph(self) -> None:
        cr = self.config.read_graph
        with self.log.stage("createReadGraph"):
            if cr.creation_method == 2:
                self.read_graph, _, criteria = RG.create_read_graph2(
                    self.alignments,
                    self.reads.read_count,
                    max_alignment_count=cr.max_alignment_count,
                    marker_count_percentile=cr.marker_count_percentile,
                    aligned_fraction_percentile=cr.aligned_fraction_percentile,
                    max_skip_percentile=cr.max_skip_percentile,
                    max_drift_percentile=cr.max_drift_percentile,
                    max_trim_percentile=cr.max_trim_percentile,
                )
                self.log.line(f"Adaptive alignment criteria: {criteria}")
            else:
                self.read_graph, _ = RG.create_read_graph(
                    self.alignments,
                    self.reads.read_count,
                    max_alignment_count=cr.max_alignment_count,
                )
            self.store.save_stage("ReadGraph", self.read_graph.arrays())
            # Alignment-quality feedback (reference:
            # scripts/GenerateFeedback.py:82-91 — candidates were
            # plentiful but too few passed the good-alignment bar).
            good_per_read = self.alignments.count / max(1, self.reads.read_count)
            isolated_frac = float(
                (np.diff(self.read_graph.adj_offsets)[0::2] == 0).mean()
            )
            if self.lowhash_stats.get("candidatesPerRead", 99.0) >= 20.0 and (
                good_per_read < 5.0 or isolated_frac > 0.5
            ):
                msg = (
                    "Not enough good alignments: "
                    f"{good_per_read:.1f} per read, isolated-read "
                    f"fraction {isolated_frac:.2f}. Try, in order: "
                    "decrease Align.minAlignedFraction by 0.05 (down "
                    "to 0.2); decrease Align.minAlignedMarkerCount; "
                    "increase Align.maxSkip and Align.maxDrift by 10."
                )
                self.log.line("WARNING: " + msg)
                print("WARNING: " + msg, file=sys.stderr, flush=True)
                self.feedback.append(msg)
        with self.log.stage("flagChimericReads"):
            self.reads.is_chimeric = RG.flag_chimeric_reads(
                self.read_graph,
                self.reads.read_count,
                max_distance=cr.max_chimeric_read_distance,
            )
        if cr.strand_separation_method == 1:
            with self.log.stage("flagCrossStrandReadGraphEdges1"):
                flagged = RG.flag_cross_strand_edges1(
                    self.read_graph,
                    self.alignments,
                    self.reads.read_count,
                    max_distance=cr.cross_strand_max_distance,
                )
                self.log.line(f"Flagged {flagged} cross-strand edges.")
        elif cr.strand_separation_method == 2:
            with self.log.stage("flagCrossStrandReadGraphEdges2"):
                flagged = RG.flag_cross_strand_edges2(
                    self.read_graph,
                    self.alignments,
                    self.reads.read_count,
                    self.reads.is_chimeric,
                )
                self.log.line(f"Flagged {flagged} cross-strand edges.")
        if cr.remove_conflicts or cr.flag_inconsistent_alignments:
            with self.log.stage("flagInconsistentAlignments"):
                n_bad = RG.flag_inconsistent_alignments(
                    self.read_graph,
                    self.alignments,
                    self.reads.read_count,
                    self.reads.is_chimeric,
                    cr.flag_inconsistent_alignments_triangle_error_threshold,
                    cr.flag_inconsistent_alignments_least_square_error_threshold,
                    cr.flag_inconsistent_alignments_least_square_max_distance,
                )
                self.log.line(f"Flagged {n_bad} inconsistent read graph edges.")
        if cr.strand_separation_method or cr.remove_conflicts:
            # Persist the edge flags set above.
            self.store.save_stage("ReadGraph", self.read_graph.arrays())

    def create_marker_graph_vertices(self) -> None:
        cm = self.config.marker_graph
        with self.log.stage("createMarkerGraphVertices"):
            labels = None
            u = v = np.zeros(0, np.int64)
            # The duplicate-marker cleanup pass (rare path) still
            # consumes explicit pairs; everyone else streams.
            need_uv = self.mesh is not None or (
                cm.allow_duplicate_markers and cm.cleanup_duplicate_markers
            )
            if not need_uv:
                # Stream unites straight into the native DSU — no
                # materialized pair arrays (the run's largest transient
                # at scale; labels identical, equality-tested).
                labels = MG.union_find_labels_from_alignments(
                    self.markers, self.read_graph, self.alignments,
                    self.reads.is_chimeric,
                )
            else:
                u, v = MG.gather_unite_pairs(
                    self.markers, self.read_graph, self.alignments,
                    self.reads.is_chimeric,
                )
            if not (
                self.config.assembly.iterative
                and self.config.assembly.mode == 0
            ):
                # The unite/gather pass was the alignments' last
                # consumer: releasing the 3.8 GB store (SCALE=50) here
                # instead of after createMarkerGraphEdges keeps the
                # heavy vertex/edge passes under the memory budget
                # (iterative assembly re-scores them, so it keeps the
                # store; stage-store reloads still work).
                self.release_alignments()
            if self.mesh is not None:
                # Union-find min-hooking rounds run edge-parallel over
                # the mesh (reference analog: the lock-free CAS DSU,
                # src/dset64-gccAtomic.hpp); the wrapper verifies
                # convergence so labels match the host path exactly.
                from shasta_tpu_torch.parallel.mesh import sharded_union_find_labels

                labels = sharded_union_find_labels(
                    self.mesh, self.markers.total_count, u, v
                )
            min_cov = cm.min_coverage
            if min_cov == 0:
                # Histogram of disjoint-set sizes for auto selection.
                if labels is None:
                    labels = MG.union_find_labels(self.markers.total_count, u, v)
                # Labels are min-member representatives: one linear
                # bincount replaces np.unique's full sort of 10^8
                # int64 labels.
                cov_all = np.bincount(labels)
                hist = np.bincount(cov_all[cov_all > 0])
                del cov_all
                # DisjointSetsHistogram.csv (reference:
                # src/AssemblerMarkerGraph.cpp:224).
                with open(
                    os.path.join(self.run_dir, "DisjointSetsHistogram.csv"), "w"
                ) as f:
                    f.write("Coverage,Frequency\n")
                    for c, n in enumerate(hist):
                        if n:
                            f.write(f"{c},{n}\n")
                min_cov = auto_min_coverage(
                    hist,
                    min_area_fraction=cm.peak_finder_min_area_fraction,
                    area_start_index=cm.peak_finder_area_start_index,
                )
                self.log.line(f"Automatically selected MarkerGraph.minCoverage = {min_cov}")
            self.min_coverage_used = min_cov
            self.marker_graph = MG.create_marker_graph_vertices(
                self.markers,
                u,
                v,
                min_coverage=min_cov,
                max_coverage=cm.max_coverage,
                min_coverage_per_strand=cm.min_coverage_per_strand,
                allow_duplicate_markers=cm.allow_duplicate_markers,
                labels=labels,
            )
            MG.audit_strand_symmetry(self.marker_graph, "vertex creation")
            # reference: checkMarkerGraphVertices (Assembler.hpp:1275)
            if not MG.check_marker_graph_vertices(self.marker_graph):
                raise RuntimeError(
                    "Marker graph vertexTable/vertices inconsistency "
                    "after vertex creation."
                )
        if cm.allow_duplicate_markers and cm.cleanup_duplicate_markers:
            # (reference: srcMain/main.cpp:925-934)
            with self.log.stage("cleanupDuplicateMarkers"):
                self.marker_graph = MG.cleanup_duplicate_markers(
                    self.markers,
                    self.marker_graph,
                    u,
                    v,
                    min_coverage=min_cov,
                    min_coverage_per_strand=cm.min_coverage_per_strand,
                    pattern1_threshold=cm.duplicate_markers_pattern1_threshold,
                )
                stats = getattr(self.marker_graph, "cleanup_stats", None)
                if stats:
                    self.log.line(
                        f"Cleaned up {stats['bad']} bad vertices "
                        f"(pattern 1: {stats['pattern1']}, "
                        f"pattern 2: {stats['pattern2']})."
                    )

    def create_marker_graph_edges(self) -> None:
        cm = self.config.marker_graph
        if self.config.assembly.mode in (2, 3):
            self._create_marker_graph_edges_strict()
            return
        with self.log.stage("createMarkerGraphEdges"):
            MG.create_marker_graph_edges(self.markers, self.marker_graph)
        MG.audit_strand_symmetry(self.marker_graph, "edge creation")
        with self.log.stage("transitiveReduction"):
            MG.transitive_reduction(
                self.marker_graph,
                low_coverage_threshold=cm.low_coverage_threshold,
                high_coverage_threshold=cm.high_coverage_threshold,
                max_distance=cm.max_distance,
                edge_marker_skip_threshold=cm.edge_marker_skip_threshold,
            )
        if cm.reverse_transitive_reduction:
            # (reference: srcMain/main.cpp:946-951)
            with self.log.stage("reverseTransitiveReduction"):
                MG.reverse_transitive_reduction(
                    self.marker_graph,
                    low_coverage_threshold=cm.low_coverage_threshold,
                    high_coverage_threshold=cm.high_coverage_threshold,
                    max_distance=cm.max_distance,
                )
        with self.log.stage("pruneMarkerGraphStrongSubgraph"):
            MG.prune(self.marker_graph, iteration_count=cm.prune_iteration_count)
        with self.log.stage("simplifyMarkerGraph"):
            from shasta_tpu_torch.graph.simplify import simplify_marker_graph

            max_lengths = [
                int(x) for x in str(cm.simplify_max_length).split(",") if x
            ]
            simplify_marker_graph(self.marker_graph, max_lengths)
        self.store.save_stage("MarkerGraph", self.marker_graph.arrays())

    def _create_marker_graph_edges_strict(self) -> None:
        """Modes 2 and 3: strict edges preserve heterozygous bubbles
        (reference: createMarkerGraphEdgesStrict); no transitive
        reduction. Mode 2 then adds secondary edges and their split, and
        prunes (reference: mode2Assembly, srcMain/main.cpp:1049); mode 3
        adds no secondary edges and does not prune (reference:
        mode3Assembly, srcMain/main.cpp:1116-1145)."""
        from shasta_tpu_torch.graph import mode2 as M2

        cm = self.config.marker_graph
        with self.log.stage("createMarkerGraphEdgesStrict"):
            M2.create_marker_graph_edges_strict(
                self.reads,
                self.markers,
                self.marker_graph,
                min_edge_coverage=cm.min_edge_coverage,
                min_edge_coverage_per_strand=cm.min_edge_coverage_per_strand,
            )
        if self.config.assembly.mode == 3:
            MG.audit_strand_symmetry(self.marker_graph, "strict edge creation")
            self.store.save_stage("MarkerGraph", self.marker_graph.arrays())
            return
        if cm.secondary_edges:
            with self.log.stage("createMarkerGraphSecondaryEdges"):
                n1 = M2.create_marker_graph_secondary_edges(
                    self.markers, self.marker_graph,
                    max_skip=cm.secondary_edges_max_skip, aggressive=False,
                )
                n2 = M2.create_marker_graph_secondary_edges(
                    self.markers, self.marker_graph,
                    max_skip=cm.secondary_edges_max_skip, aggressive=True,
                )
                self.log.line(f"Added {n1} + {n2} secondary edges.")
            with self.log.stage("splitMarkerGraphSecondaryEdges"):
                # (reference: splitMarkerGraphSecondaryEdges after
                # secondary edge creation, Mode2Assembly protocol)
                n_split, n_new = M2.split_marker_graph_secondary_edges(
                    self.reads, self.markers, self.marker_graph,
                    cm.secondary_edges_split_error_rate_threshold,
                    cm.secondary_edges_split_min_coverage,
                )
                self.log.line(f"Split {n_split} secondary edges into {n_new}.")
        with self.log.stage("pruneMarkerGraphStrongSubgraph"):
            MG.prune(self.marker_graph, iteration_count=cm.prune_iteration_count)
        MG.audit_strand_symmetry(self.marker_graph, "strict edge creation")
        self.store.save_stage("MarkerGraph", self.marker_graph.arrays())

    def assemble_mode0(self) -> None:
        ca = self.config.assembly
        cm = self.config.marker_graph
        mg = self.marker_graph
        with self.log.stage("createAssemblyGraphEdges"):
            self.assembly_graph = AG.create_assembly_graph(mg)
        if cm.cross_edge_coverage_threshold > 0:
            with self.log.stage("removeLowCoverageCrossEdges"):
                n_removed = AG.remove_low_coverage_cross_edges(
                    self.assembly_graph, mg, cm.cross_edge_coverage_threshold
                )
                if n_removed:
                    # Rebuild after removal (reference:
                    # srcMain/main.cpp:973-979).
                    self.assembly_graph = AG.create_assembly_graph(mg)
        if ca.detangle_method != 0:
            from shasta_tpu_torch.graph.detangle import detangle_assembly_graph

            with self.log.stage("detangle"):
                self.assembly_graph = detangle_assembly_graph(
                    self.assembly_graph, mg, method=ca.detangle_method,
                    diagonal_read_count_min=ca.detangle_diagonal_read_count_min,
                    off_diagonal_read_count_max=(
                        ca.detangle_off_diagonal_read_count_max
                    ),
                    off_diagonal_ratio=ca.detangle_off_diagonal_ratio,
                )
        with self.log.stage("assembleMarkerGraphVertices"):
            self.vertex_repeats = AG.assemble_marker_graph_vertices(
                self.reads, self.markers, mg, caller=_vertex_caller_name(ca.consensus_caller)
            )
        with self.log.stage("assembleMarkerGraphEdges"):
            # Only edges on assembled chains need consensus.
            needed = np.zeros(mg.edge_count, dtype=bool)
            for a in range(self.assembly_graph.edge_count):
                if self.assembly_graph.is_assembled_edge(a):
                    needed[self.assembly_graph.chain(a)] = True
            self.edge_consensus = AG.assemble_marker_graph_edges(
                self.reads,
                self.markers,
                mg,
                needed=needed,
                caller=get_consensus_caller(ca.consensus_caller),
                length_threshold_markers=ca.marker_graph_edge_length_threshold_for_consensus,
            )
        with self.log.stage("assemble"):
            AG.assemble_segments(
                self.assembly_graph,
                mg,
                self.markers,
                self.vertex_repeats,
                self.edge_consensus,
            )
        self.store.save_stage("AssemblyGraph", self.assembly_graph.arrays())

    def assemble_mode2(self) -> Dict:
        """Mode 2: the full AssemblyGraph2 pipeline — bubbles,
        superbubble resolution, weak/degenerate branch removal, bad
        bubble removal, hierarchical phasing, bubble chains, phasing
        regions, and the Detailed/Haploid/Phased output family
        (reference: mode2Assembly, srcMain/main.cpp:1049 +
        src/AssemblyGraph2.cpp:44-233)."""
        from shasta_tpu_torch.graph import mode2_graph as M2G
        from shasta_tpu_torch.graph.assembly_graph import assemble_chain

        ca = self.config.assembly
        mg = self.marker_graph
        with self.log.stage("createAssemblyGraphEdges"):
            self.assembly_graph = AG.create_assembly_graph(mg)
        with self.log.stage("assembleMarkerGraphVertices"):
            self.vertex_repeats = AG.assemble_marker_graph_vertices(
                self.reads, self.markers, mg,
                caller=_vertex_caller_name(ca.consensus_caller),
            )
        with self.log.stage("assembleMarkerGraphEdges"):
            # AssemblyGraph2 branch paths can include any alive edge.
            self.edge_consensus = AG.assemble_marker_graph_edges(
                self.reads, self.markers, mg,
                needed=mg.alive(),
                caller=get_consensus_caller(ca.consensus_caller),
                length_threshold_markers=ca.marker_graph_edge_length_threshold_for_consensus,
            )
        with self.log.stage("assemble"):
            AG.assemble_segments(
                self.assembly_graph, mg, self.markers,
                self.vertex_repeats, self.edge_consensus,
            )

        g = M2G.AssemblyGraph2(mg, self.markers, self.markers.k)
        kmer_first = (
            self.markers.kmer_ids[mg.vertex_markers[mg.vertex_offsets[:-1]]]
            if mg.vertex_count
            else np.zeros(0, np.uint32)
        )
        vertex_cov = mg.vertex_coverage()

        kh = self.markers.k // 2

        def assemble_fn(path):
            # Exclude the first and last k/2 RLE bases so consecutive
            # branch sequences abut exactly — the shared vertex's k
            # bases split k/2 + k/2 between its two edges (reference:
            # AssemblyGraph2::assemble, src/AssemblyGraph2.cpp:816-832).
            _, rep, raw = assemble_chain(
                mg, self.markers, self.vertex_repeats, self.edge_consensus,
                path, kmer_first=kmer_first, vertex_cov=vertex_cov,
            )
            begin_skip = int(rep[:kh].sum())
            end_skip = int(rep[rep.shape[0] - kh:].sum())
            return raw[begin_skip : raw.shape[0] - end_skip]

        g.set_assembler(assemble_fn)
        p = M2G.Mode2Parameters(
            prune_length=ca.prune_length,
            strong_branch_threshold=ca.mode2_strong_branch_threshold,
            epsilon=ca.mode2_epsilon,
            bubble_removal_min_concordant=ca.mode2_bubble_removal_min_concordant_read_count,
            bubble_removal_max_discordant=ca.mode2_bubble_removal_max_discordant_read_count,
            bubble_removal_min_log_p=ca.mode2_bubble_removal_min_log_p,
            bubble_removal_component_size_threshold=ca.mode2_bubble_removal_component_size_threshold,
            phasing_min_concordant=ca.mode2_phasing_min_concordant_read_count,
            phasing_max_discordant=ca.mode2_phasing_max_discordant_read_count,
            phasing_min_log_p=ca.mode2_phasing_min_log_p,
            superbubble_max_size=ca.mode2_superbubble_max_size,
            superbubble_max_chunk_size=ca.mode2_superbubble_max_chunk_size,
            superbubble_max_chunk_path_count=ca.mode2_superbubble_max_chunk_path_count,
            superbubble_edge_length_threshold=ca.mode2_superbubble_edge_length_threshold,
        )
        with self.log.stage("assemblyGraph2"):
            stats = M2G.run_assembly_graph2(g, p)
            self.log.line(
                f"AssemblyGraph2: {stats['phasedBubbleCount']} of "
                f"{stats['diploidBubbleCount']} diploid bubbles phased "
                f"into {stats['phasedComponentCount']} components; "
                f"{stats['bubbleChainCount']} bubble chains; "
                f"{stats['hetSnpTransitionCount']} transitions + "
                f"{stats['hetSnpTransversionCount']} transversions."
            )
        self.mode2_graph = g
        with self.log.stage("writeMode2Outputs"):
            import os as _os

            def pjoin(name):
                return _os.path.join(self.run_dir, name)

            if not ca.mode2_suppress_detailed_output:
                M2G.write_detailed(
                    g, pjoin("Assembly-Detailed"), True,
                    write_gfa=not ca.mode2_suppress_gfa_output,
                    write_fasta=not ca.mode2_suppress_fasta_output,
                )
                if not ca.mode2_suppress_gfa_output:
                    M2G.write_detailed(
                        g, pjoin("Assembly-Detailed-NoSequence"), False,
                        write_fasta=False, write_csv=False,
                    )
            if not ca.mode2_suppress_haploid_output:
                stats.update(M2G.write_haploid(
                    g, pjoin("Assembly-Haploid"), True,
                    write_gfa=not ca.mode2_suppress_gfa_output,
                    write_fasta=not ca.mode2_suppress_fasta_output,
                ))
                if not ca.mode2_suppress_gfa_output:
                    M2G.write_haploid(
                        g, pjoin("Assembly-Haploid-NoSequence"), False,
                        write_fasta=False, write_csv=False,
                    )
            if not ca.mode2_suppress_phased_output:
                stats.update(M2G.write_phased(
                    g, pjoin("Assembly-Phased"), True,
                    write_gfa=not ca.mode2_suppress_gfa_output,
                    write_fasta=not ca.mode2_suppress_fasta_output,
                ))
                if not ca.mode2_suppress_gfa_output:
                    M2G.write_phased(
                        g, pjoin("Assembly-Phased-NoSequence"), False,
                        write_fasta=False, write_csv=False,
                    )
                M2G.write_phased_details(
                    g, pjoin("Assembly-Phased-Details.csv")
                )
            M2G.write_phasing_regions(g, pjoin("PhasingRegions.csv"))
            M2G.write_bubble_chains_csv(g, pjoin("BubbleChains.csv"))
        self.store.save_stage("AssemblyGraph", self.assembly_graph.arrays())
        return stats

    def assemble_mode3(self) -> Dict:
        """Mode 3: segments/journeys/links (reference: mode3Assembly,
        srcMain/main.cpp:1116, src/mode3.cpp)."""
        from shasta_tpu_torch.graph import mode3 as M3

        ca = self.config.assembly
        mg = self.marker_graph
        with self.log.stage("createMode3AssemblyGraph"):
            m3 = M3.create_mode3_graph(self.markers, mg)
            self.assembly_graph = m3.ag
        with self.log.stage("assembleMarkerGraphVertices"):
            self.vertex_repeats = AG.assemble_marker_graph_vertices(
                self.reads, self.markers, mg,
                caller=_vertex_caller_name(ca.consensus_caller),
            )
        with self.log.stage("assembleMarkerGraphEdges"):
            # Jaccard paths traverse segments on either strand, so
            # every alive edge needs consensus (unlike mode 0, which
            # assembles one strand per rc pair).
            self.edge_consensus = AG.assemble_marker_graph_edges(
                self.reads, self.markers, mg,
                needed=mg.alive(),
                caller=get_consensus_caller(ca.consensus_caller),
                length_threshold_markers=ca.marker_graph_edge_length_threshold_for_consensus,
            )
        with self.log.stage("assemble"):
            AG.assemble_segments(
                m3.ag, mg, self.markers, self.vertex_repeats, self.edge_consensus
            )
        with self.log.stage("writeMode3Outputs"):
            M3.write_mode3_gfa(
                os.path.join(self.run_dir, "Mode3-Assembly.gfa"), m3
            )
            paths = M3.find_assembly_paths(m3)
        with self.log.stage("createJaccardGraph"):
            # (reference: createJaccardGraph, mode3-JaccardGraph.cpp:28)
            from shasta_tpu_torch.graph import mode3_path as M3P

            conn = M3P.Mode3Connectivity(m3, mg, self.markers)
            # Iterative construction/cleanup: weak vertices (no strong
            # incident edge) demote to pass-through and the searches
            # re-run, so strong edges re-form across them (reference
            # machinery: removeWeakVertices,
            # mode3-JaccardGraph.cpp:238-296).
            jedges, _ = M3P.create_jaccard_graph_iterative(conn)
            n_strong = sum(1 for e in jedges.values() if e.is_strong)
            strong_v = set()
            for e in jedges.values():
                if e.is_strong:
                    strong_v.add(e.seg0)
                    strong_v.add(e.seg1)
            self.log.line(
                f"The Jaccard graph has {m3.segment_count} vertices "
                f"({len(strong_v)} with a strong edge) and "
                f"{len(jedges)} edges ({n_strong} strong)."
            )
            M3P.write_jaccard_edges_csv(
                os.path.join(self.run_dir, "JaccardGraphEdges.csv"), jedges
            )
            cluster_id = M3P.find_jaccard_clusters(m3.segment_count, jedges)
        with self.log.stage("assembleJaccardPaths"):
            # (reference: AssemblyPath::assemble,
            # mode3-AssemblyPath.cpp:28, driven per path as the
            # explorer does, AssemblerHttpServer-Mode3.cpp:871-907)
            skeletons = M3P.find_jaccard_paths(m3.segment_count, jedges)
            assembler = M3P.PathAssembler(
                m3, conn, mg, self.markers, self.reads,
                self.vertex_repeats, self.edge_consensus,
                caller=get_consensus_caller(ca.consensus_caller),
            )
            self.mode3_paths = [
                assembler.assemble_path(s) for s in skeletons
            ]
            M3P.write_paths_fasta(
                os.path.join(self.run_dir, "Mode3-Paths.fasta"),
                self.mode3_paths,
            )
            total_path_length = int(
                sum(p.raw.shape[0] for p in self.mode3_paths)
            )
            path_lens = sorted(
                (int(p.raw.shape[0]) for p in self.mode3_paths),
                reverse=True,
            )
            path_n50 = 0
            acc = 0
            for ln in path_lens:
                acc += ln
                if acc * 2 >= total_path_length:
                    path_n50 = ln
                    break
            self.log.line(
                f"Assembled {len(self.mode3_paths)} Jaccard paths, "
                f"total {total_path_length} raw bases, N50 {path_n50}."
            )
        with self.log.stage("clusterSegments"):
            # (reference: AssemblyGraph::clusterSegments, mode3.cpp:1201)
            cluster_id2 = M3.cluster_segments(m3, mg, self.markers)
            n_clusters = int(cluster_id2.max()) + 1 if cluster_id2.size else 0
            self.log.line(
                f"Found {n_clusters} segment clusters covering "
                f"{int((cluster_id2 >= 0).sum())} of {m3.segment_count} segments."
            )
        arrays = m3.arrays()
        arrays["cluster_id"] = cluster_id2
        arrays["jaccard_cluster_id"] = cluster_id
        # reference: flagBackSegments, persisted as Mode3-IsBackSegment
        arrays["is_back_segment"] = M3.flag_back_segments(m3)
        self.store.save_stage("Mode3", arrays)
        return {
            "mode3SegmentCount": m3.segment_count,
            "mode3LinkCount": m3.link_count,
            "mode3PathCount": len(paths),
            "mode3JaccardEdgeCount": len(jedges),
            "mode3JaccardPathCount": len(self.mode3_paths),
            "mode3JaccardPathTotalLength": total_path_length,
            "mode3JaccardPathN50": path_n50,
            "mode3ClusterCount": n_clusters,
        }

    def _write_coverage_data(self, length_threshold: int) -> None:
        """Per-position coverage detail of long assembled segments
        (reference: Assembly.storeCoverageData writes
        AssembledSegment<id>-Coverage.csv for segments of raw length
        >= storeCoverageDataCsvLengthThreshold)."""
        ag = self.assembly_graph
        mg = self.marker_graph
        vcov = mg.vertex_coverage()
        for e in range(ag.edge_count):
            if not ag.is_assembled_edge(e):
                continue
            if ag.raw_sequence(e).shape[0] < length_threshold:
                continue
            chain = ag.chain(e)
            path = os.path.join(
                self.run_dir, f"AssembledSegment-{e}-Coverage.csv"
            )
            with open(path, "w") as f:
                f.write(
                    "Position,MarkerGraphEdgeId,EdgeCoverage,"
                    "SourceVertexCoverage,TargetVertexCoverage\n"
                )
                for pos, me in enumerate(chain.tolist()):
                    f.write(
                        f"{pos},{me},{mg.coverage[me]},"
                        f"{vcov[mg.source[me]]},{vcov[mg.target[me]]}\n"
                    )

    def write_output(self) -> Dict:
        stats = AG.assembly_statistics(self.assembly_graph)
        with self.log.stage("writeOutput"):
            AG.write_fasta(os.path.join(self.run_dir, "Assembly.fasta"), self.assembly_graph)
            AG.write_gfa1(
                os.path.join(self.run_dir, "Assembly.gfa"),
                self.assembly_graph,
                self.markers.k,
                self.vertex_repeats,
            )
            AG.write_gfa1(
                os.path.join(self.run_dir, "Assembly-BothStrands.gfa"),
                self.assembly_graph,
                self.markers.k,
                self.vertex_repeats,
                both_strands=True,
            )
            ca_out = self.config.assembly
            if ca_out.write_reads_by_assembled_segment:
                # (reference: Assembly.writeReadsByAssembledSegment ->
                # gatherOrientedReadsByAssemblyGraphEdge)
                from shasta_tpu_torch.graph.detangle import _edge_oriented_reads

                with open(
                    os.path.join(self.run_dir, "OrientedReadsBySegment.csv"),
                    "w",
                ) as f:
                    f.write("Segment,OrientedReadId,ReadId,Strand\n")
                    for e in range(self.assembly_graph.edge_count):
                        if not self.assembly_graph.is_assembled_edge(e):
                            continue
                        for orid in _edge_oriented_reads(
                            self.assembly_graph, self.marker_graph, e
                        ).tolist():
                            f.write(f"{e},{orid},{orid // 2},{orid % 2}\n")
            if ca_out.store_coverage_data:
                # (reference: Assembly.storeCoverageData +
                # storeCoverageDataCsvLengthThreshold: per-segment
                # coverage detail for long segments)
                self._write_coverage_data(
                    ca_out.store_coverage_data_csv_length_threshold
                )
            import resource

            peak_rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            summary = {
                "readCount": self.reads.read_count,
                "peakMemoryUsageKB": int(peak_rss_kb),
                "rawBaseCount": self.reads.total_raw_bases,
                "rleBaseCount": self.reads.total_rle_bases,
                "markerCount": self.markers.total_count,
                "alignmentCandidateCount": (
                    int(self.candidates.count)
                    if self.candidates is not None
                    else getattr(self, "n_candidates", 0)
                ),
                "alignmentCount": (
                    int(self.alignments.count)
                    if self.alignments is not None
                    else getattr(self, "n_alignments", 0)
                ),
                "chimericReadCount": int(self.reads.is_chimeric.sum()),
                "palindromicReadCount": int(self.reads.is_palindromic.sum()),
                "discardedShortReadCount": self.reads.discards.short_read_count,
                "discardedBadBaseReadCount": self.reads.discards.bad_base_read_count,
                "isolatedReadCount": int(
                    (np.diff(self.read_graph.adj_offsets)[0::2] == 0).sum()
                ) if self.read_graph is not None else 0,
                "markerGraphVertexCount": self.marker_graph.vertex_count,
                "markerGraphEdgeCount": self.marker_graph.edge_count,
                "markerGraphMinCoverageUsed": self.min_coverage_used,
                "assembledSegmentCount": stats["segment_count"],
                "totalAssembledSegmentLength": stats["total_length"],
                "longestAssembledSegmentLength": stats["longest"],
                "assembledSegmentN50": stats["n50"],
                "stageSeconds": dict(self.log.stage_seconds),
            }
            if self.lowhash_stats:
                summary["lowHashStatistics"] = self.lowhash_stats
            if self.feedback:
                summary["feedback"] = list(self.feedback)
            with open(os.path.join(self.run_dir, "AssemblySummary.json"), "w") as f:
                json.dump(summary, f, indent=2)
            self.config.write_conf(os.path.join(self.run_dir, "shasta.conf"))
            self._write_html_summary(summary)
        return summary

    def _write_html_summary(self, summary: Dict) -> None:
        """AssemblySummary.html + index.html (reference:
        srcMain/main.cpp:822-830)."""
        rows = "".join(
            f"<tr><th>{k}</th><td>{v}</td></tr>"
            for k, v in summary.items()
            if not isinstance(v, dict)
        )
        html = (
            "<html><head><style>body{font-family:sans-serif;margin:2em}"
            "table{border-collapse:collapse}td,th{border:1px solid #999;"
            "padding:2px 8px;text-align:left}</style></head><body>"
            "<h1>shasta_tpu_torch assembly summary</h1>"
            f"<table>{rows}</table></body></html>"
        )
        with open(os.path.join(self.run_dir, "AssemblySummary.html"), "w") as f:
            f.write(html)
        with open(os.path.join(self.run_dir, "index.html"), "w") as f:
            f.write(
                "<html><body><h1>shasta_tpu_torch run</h1><ul>"
                '<li><a href="AssemblySummary.html">Assembly summary</a></li>'
                '<li><a href="AssemblySummary.json">Assembly summary (JSON)</a></li>'
                "</ul><p>Run <code>python -m shasta_tpu_torch --command explore "
                "--assemblyDirectory .</code> for interactive exploration."
                "</p></body></html>"
            )


def _vertex_caller_name(spec: str) -> str:
    return "Median" if spec == "Median" else "Modal"


def run_assembly(
    input_files: List[str],
    run_dir: str,
    config: Optional[AssemblyConfig] = None,
    device=None,
    mesh=None,
) -> Dict:
    """The full pipeline (reference call sequence: srcMain/main.cpp:516-830,
    then mode0Assembly :845-1045 with its iterative rounds :851-906, or
    mode2Assembly :1049, or mode3Assembly :1116).

    ``device``: where the alignment DP runs, "cuda" (the default: the
    CUDA kernels; raises without a card) or "cpu" (their plain PyTorch
    version). The output is identical on either.

    ``mesh``: optional :class:`~shasta_tpu_torch.parallel.mesh.Mesh`; when
    provided, the hot stages execute sharded over its ranks with
    identical output (the device is the mesh's)."""
    t0 = time.monotonic()
    a = Assembler(run_dir, config, device=device, mesh=mesh)
    from shasta_tpu_torch.utils.perf import Tee

    with Tee(os.path.join(run_dir, "stdout.log")):
        return _run_assembly_stages(a, input_files, t0)


def _run_assembly_stages(a: "Assembler", input_files: List[str], t0: float) -> Dict:
    AG.COUNTS.update(condensations=0, edges=0)
    a.add_reads(input_files)
    a.select_kmers()
    a.find_markers()
    a.flag_palindromic_reads()
    a.find_alignment_candidates()
    a.compute_alignments()
    # Candidates are consumed; the stage store keeps them reloadable
    # (explorer/stage-wise reruns reattach there). Freeing the host
    # copies eagerly is part of the bytes-per-base budget (the
    # reference frees/remaps stage data the same way via its mmap
    # namespace, src/MemoryMappedVector.hpp remove()).
    a.release_candidates()
    a.create_read_graph()
    a.create_marker_graph_vertices()
    a.create_marker_graph_edges()
    if not (a.config.assembly.iterative and a.config.assembly.mode == 0):
        # Iterative refinement re-scores stored alignments; everyone
        # else is done with them once the marker graph exists.
        a.release_alignments()
    if a.config.assembly.iterative and a.config.assembly.mode == 0:
        # Iterative refinement (reference: srcMain/main.cpp:851-906).
        from shasta_tpu_torch.pipeline.iterative import (
            refine_read_graph_with_pseudo_paths,
        )

        for it in range(a.config.assembly.iterative_iteration_count):
            with a.log.stage(f"iterativeAssembly-{it}"):
                kept, dropped = refine_read_graph_with_pseudo_paths(
                    a,
                    min_score=a.config.assembly.iterative_min_score,
                    mismatch_square_factor=(
                        a.config.assembly.iterative_mismatch_square_factor
                    ),
                )
                a.log.line(
                    f"Iteration {it}: kept {kept} alignments, "
                    f"dropped {dropped} discordant."
                )
                # Bridge removal after the pseudo-path refinement
                # (reference: srcMain/main.cpp:890-896).
                total_bridges = 0
                for _ in range(
                    a.config.assembly.iterative_bridge_removal_iteration_count
                ):
                    a.read_graph, _, n_removed = RG.remove_read_graph_bridges(
                        a.read_graph,
                        a.alignments,
                        a.reads.read_count,
                        a.config.assembly.iterative_bridge_removal_max_distance,
                    )
                    total_bridges += n_removed
                    if n_removed == 0:
                        break
                if total_bridges:
                    a.log.line(f"Removed {total_bridges} read graph bridges.")
                    a.create_marker_graph_vertices()
                    a.create_marker_graph_edges()
                if dropped == 0 and total_bridges == 0:
                    break
    if a.config.assembly.mode == 2:
        mode2_stats = a.assemble_mode2()
        summary = a.write_output()
        summary.update(mode2_stats)
    elif a.config.assembly.mode == 3:
        mode3_stats = a.assemble_mode3()
        summary = a.write_output()
        summary.update(mode3_stats)
    else:
        a.assemble_mode0()
        summary = a.write_output()
    summary["elapsedSeconds"] = time.monotonic() - t0
    # CPU time and average utilization (reference: srcMain/main.cpp:798-810).
    cpu = os.times()
    summary["cpuSeconds"] = round(cpu.user + cpu.system, 3)
    if summary["elapsedSeconds"] > 0:
        summary["averageCpuUtilization"] = round(
            summary["cpuSeconds"] / summary["elapsedSeconds"], 3
        )
    a.log.line(
        f"Assembly graph condensations: {AG.COUNTS['condensations']}, "
        f"marker graph edges read: {AG.COUNTS['edges']}."
    )
    a.log.line(f"Assembly done in {summary['elapsedSeconds']:.3f} s.")
    a.log.close()
    return summary
