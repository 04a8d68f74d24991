"""The mode-0 assembly pipeline, stages addReads through computeAlignments.

Counterpart of ``shasta_tpu/pipeline/assemble.py`` (:75-489): the
stage-by-stage ``Assembler`` API. Every stage persists its outputs to
the run directory's stage store in the JAX package's ``Data/`` format,
so a run directory written by either package can be reattached by the
other (``cls.from_arrays(store.load_stage(name))`` for each stage).
The stages after computeAlignments are not ported yet.
"""

from __future__ import annotations

import gc
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from shasta_tpu_torch.data.kmers import KmerTable, select_kmers_random
from shasta_tpu_torch.data.markers import MarkerStore, find_markers
from shasta_tpu_torch.data.reads import ReadStore, build_read_store
from shasta_tpu_torch.data.store import RunStore
from shasta_tpu_torch.io import fasta as FIO
from shasta_tpu_torch.ops import lowhash as LH
from shasta_tpu_torch.ops.align import AlignParams, AlignmentStore, align_candidates
from shasta_tpu_torch.ops.align_kernel import resolve_device
from shasta_tpu_torch.pipeline.config import AssemblyConfig
from shasta_tpu_torch.utils.perf import PerformanceLog, malloc_trim


class Assembler:
    """Holds pipeline state; method names mirror the reference's
    Assembler stages (reference: src/Assembler.hpp).

    ``device`` is where the alignment engine runs: "cuda" by default
    (the CUDA kernels; raises when there is no card), or "cpu" (the
    plain PyTorch version). The host stages are numpy either way."""

    def __init__(
        self,
        run_dir: str,
        config: Optional[AssemblyConfig] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.store = RunStore(run_dir)
        self.config = config or AssemblyConfig()
        self.log = PerformanceLog(os.path.join(run_dir, "performance.log"))

        self.reads: Optional[ReadStore] = None
        self.kmer_table: Optional[KmerTable] = None
        self.markers: Optional[MarkerStore] = None
        self.candidates: Optional[LH.CandidatePairs] = None
        self.alignments: Optional[AlignmentStore] = None
        self.feedback: List[str] = []
        self.lowhash_stats: Dict = {}

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
                    self.markers, params, self.reads.is_palindromic, lh_stats
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
        ca = self.config.align
        with self.log.stage("computeAlignments"):
            if ca.align_method in (0, 1, 4):
                raise NotImplementedError(
                    f"Align.alignMethod {ca.align_method} is not ported yet "
                    "(ROADMAP.md, modules to port, item 9: ops/align_other.py)"
                )
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
            # Method 3: band discovery from downsampled markers feeding
            # the banded DP engine.
            self.alignments = align_candidates(
                self.markers,
                self.candidates.read_id0,
                self.candidates.read_id1,
                self.candidates.same_strand,
                params,
                self.kmer_table.downsampling_hash_table(),
                device=self.device,
            )
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
