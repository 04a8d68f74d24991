"""Assembly configuration: sections and keys mirror the reference's
``[Section] key=value`` conf files (reference: src/AssemblerOptions.hpp:91-391,
conf/*.conf). Any key can be set from a conf file or a CLI
``--Section.key value`` override.
"""

from __future__ import annotations

import configparser
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ReadsOptions:
    # 1 = run-length encoded (default), 0 = raw sequence (used by the
    # Phased configs; reference: src/Reads.hpp representation flag).
    representation: int = 1
    min_read_length: int = 10000
    desired_coverage: int = 0  # 0 = no coverage-based cutoff
    no_cache: bool = False
    # Palindromic read detection (reference:
    # Reads.palindromicReads.* in src/AssemblerOptions.cpp).
    palindromic_reads_skip_flagging: bool = False
    palindromic_reads_max_skip: int = 100
    palindromic_reads_max_drift: int = 100
    palindromic_reads_max_marker_frequency: int = 10
    palindromic_reads_aligned_fraction_threshold: float = 0.1
    palindromic_reads_near_diagonal_fraction_threshold: float = 0.1
    palindromic_reads_delta_threshold: int = 100


@dataclass
class KmersOptions:
    k: int = 10
    probability: float = 0.1
    generation_method: int = 0
    seed: int = 231  # reference: srcMain/main.cpp:598 (mt19937 seed 231)
    file: str = ""  # generation method 3: one k-mer per line
    enrichment_threshold: float = 100.0  # methods 1/2
    distance_threshold: int = 1000  # method 4


@dataclass
class MinHashOptions:
    version: int = 0
    m: int = 4
    hash_fraction: float = 0.01
    min_hash_iteration_count: int = 10
    log2_min_hash_bucket_count: int = 0
    min_bucket_size: int = 0
    max_bucket_size: int = 10
    min_frequency: int = 2
    alignment_candidates_per_read: float = 20.0  # 0 = no early stop
    all_pairs: bool = False  # skip LowHash, use all read pairs


@dataclass
class AlignOptions:
    align_method: int = 3
    match_score: int = 6
    mismatch_score: int = -1
    gap_score: int = -1
    downsampling_factor: float = 0.1
    band_extend: int = 10
    max_band: int = 1000
    max_skip: int = 30
    max_drift: int = 30
    max_trim: int = 30
    min_aligned_marker_count: int = 100
    min_aligned_fraction: float = 0.0
    max_marker_frequency: int = 10  # methods 0/4 dot filtering
    suppress_containments: bool = False
    same_channel_read_alignment_suppress_delta_threshold: int = 0
    # Method 4 (reference: AssemblerOptions.cpp Align.align4.* section).
    align4_delta_x: int = 200
    align4_delta_y: int = 10
    align4_min_entry_count_per_cell: int = 10
    align4_max_distance_from_boundary: int = 100


@dataclass
class ReadGraphOptions:
    creation_method: int = 0
    max_alignment_count: int = 6
    max_chimeric_read_distance: int = 2
    strand_separation_method: int = 1  # reference default (AssemblerOptions.cpp:508)
    cross_strand_max_distance: int = 6
    remove_conflicts: bool = False
    flag_inconsistent_alignments: bool = False
    # Creation method 2 adaptive-threshold percentiles (reference:
    # setReadGraph2Criteria, src/AssemblerReadGraph2.cpp:94).
    marker_count_percentile: float = 0.015
    aligned_fraction_percentile: float = 0.12
    max_skip_percentile: float = 0.12
    max_drift_percentile: float = 0.12
    max_trim_percentile: float = 0.015
    flag_inconsistent_alignments_triangle_error_threshold: int = 200
    flag_inconsistent_alignments_least_square_error_threshold: int = 200
    flag_inconsistent_alignments_least_square_max_distance: int = 1


@dataclass
class MarkerGraphOptions:
    min_coverage: int = 0  # 0 = auto via peak finder
    max_coverage: int = 100
    # Auto-minCoverage peak finding (reference: MarkerGraph.peakFinder.*).
    peak_finder_min_area_fraction: float = 0.08
    peak_finder_area_start_index: int = 2
    min_coverage_per_strand: int = 0
    allow_duplicate_markers: bool = False
    cleanup_duplicate_markers: bool = False
    duplicate_markers_pattern1_threshold: float = 0.5
    # transitive reduction
    low_coverage_threshold: int = 1
    high_coverage_threshold: int = 256
    max_distance: int = 30
    edge_marker_skip_threshold: int = 100
    reverse_transitive_reduction: bool = False
    prune_iteration_count: int = 6
    simplify_max_length: str = "10,100,1000"
    cross_edge_coverage_threshold: int = 0
    # Strict edges (mode 2).
    min_edge_coverage: int = 4
    min_edge_coverage_per_strand: int = 1
    secondary_edges: bool = True
    secondary_edges_max_skip: int = 1000000
    secondary_edges_split_error_rate_threshold: float = 0.25
    secondary_edges_split_min_coverage: int = 4


@dataclass
class AssemblyOptions:
    mode: int = 0
    consensus_caller: str = "Modal"
    marker_graph_edge_length_threshold_for_consensus: int = 1000
    detangle_method: int = 0
    prune_length: int = 0  # Assembly.pruneLength (AssemblyGraph2 prune)
    # Mode 2 phasing (legacy simple-phaser knobs, kept for scripts).
    phasing_epsilon: float = 0.1
    phasing_min_log_p: float = 30.0
    # Mode 2 (AssemblyGraph2) options; names mirror the reference's
    # Assembly.mode2.* keys (reference: src/AssemblerOptions.cpp:824-925).
    mode2_strong_branch_threshold: int = 2
    mode2_epsilon: float = 0.1
    mode2_bubble_removal_min_concordant_read_count: int = 3
    mode2_bubble_removal_max_discordant_read_count: int = 6
    mode2_bubble_removal_min_log_p: float = 30.0
    mode2_bubble_removal_component_size_threshold: int = 10
    mode2_phasing_min_concordant_read_count: int = 2
    mode2_phasing_max_discordant_read_count: int = 1
    mode2_phasing_min_log_p: float = 10.0
    mode2_superbubble_max_size: int = 50
    mode2_superbubble_max_chunk_size: int = 20
    mode2_superbubble_max_chunk_path_count: int = 20
    mode2_superbubble_edge_length_threshold: int = 6
    mode2_suppress_gfa_output: bool = False
    mode2_suppress_fasta_output: bool = False
    mode2_suppress_detailed_output: bool = False
    mode2_suppress_phased_output: bool = False
    mode2_suppress_haploid_output: bool = False
    # Iterative assembly (mode 0).
    iterative: bool = False
    iterative_iteration_count: int = 3
    iterative_pseudo_path_align_match_score: int = 1
    iterative_pseudo_path_align_mismatch_score: int = -1
    iterative_pseudo_path_align_gap_score: int = -1
    iterative_mismatch_square_factor: float = 3.0
    iterative_min_score: float = 0.0
    iterative_max_alignment_count: int = 6
    iterative_bridge_removal_iteration_count: int = 3
    iterative_bridge_removal_max_distance: int = 2
    # Output extras.
    store_coverage_data: bool = False
    store_coverage_data_csv_length_threshold: int = 0
    write_reads_by_assembled_segment: bool = False
    # Detangle matrix criteria (reference: Assembly.detangle.*).
    detangle_diagonal_read_count_min: int = 1
    detangle_off_diagonal_read_count_max: int = 2
    detangle_off_diagonal_ratio: float = 0.3


@dataclass
class AssemblyConfig:
    reads: ReadsOptions = field(default_factory=ReadsOptions)
    kmers: KmersOptions = field(default_factory=KmersOptions)
    min_hash: MinHashOptions = field(default_factory=MinHashOptions)
    align: AlignOptions = field(default_factory=AlignOptions)
    read_graph: ReadGraphOptions = field(default_factory=ReadGraphOptions)
    marker_graph: MarkerGraphOptions = field(default_factory=MarkerGraphOptions)
    assembly: AssemblyOptions = field(default_factory=AssemblyOptions)

    _SECTION_MAP = {
        "Reads": "reads",
        "Kmers": "kmers",
        "MinHash": "min_hash",
        "Align": "align",
        "ReadGraph": "read_graph",
        "MarkerGraph": "marker_graph",
        "Assembly": "assembly",
    }

    def to_dict(self) -> Dict[str, Dict[str, object]]:
        out = {}
        for section, attr in self._SECTION_MAP.items():
            out[section] = dataclasses.asdict(getattr(self, attr))
        return out

    def is_bool(self, section: str, key: str) -> bool:
        """True if Section.key is a boolean switch (may be passed on the
        command line with no value, like the reference's bool_switch)."""
        attr = self._SECTION_MAP.get(section)
        if attr is None:
            return False
        obj = getattr(self, attr)
        pykey = _to_snake(key)
        return hasattr(obj, pykey) and isinstance(getattr(obj, pykey), bool)

    def set(self, section: str, key: str, value: str) -> None:
        """Apply one ``Section.key=value`` override (string value is
        coerced to the field's type)."""
        attr = self._SECTION_MAP.get(section)
        if attr is None:
            raise KeyError(f"Unknown config section {section!r}")
        obj = getattr(self, attr)
        pykey = _to_snake(key)
        if not hasattr(obj, pykey):
            raise KeyError(f"Unknown config key {section}.{key}")
        cur = getattr(obj, pykey)
        if isinstance(cur, bool):
            setattr(obj, pykey, str(value).lower() in ("1", "true", "yes"))
        elif isinstance(cur, int):
            setattr(obj, pykey, int(value))
        elif isinstance(cur, float):
            setattr(obj, pykey, float(value))
        else:
            setattr(obj, pykey, value)

    @classmethod
    def from_conf_file(cls, path: str) -> "AssemblyConfig":
        with open(path) as f:
            return cls.from_conf_text(f.read())

    @classmethod
    def from_conf_text(cls, text: str) -> "AssemblyConfig":
        cfg = cls()
        parser = configparser.ConfigParser()
        parser.optionxform = str  # keep camelCase keys intact
        parser.read_string(text)
        for section in parser.sections():
            for key, value in parser.items(section):
                try:
                    cfg.set(section, key, value)
                except KeyError:
                    pass  # tolerate unknown keys from reference confs
        return cfg

    def write_conf(self, path: str) -> None:
        """Record the effective configuration (like the reference's
        shasta.conf dump, srcMain/main.cpp:359-364)."""
        with open(path, "w") as f:
            for section, attr in self._SECTION_MAP.items():
                f.write(f"[{section}]\n")
                for k, v in dataclasses.asdict(getattr(self, attr)).items():
                    f.write(f"{_to_camel(k)} = {v}\n")
                f.write("\n")


def _to_snake(key: str) -> str:
    # Keys like "sameChannelReadAlignment.suppressDeltaThreshold" fold
    # their inner dot away (reference: AssemblerOptions nested names).
    if "." in key:
        parts = key.split(".")
        key = parts[0] + "".join(p[:1].upper() + p[1:] for p in parts[1:])
    out = []
    for c in key:
        if c.isupper():
            out.append("_")
            out.append(c.lower())
        else:
            out.append(c)
    s = "".join(out)
    return s[1:] if s.startswith("_") else s


def _to_camel(key: str) -> str:
    parts = key.split("_")
    return parts[0] + "".join(p.capitalize() for p in parts[1:])
