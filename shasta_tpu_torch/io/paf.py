"""Reference-alignment PAF overlay for the explorer.

The reference explorer can load a PAF file of read-to-reference
alignments (e.g. from minimap2) and build a ground-truth overlap graph
used to assess candidate/alignment/read-graph edges (reference:
src/AssemblerHttpServer-Alignments.cpp:567 loadAlignmentsPafFile,
src/ReferenceOverlapMap.hpp). Two oriented reads are "true overlaps"
when their alignment intervals on the same reference region intersect.

The reference keeps a boost interval_map per region; here a numpy
sort-based sweep over interval endpoints produces the same overlap
pair set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


@dataclass
class ReferenceOverlaps:
    """Parsed PAF intervals plus the derived true-overlap pair set.

    Oriented read ids use the packed reference convention
    ``orid = read_id * 2 + strand`` where strand 1 means the PAF line
    mapped the read to the reverse reference strand (the reference
    inserts the reverse-complement oriented read for '-' lines,
    AssemblerHttpServer-Alignments.cpp:622-628).
    """

    # Parallel arrays, one entry per kept PAF line.
    orid: np.ndarray  # int64
    region: np.ndarray  # int32 index into region_names
    start: np.ndarray  # int64
    stop: np.ndarray  # int64
    region_names: List[str] = field(default_factory=list)
    skipped_reads: int = 0  # lines naming reads not in the assembly

    @property
    def count(self) -> int:
        return int(self.orid.shape[0])

    def overlap_pairs(self) -> Set[Tuple[int, int]]:
        """All oriented-read pairs whose reference intervals intersect
        on the same region (endpoints touching does not count, matching
        half-open [start, stop) PAF intervals)."""
        pairs: Set[Tuple[int, int]] = set()
        if self.count == 0:
            return pairs
        order = np.lexsort((self.start, self.region))
        region = self.region[order]
        start = self.start[order]
        stop = self.stop[order]
        orid = self.orid[order]
        # Sweep: active set of intervals still open at the current start.
        active: List[int] = []  # indices into the sorted arrays
        prev_region = -1
        for i in range(order.shape[0]):
            if region[i] != prev_region:
                active = []
                prev_region = int(region[i])
            s = start[i]
            active = [j for j in active if stop[j] > s]
            me = int(orid[i])
            for j in active:
                other = int(orid[j])
                if other != me:
                    pairs.add((min(me, other), max(me, other)))
            active.append(i)
        return pairs

    def read_pairs(self) -> Set[Tuple[int, int]]:
        """True-overlap pairs collapsed to (read, read) regardless of
        orientation, for assessing candidate pairs."""
        return {
            (min(a // 2, b // 2), max(a // 2, b // 2))
            for a, b in self.overlap_pairs()
            if a // 2 != b // 2
        }

    def intervals_for_read(self, read_id: int):
        """(region_name, start, stop, strand) tuples for one read."""
        out = []
        for i in range(self.count):
            if int(self.orid[i]) // 2 == read_id:
                out.append(
                    (
                        self.region_names[int(self.region[i])],
                        int(self.start[i]),
                        int(self.stop[i]),
                        int(self.orid[i]) & 1,
                    )
                )
        return out


def load_paf(
    path: str,
    read_names: Optional[List[str]] = None,
    min_quality: int = 0,
) -> ReferenceOverlaps:
    """Parse a PAF file into a ReferenceOverlaps overlay.

    ``read_names`` maps assembly read ids to names; PAF lines naming
    reads not present in the assembly are counted and skipped (the
    reference warns per line, AssemblerHttpServer-Alignments.cpp:640).
    When ``read_names`` is None, query names must be integer read ids.
    """
    name_to_id: Optional[Dict[str, int]] = None
    if read_names is not None:
        name_to_id = {}
        for i, n in enumerate(read_names):
            # FASTA metadata after the first space is not part of the name.
            name_to_id.setdefault(n.split()[0], i)

    orids: List[int] = []
    regions: List[int] = []
    starts: List[int] = []
    stops: List[int] = []
    region_names: List[str] = []
    region_index: Dict[str, int] = {}
    skipped = 0

    with open(path, "rt") as f:
        for line_no, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            cols = line.split("\t")
            if len(cols) < 12:
                raise ValueError(
                    f"{path}:{line_no}: PAF line has {len(cols)} columns, "
                    "expected at least 12"
                )
            qname = cols[0]
            is_reverse = cols[4] == "-"
            tname = cols[5]
            tstart = int(cols[7])
            tstop = int(cols[8])
            quality = int(cols[11])
            if quality < min_quality:
                continue
            if name_to_id is not None:
                rid = name_to_id.get(qname.split()[0])
                if rid is None:
                    skipped += 1
                    continue
            else:
                rid = int(qname)
            reg = region_index.setdefault(tname, len(region_names))
            if reg == len(region_names):
                region_names.append(tname)
            orids.append(rid * 2 + (1 if is_reverse else 0))
            regions.append(reg)
            starts.append(tstart)
            stops.append(tstop)

    return ReferenceOverlaps(
        orid=np.asarray(orids, np.int64),
        region=np.asarray(regions, np.int32),
        start=np.asarray(starts, np.int64),
        stop=np.asarray(stops, np.int64),
        region_names=region_names,
        skipped_reads=skipped,
    )
