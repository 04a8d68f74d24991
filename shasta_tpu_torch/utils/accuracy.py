"""Assembly accuracy metrics against a known truth genome.

The reference ships no built-in accuracy tooling — published accuracy
numbers come from external comparison (Shafin et al. error analysis,
cited at reference OLD-README.md:7-13; post-run QC hooks live in
reference scripts/GenerateFeedback.py). For synthetic runs the truth
genome is in memory, so the assembler can grade itself: this module
implements Merqury-style k-mer QV and completeness plus an
anchor-chaining misassembly count — all single-pass vectorized numpy,
sized for a 4-core host at 100+ Mb.

Metrics:
- **QV** (base-call quality): every contig k-mer absent from the truth
  genome implies >= 1 base error within k bases. Merqury's estimator:
  per-base error p = 1 - (found / total)^(1/k), QV = -10 log10(p).
- **completeness**: fraction of distinct truth k-mers present in the
  assembly (genome fraction recovered).
- **misassemblies**: walk each contig's unique-anchor chain (k-mers
  that occur exactly once in the truth); a breakpoint is a consecutive
  anchor pair whose truth distance disagrees with the contig distance
  by more than ``max_indel`` or that flips strand/ordering.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def kmer_codes(seq: np.ndarray, k: int) -> np.ndarray:
    """Forward k-mer codes (2 bits/base, uint64) at every position of a
    base-code array. k <= 31."""
    n = seq.shape[0] - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    v = np.zeros(n, np.uint64)
    s = seq.astype(np.uint64)
    for j in range(k):
        v = (v << np.uint64(2)) | s[j : n + j]
    return v


def canonical_kmer_codes(seq: np.ndarray, k: int) -> np.ndarray:
    """Canonical (min of forward / reverse-complement) k-mer codes."""
    fwd = kmer_codes(seq, k)
    rc_seq = (3 - seq[::-1]).astype(np.uint8)
    rev = kmer_codes(rc_seq, k)[::-1]
    return np.minimum(fwd, rev)


def _found_mask(codes: np.ndarray, truth_sorted: np.ndarray) -> np.ndarray:
    if truth_sorted.shape[0] == 0:
        return np.zeros(codes.shape[0], bool)
    idx = np.searchsorted(truth_sorted, codes)
    idx = np.minimum(idx, truth_sorted.shape[0] - 1)
    return truth_sorted[idx] == codes


def assembly_metrics(
    contigs: Sequence[np.ndarray],
    truth,
    k: int = 21,
    anchor_stride: int = 1000,
    max_indel: int = 5000,
    qv_cap: float = 90.0,
) -> Dict:
    """Grade ``contigs`` (base-code arrays) against ``truth`` — one
    genome array, or a list of haplotype arrays whose k-mer union is
    the truth set (diploid).

    Returns {qv, completeness, misassemblies, contigKmers, missingKmers,
    truthKmers, foundTruthKmers, anchorsMapped}.
    """
    truths = truth if isinstance(truth, (list, tuple)) else [truth]
    truth_can = np.concatenate(
        [canonical_kmer_codes(t, k) for t in truths]
    )
    truth_sorted = np.unique(truth_can)
    # Misassembly anchors come from the first haplotype (shared
    # backbone in the synthetic diploid benches).
    truth = truths[0]

    total = 0
    missing = 0
    found_truth = np.zeros(truth_sorted.shape[0], bool)
    per_contig_found: List[np.ndarray] = []
    for c in contigs:
        codes = canonical_kmer_codes(np.asarray(c, np.uint8), k)
        ok = _found_mask(codes, truth_sorted)
        per_contig_found.append(ok)
        total += codes.shape[0]
        missing += int((~ok).sum())
        if codes.shape[0]:
            idx = np.searchsorted(truth_sorted, codes[ok])
            found_truth[idx] = True

    if total == 0:
        qv = 0.0
    elif missing == 0:
        qv = qv_cap
    else:
        p = 1.0 - (1.0 - missing / total) ** (1.0 / k)
        qv = min(-10.0 * np.log10(max(p, 1e-12)), qv_cap)
    completeness = (
        float(found_truth.sum()) / truth_sorted.shape[0]
        if truth_sorted.shape[0]
        else 0.0
    )

    mis, anchors_mapped = _misassemblies(
        contigs, truth, k, anchor_stride, max_indel,
        truth_can=canonical_kmer_codes(truth, k)
        if len(truths) > 1
        else truth_can,
    )
    return {
        "qv": round(float(qv), 2),
        "completeness": round(completeness, 6),
        "misassemblies": int(mis),
        "contigKmers": int(total),
        "missingKmers": int(missing),
        "truthKmers": int(truth_sorted.shape[0]),
        "anchorsMapped": int(anchors_mapped),
    }


def _misassemblies(contigs, truth, k, stride, max_indel, truth_can=None):
    """Breakpoints in the unique-anchor chains of all contigs.

    Anchors are truth k-mers occurring exactly once among canonical
    truth k-mers; a contig anchor maps to a signed truth position
    (negative = reverse strand). Consecutive anchors must advance
    colinearly on one strand within ``max_indel`` slack.
    """
    if truth_can is None:
        truth_can = canonical_kmer_codes(truth, k)
    order = np.argsort(truth_can, kind="stable")
    sc = truth_can[order]
    first = np.ones(sc.shape[0], bool)
    first[1:] = sc[1:] != sc[:-1]
    cnt = np.diff(np.append(np.flatnonzero(first), sc.shape[0]))
    uniq_mask = cnt == 1
    uniq_codes = sc[first][uniq_mask]
    uniq_pos = order[first][uniq_mask]  # truth position of the one copy
    # Strand of the stored copy: canonical == forward there?
    fwd_codes = kmer_codes(truth, k)
    uniq_fwd = fwd_codes[uniq_pos] == uniq_codes

    breaks = 0
    mapped = 0
    for c in contigs:
        c = np.asarray(c, np.uint8)
        codes = canonical_kmer_codes(c, k)
        if codes.shape[0] == 0:
            continue
        pos_c = np.arange(0, codes.shape[0], max(stride, 1))
        sel = codes[pos_c]
        idx = np.searchsorted(uniq_codes, sel)
        idx = np.minimum(idx, max(uniq_codes.shape[0] - 1, 0))
        hit = (
            uniq_codes[idx] == sel
            if uniq_codes.shape[0]
            else np.zeros(sel.shape[0], bool)
        )
        if not hit.any():
            continue
        cpos = pos_c[hit]
        tpos = uniq_pos[idx[hit]].astype(np.int64)
        # Contig anchor strand: forward code at the contig position
        # equals the canonical code?
        cfwd = kmer_codes(c, k)[cpos] == sel[hit]
        # Same strand if contig-forwardness matches truth-forwardness.
        same = cfwd == uniq_fwd[idx[hit]]
        mapped += cpos.shape[0]
        if cpos.shape[0] < 2:
            continue
        dc = np.diff(cpos)
        dt = np.diff(tpos)
        expect = np.where(same[:-1], dt, -dt)
        ok = (
            (same[1:] == same[:-1])
            & (np.abs(expect - dc) <= max_indel)
        )
        breaks += int((~ok).sum())
    return breaks, mapped


def diploid_phasing_metrics(
    phased: Sequence[np.ndarray],
    hapA: np.ndarray,
    hapB: np.ndarray,
    k: int = 21,
) -> Dict:
    """Phase correctness of mode-2 output against known haplotypes.

    For each phased sequence, count k-mers SPECIFIC to haplotype A vs
    B (k-mers covering het sites); a correctly phased sequence is
    dominated by one side. Returns {phasedSequences, informative,
    meanPurity, purity90Fraction, hetKmerRecall}: purity = max(nA,nB)
    / (nA+nB) per informative sequence; hetKmerRecall = fraction of
    all hap-specific truth k-mers recovered somewhere in the phased
    output (phase switches drag purity down; dropped het regions drag
    recall down)."""
    ka = np.unique(canonical_kmer_codes(hapA, k))
    kb = np.unique(canonical_kmer_codes(hapB, k))
    only_a = np.setdiff1d(ka, kb, assume_unique=True)
    only_b = np.setdiff1d(kb, ka, assume_unique=True)
    n_inf = 0
    purities: List[float] = []
    seen_a = np.zeros(only_a.shape[0], bool)
    seen_b = np.zeros(only_b.shape[0], bool)
    for c in phased:
        codes = canonical_kmer_codes(np.asarray(c, np.uint8), k)
        ina = _found_mask(codes, only_a)
        inb = _found_mask(codes, only_b)
        na, nb = int(ina.sum()), int(inb.sum())
        if na + nb == 0:
            continue
        n_inf += 1
        purities.append(max(na, nb) / (na + nb))
        if na:
            seen_a[np.searchsorted(only_a, codes[ina])] = True
        if nb:
            seen_b[np.searchsorted(only_b, codes[inb])] = True
    total_het = only_a.shape[0] + only_b.shape[0]
    recall = (
        (int(seen_a.sum()) + int(seen_b.sum())) / total_het
        if total_het
        else 0.0
    )
    pur = np.asarray(purities)
    return {
        "phasedSequences": len(phased),
        "informative": n_inf,
        "meanPurity": round(float(pur.mean()), 4) if n_inf else 0.0,
        "purity90Fraction": (
            round(float((pur >= 0.9).mean()), 4) if n_inf else 0.0
        ),
        "hetKmerRecall": round(recall, 4),
    }


def phasing_switch_errors(
    phased: Sequence[np.ndarray],
    hapA: np.ndarray,
    hapB: np.ndarray,
    k: int = 21,
) -> Dict:
    """Positional switch analysis of phased output: walk each phased
    sequence's haplotype-specific k-mers IN ORDER and classify
    haplotype transitions. Distinguishes the two failure modes that
    whole-sequence purity conflates (a 10 Mb sequence at purity 0.86
    could be one 1.4 Mb mis-joined block or diffuse noise):

    - isolatedFlips: single informative sites disagreeing with both
      neighbors — consensus/marker-sampling noise at het sites, not a
      phasing error (Merqury-style graders likewise exclude
      short-range switches);
    - blockSwitches: remaining transitions = real phase switches
      between extended blocks.

    Returns {informativeSites, isolatedFlips, blockSwitches,
    switchRate (block switches per informative site), longestWrongRun
    (longest run of consecutive sites from the minority haplotype)}.
    """
    ka = np.unique(canonical_kmer_codes(hapA, k))
    kb = np.unique(canonical_kmer_codes(hapB, k))
    only_a = np.setdiff1d(ka, kb, assume_unique=True)
    only_b = np.setdiff1d(kb, ka, assume_unique=True)
    tot_sites = 0
    flips = 0
    switches = 0
    longest_wrong = 0
    for c in phased:
        codes = canonical_kmer_codes(np.asarray(c, np.uint8), k)
        ina = _found_mask(codes, only_a)
        inb = _found_mask(codes, only_b)
        pos = np.flatnonzero(ina | inb)
        if pos.shape[0] < 2:
            tot_sites += pos.shape[0]
            continue
        lab = inb[pos].astype(np.int8)  # 0 = hapA site, 1 = hapB site
        tot_sites += pos.shape[0]
        # Run-length collapse: one mis-called het SNP shows up as a
        # <= k-site run of the other haplotype (k k-mers cover each
        # SNP), so noise classification works at RUN granularity: an
        # interior run of <= k sites flanked by two runs of the same
        # (other) label is an isolated flip; transitions of the
        # remaining runs are block switches.
        bounds = np.flatnonzero(
            np.concatenate(([True], lab[1:] != lab[:-1], [True]))
        )
        r_len = np.diff(bounds)
        r_lab = lab[bounds[:-1]]
        keep = np.ones(r_len.shape[0], bool)
        for t in range(1, r_len.shape[0] - 1):
            if r_len[t] <= k and r_lab[t - 1] == r_lab[t + 1] != r_lab[t]:
                keep[t] = False
        n_flip = int((~keep).sum())
        flips += n_flip
        red = r_lab[keep]
        switches += int((red[1:] != red[:-1]).sum())
        # Longest minority-haplotype run (in sites).
        minority = 1 if int(lab.sum()) * 2 < lab.shape[0] else 0
        wrong = r_len[r_lab == minority]
        if wrong.shape[0]:
            longest_wrong = max(longest_wrong, int(wrong.max()))
    return {
        "informativeSites": int(tot_sites),
        "isolatedFlips": int(flips),
        "blockSwitches": int(switches),
        "switchRate": round(switches / tot_sites, 6) if tot_sites else 0.0,
        "longestWrongRun": int(longest_wrong),
    }


def parse_fasta_contigs(path: str) -> List[np.ndarray]:
    """Contig base-code arrays from a FASTA file (A=0 C=1 G=2 T=3)."""
    lut = np.full(256, 255, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
        lut[ch + 32] = i
    contigs: List[np.ndarray] = []
    cur: List[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if cur:
                    contigs.append(lut[np.frombuffer(b"".join(cur), np.uint8)])
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        contigs.append(lut[np.frombuffer(b"".join(cur), np.uint8)])
    return contigs


def parse_fasta_named(path: str) -> Tuple[List[str], List[np.ndarray]]:
    """Like :func:`parse_fasta_contigs` but also returns record names,
    so callers can grade segment classes separately (mode 2 writes
    PR.* phased-claim segments alongside UR.* unphased regions that
    are EXPECTED to mix haplotypes — grading them together understates
    phasing quality; reference segment naming: writePhased,
    src/AssemblyGraph2.cpp:1360)."""
    lut = np.full(256, 255, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
        lut[ch + 32] = i
    names: List[str] = []
    contigs: List[np.ndarray] = []
    cur: List[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if cur:
                    contigs.append(lut[np.frombuffer(b"".join(cur), np.uint8)])
                cur = []
                names.append(line[1:].split()[0].decode())
            else:
                cur.append(line.strip())
    if cur:
        contigs.append(lut[np.frombuffer(b"".join(cur), np.uint8)])
    return names, contigs
