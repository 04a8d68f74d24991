"""Shared pieces of the port's tests (numpy and torch only, so that the
tests that run on the card need neither jax nor shasta_tpu)."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs several test workers on a few cores; one intra-op
    thread per worker keeps the plain DP's many small ops from
    oversubscribing them (OpenMP spin-waits made it 40x slower).
    Applies to each test module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(seed, B=8, LA=128, LB=128, W=128, alpha=50):
    """Pairs cut from one random sequence with offsets inside the band
    (real matches), random substitutions, one empty pair, and bands
    partly or wholly outside the matrix."""
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LB), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    for t in range(B):
        g = rng.integers(0, alpha, LA + LB + 200).astype(np.int32)
        la = int(rng.integers(1, LA + 1))
        lb = int(rng.integers(1, LB + 1))
        sa = int(rng.integers(0, 100))
        sb = max(0, sa + int(rng.integers(-20, 20)))
        a[t, :la] = g[sa : sa + la]
        b[t, :lb] = g[sb : sb + lb]
        sub = rng.random(la) < 0.1
        a[t, :la][sub] = rng.integers(0, alpha, int(sub.sum()))
        a_len[t], b_len[t] = la, lb
        bm[t] = -W // 2 + int(rng.integers(-W // 4, W // 4 + 1))
    a_len[0] = 0  # empty pair
    bm[1] = -(LA + W) - 3  # band wholly left of the matrix
    bm[2] = LB + 1  # band wholly right of the matrix
    bm[3] = -(LA + W)  # band at the clamp limit
    return a, a_len, b, b_len, bm


def edge_batch(LA=128, W=128):
    """The batch of test_align_pallas.py::test_edge_cases_match_jnp_kernel
    (LA = LB): empty pairs, length-1 sequences, bands at both clamp
    limits, a full-length identical pair and padding rows."""
    B = 8
    rng = np.random.default_rng(9)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LA), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    g = rng.integers(0, 30, 300).astype(np.int32)
    b[0, :50] = g[:50]
    b_len[0] = 50
    a[1, :50] = g[:50]
    a_len[1] = 50
    a[2, 0] = b[2, 0] = 7
    a_len[2] = b_len[2] = 1
    for t, band in ((3, -(LA + W)), (4, LA)):
        a[t, :60] = b[t, :60] = g[:60]
        a_len[t] = b_len[t] = 60
        bm[t] = band
    a[5] = b[5] = g[:LA]
    a_len[5] = b_len[5] = LA
    return a, a_len, b, b_len, bm


def gap_batch(LA=256, W=128, seed=11):
    """Pairs whose alignments carry long gaps, so that a traceback path
    crosses 32-lane chunks of the band both ways: b with an insertion of
    length L (a run of LEFT moves, walked back towards lane 0) and a
    with an insertion of length L (a run of UP moves, walked back
    towards lane W - 1), L in {40, 70}, the band placed so that the path
    starts near one end of it."""
    rng = np.random.default_rng(seed)
    B = 8
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LA), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    n = LA - 80
    for t in range(B):
        L = (40, 70)[t % 2]
        g = rng.integers(0, 1000, n).astype(np.int32)
        ins = rng.integers(1000, 2000, L).astype(np.int32)
        cut = n // 3 + 7 * t
        long_ = np.concatenate([g[:cut], ins, g[cut:]])
        if t < B // 2:  # insertion in b: j - i grows by L
            a[t, :n], b[t, : n + L] = g, long_
            a_len[t], b_len[t] = n, n + L
            bm[t] = -(W // 8) - (t % 3)
        else:  # insertion in a: j - i falls by L
            a[t, : n + L], b[t, :n] = long_, g
            a_len[t], b_len[t] = n + L, n
            bm[t] = -L - (W // 8) + (t % 3)
    return a, a_len, b, b_len, bm


def mixed_batch(LA=128, W=128, B=13, seed=21):
    """Pairs of very different lengths side by side, as the waves kernel
    puts them in one warp: a_len cycles through 0, 1, 2, 17, LA // 2, LA
    and LA + 40 (clamped to LA rows), b_len within 5 of it, each pair a
    copy of one sequence with 10% substitutions and its band centred near
    the diagonal."""
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LA), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    cycle = [0, 1, 2, 17, LA // 2, LA, LA + 40]
    for t in range(B):
        g = rng.integers(0, 50, 2 * LA).astype(np.int32)
        la = cycle[t % len(cycle)]
        lb = min(LA, max(1, la + int(rng.integers(-5, 6))))
        n = min(la, LA)
        a[t, :n] = g[:n]
        b[t, :lb] = g[:lb]
        sub = rng.random(n) < 0.1
        a[t, :n][sub] = rng.integers(0, 50, int(sub.sum()))
        a_len[t], b_len[t] = la, lb
        bm[t] = -(W // 2) + int(rng.integers(-(W // 8), W // 8 + 1))
    return a, a_len, b, b_len, bm


# tests/test_assembly_e2e.py:small_config as (section, key, value) overrides
# of the configuration defaults.
SMALL_CONF = [
    ("Reads", "minReadLength", "500"), ("Kmers", "k", "8"),
    ("Kmers", "probability", "0.1"), ("MinHash", "hashFraction", "0.05"),
    ("MinHash", "minHashIterationCount", "6"), ("MinHash", "maxBucketSize", "60"),
    ("Align", "minAlignedMarkerCount", "20"), ("Align", "maxSkip", "60"),
    ("Align", "maxDrift", "60"), ("Align", "maxTrim", "60"),
    ("ReadGraph", "maxAlignmentCount", "8"), ("MarkerGraph", "minCoverage", "3"),
]


def mode2_golden_config(cfg=None):
    """tests/test_reference_parity.py:_golden_run_mode2's configuration
    on the port's class: ``cfg`` (default: SMALL_CONF on the defaults)
    with mode 2, minEdgeCoverage 3, per strand 0 and bubble-removal
    component-size threshold 3."""
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    if cfg is None:
        cfg = AssemblyConfig()
        for section, key, value in SMALL_CONF:
            cfg.set(section, key, value)
    cfg.assembly.mode = 2
    cfg.marker_graph.min_edge_coverage = 3
    cfg.marker_graph.min_edge_coverage_per_strand = 0
    cfg.assembly.mode2_bubble_removal_component_size_threshold = 3
    return cfg


def write_mode2_reads(path):
    """_golden_run_mode2's reads, made with the port's utils/synth.py:
    two 15 kb haplotypes with a SNP every 700 bases, 90 + 90 reads of
    2.5 kb from both strands."""
    from shasta_tpu_torch.utils import synth

    rng = np.random.default_rng(4343)
    hap_a = synth.random_genome(15000, seed=4444)
    hap_b = hap_a.copy()
    for p in np.arange(350, 15000, 700):
        hap_b[p] = (hap_b[p] + 1 + rng.integers(0, 3)) % 4
    reads = synth.sample_reads(hap_a, 90, 2500, seed=4445, both_strands=True)
    reads += synth.sample_reads(hap_b, 90, 2500, seed=4446, both_strands=True)
    synth.write_fasta(path, reads)


def stage_hashes(run_dir):
    """tests/test_reference_parity.py:_stage_hashes: sha256 over each
    array's name, dtype, shape and bytes, per stage manifest."""
    import hashlib

    from shasta_tpu_torch.data.store import RunStore

    store = RunStore(run_dir, create=False)
    out = {}
    for stage in sorted(store.stage_names()):
        h = hashlib.sha256()
        arrays = store.load_stage(stage)
        for name in sorted(arrays):
            a = np.ascontiguousarray(arrays[name])
            h.update(name.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        out[stage] = h.hexdigest()
    return out


# Method 4's grouped route: (a length, b length, band width, pairs). The
# W classes 128, 512 and 2048, each at an LA where fwd_body gives the
# anti-diagonal body and at one where it gives the row-scan body; widths
# 300 and 1500 are centred inside their class.
GROUPED = [
    (100, 110, 97, 3), (120, 90, 300, 2), (400, 420, 300, 3),
    (400, 380, 1500, 2), (900, 950, 1500, 2), (1000, 990, 2048, 1),
]


def grouped_inputs(cases=GROUPED, seed=404):
    """Host rows for ``_grouped_run``: b a shifted copy of a with 10%
    substitutions, each band on the pair's diagonal, off centre by up to
    an eighth of its width."""
    rng = np.random.default_rng(seed)
    a_rows, b_rows, bmins, widths = [], [], [], []
    for la, lb, w, n in cases:
        for _ in range(n):
            g = rng.integers(0, 300, la + lb).astype(np.int32)
            shift = int(rng.integers(0, 30))
            a = g[:la].copy()
            b = g[shift : shift + lb].copy()
            hit = rng.random(lb) < 0.1
            b[hit] = rng.integers(0, 300, int(hit.sum()))
            a_rows.append(a)
            b_rows.append(b)
            bmins.append(-shift - w // 2 + int(rng.integers(-(w // 8), w // 8 + 1)))
            widths.append(w)
    return a_rows, b_rows, np.asarray(bmins, np.int64), np.asarray(widths, np.int64)


def wide_batch(LA=64, W=16400, B=2, seed=31):
    """Pairs in a band wider than 16384 lanes, the widest whose rows the
    row-scan body keeps in shared memory; past it the card runs each row
    in tiles of 16384 lanes. b is long enough (LB = W + LA) that every
    lane of the band lies inside the matrix on some row. Each pair's a
    is a stretch of b with 10% substitutions, and b carries an insertion
    of L bases halfway along it, placed so that the path's lane jumps
    across a multiple of 16384 (a run of LEFT moves that the prefix max
    carries from one tile to the next). Odd pairs end on b's last column
    three rows before a's last row; the band starts at lane 0 or up to 2
    lanes left of j - i = 0."""
    LB = W + LA
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LB), -2, np.int32)
    a_len = np.full(B, LA, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    n_edges = max(1, (W - 1) // 16384)
    for t in range(B):
        edge = 16384 * (1 + (t // 2) % n_edges)
        L = max(2, min(LA // 2, 2 * (W - edge) - 8))
        c = edge - L // 2
        cut = LA // 2
        x = rng.integers(0, 50, LA).astype(np.int32)
        bg = rng.integers(0, 50, LB).astype(np.int32)
        bg[c : c + cut] = x[:cut]
        bg[c + cut + L : c + L + LA] = x[cut:]
        sub = rng.random(LA) < 0.1
        x[sub] = rng.integers(0, 50, int(sub.sum()))
        a[t] = x
        b_len[t] = LB if t % 2 == 0 else c + L + LA - 3
        b[t, : b_len[t]] = bg[: b_len[t]]
        bm[t] = -(t % 3)
    return a, a_len, b, b_len, bm


def palindrome_reads(n=6):
    """The first ``n`` reads of the mode-0 golden input (a 25 kb genome,
    seed 4242; 130 reads of 3 kb from both strands, seed 4243), made
    with the port's utils/synth.py, and one palindromic read: 1.5 kb of
    the golden genome followed by its reverse complement."""
    from shasta_tpu_torch.data import bases as B
    from shasta_tpu_torch.utils import synth

    genome = synth.random_genome(25000, seed=4242)
    reads = synth.sample_reads(genome, 130, 3000, seed=4243, both_strands=True)[:n]
    half = genome[1000:2500]
    return reads + [np.concatenate([half, B.reverse_complement(half)])]
