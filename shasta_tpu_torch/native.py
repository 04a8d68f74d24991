"""ctypes bindings for the native C++ runtime components.

Compiles the repository's native/*.cpp on first use (g++ -O3 -shared)
into the port's own build directory (shasta_tpu_torch/build/native), so
it never shares an output file with another package's build; every
entry point has a pure-Python fallback, so the package works without a
toolchain.
Semantics of the native paths match the Python implementations exactly
(tests assert equality).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO_ROOT, "native", "shasta_native.cpp")
_SRCS = [
    _SRC,
    os.path.join(_REPO_ROOT, "native", "poa.cpp"),
]
_SO = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "build", "native",
    "libshasta_native.so",
)

_lib = None
_lock = threading.Lock()
_build_failed = False


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed or os.environ.get("SHASTA_TORCH_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is not None:
            return _lib
        try:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
                os.path.getmtime(f) for f in _SRCS
            ):
                os.makedirs(os.path.dirname(_SO), exist_ok=True)
                # Build under a per-process name and rename into place:
                # concurrent test workers never load a half-written file.
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17", "-pthread", *_SRCS, "-o", tmp],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _SO)
            _lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
    return _lib


def available() -> bool:
    return get_lib() is not None


def find_markers_native(flat, offsets, k: int, is_marker):
    """Fused threaded marker scan (count + fill); returns
    (moff, kmer_ids, positions) or None when unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    table = np.ascontiguousarray(is_marker, np.uint8)
    n_reads = offsets.shape[0] - 1
    per_read = np.empty(n_reads, np.int64)
    lib.markers_count(
        _u8p(flat), _i64p(offsets), ctypes.c_int64(n_reads),
        ctypes.c_int32(k), _u8p(table), _i64p(per_read),
    )
    moff = np.zeros(2 * n_reads + 1, np.int64)
    counts2 = np.empty(2 * n_reads, np.int64)
    counts2[0::2] = per_read
    counts2[1::2] = per_read
    np.cumsum(counts2, out=moff[1:])
    total = int(moff[-1])
    kmer_ids = np.empty(total, np.uint32)
    positions = np.empty(total, np.uint32)
    lib.markers_fill(
        _u8p(flat), _i64p(offsets), ctypes.c_int64(n_reads),
        ctypes.c_int32(k), _u8p(table), _i64p(moff),
        kmer_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return moff, kmer_ids, positions


def palindrome_keys_native(
    kmer_ids, koff, cum0, n_reads: int, k: int, d: int,
    max_bucket: int, kh_bits: int, sh_b: int, sh_r: int, n_pos0: int,
):
    """One-pass threaded key builder for the palindrome pre-filter;
    returns the unsorted 4*n_pos0 uint64 key array or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    kmer_ids = np.ascontiguousarray(kmer_ids, np.uint32)
    koff = np.ascontiguousarray(koff, np.int64)
    cum0 = np.ascontiguousarray(cum0, np.int64)
    out = np.empty(4 * n_pos0, np.uint64)
    lib.palindrome_keys(
        kmer_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _i64p(koff), _i64p(cum0), ctypes.c_int64(n_reads),
        ctypes.c_int32(k), ctypes.c_int64(d), ctypes.c_int64(max_bucket),
        ctypes.c_int32(kh_bits), ctypes.c_int32(sh_b), ctypes.c_int32(sh_r),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


def expand_unite_pairs_native(
    moff, counts, orid0, orid1, lo, hi, ord0_flat, ord1_flat
):
    """Threaded unite-pair expansion; returns (u, v) or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    moff = np.ascontiguousarray(moff, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    orid0 = np.ascontiguousarray(orid0, np.int64)
    orid1 = np.ascontiguousarray(orid1, np.int64)
    lo = np.ascontiguousarray(lo, np.int64)
    hi = np.ascontiguousarray(hi, np.int64)
    ord0_flat = np.ascontiguousarray(ord0_flat, np.uint32)
    ord1_flat = np.ascontiguousarray(ord1_flat, np.uint32)
    n_per = hi - lo
    pos = np.zeros(orid0.shape[0], np.int64)
    if pos.shape[0] > 1:
        np.cumsum(2 * n_per[:-1], out=pos[1:])
    total = int(2 * n_per.sum())
    u = np.empty(total, np.int64)
    v = np.empty(total, np.int64)
    lib.expand_unite_pairs(
        _i64p(moff), _i64p(counts), _i64p(orid0), _i64p(orid1),
        _i64p(lo), _i64p(hi), _i64p(pos),
        ctypes.c_int64(orid0.shape[0]),
        ord0_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ord1_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _i64p(u), _i64p(v),
    )
    return u, v


def unite_from_alignments_native(
    n: int, moff, counts, orid0, orid1, lo, hi, ord0_flat, ord1_flat
):
    """Streaming unite of every selected alignment's marker pairs (and
    their reverse complements) straight into the sequential min-root
    DSU — never materializes the pair arrays, the run's largest
    transient at scale. Returns min-id component labels or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    moff = np.ascontiguousarray(moff, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    orid0 = np.ascontiguousarray(orid0, np.int64)
    orid1 = np.ascontiguousarray(orid1, np.int64)
    lo = np.ascontiguousarray(lo, np.int64)
    hi = np.ascontiguousarray(hi, np.int64)
    # uint16 ordinal streams pass through without widening (the copy
    # would cost 4 bytes/match of transient RAM at genome scale).
    u16 = ord0_flat.dtype == np.uint16 and ord1_flat.dtype == np.uint16
    dt = np.uint16 if u16 else np.uint32
    ord0_flat = np.ascontiguousarray(ord0_flat, dt)
    ord1_flat = np.ascontiguousarray(ord1_flat, dt)
    label = np.arange(n, dtype=np.int64)
    lib.unite_from_alignments(
        _i64p(moff), _i64p(counts), _i64p(orid0), _i64p(orid1),
        _i64p(lo), _i64p(hi), ctypes.c_int64(orid0.shape[0]),
        ctypes.c_void_p(ord0_flat.ctypes.data),
        ctypes.c_void_p(ord1_flat.ctypes.data),
        ctypes.c_int64(1 if u16 else 0),
        ctypes.c_int64(n), _i64p(label),
    )
    return label


def union_find_min_labels_native(n: int, u, v):
    """Sequential min-root DSU; returns min-id component labels or
    None when the native library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    u = np.ascontiguousarray(u, np.int64)
    v = np.ascontiguousarray(v, np.int64)
    label = np.arange(n, dtype=np.int64)
    lib.union_find_min_labels(
        ctypes.c_int64(n), _i64p(u), _i64p(v),
        ctypes.c_int64(u.shape[0]), _i64p(label),
    )
    return label


def palindrome_scan_native(keys_sorted, sh_r: int, n_reads: int):
    """Fused group scan over the sorted palindrome keys; returns the
    per-read common-count array or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    keys_sorted = np.ascontiguousarray(keys_sorted, np.uint64)
    common = np.zeros(n_reads, np.int64)
    lib.palindrome_scan(
        keys_sorted.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(keys_sorted.shape[0]),
        ctypes.c_int32(sh_r),
        _i64p(common),
    )
    return common


def murmur64_features_native(features, seed: int):
    """Threaded one-pass MurmurHash64A over (n, m) uint32 rows, or
    None when the native library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    feats = np.ascontiguousarray(features, dtype=np.uint32)
    n, m = feats.shape
    out = np.empty(n, np.uint64)
    lib.murmur64_features(
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(n),
        ctypes.c_int64(m),
        ctypes.c_uint64(np.uint64(seed)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


# ---------------------------------------------------------------------------
# FASTA parse
# ---------------------------------------------------------------------------


def parse_fasta_native(data: bytes):
    """Parse FASTA bytes -> (codes uint8, offsets int64, names, metadata)
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    n_seqs = ctypes.c_int64()
    n_bases = ctypes.c_int64()
    buf = ctypes.create_string_buffer(data, n)
    lib.fasta_measure(buf, ctypes.c_int64(n), ctypes.byref(n_seqs), ctypes.byref(n_bases))
    ns, nb = n_seqs.value, n_bases.value
    codes = np.empty(nb, np.uint8)
    offsets = np.empty(ns + 1, np.int64)
    hb = np.empty(max(ns, 1), np.int64)
    he = np.empty(max(ns, 1), np.int64)
    lib.fasta_fill(buf, ctypes.c_int64(n), _u8p(codes), _i64p(offsets), _i64p(hb), _i64p(he))
    names = []
    metadata = []
    for i in range(ns):
        header = data[hb[i] : he[i]].decode(errors="replace").strip()
        name, _, meta = header.partition(" ")
        names.append(name)
        metadata.append(meta)
    return codes, offsets, names, metadata


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------


def rle_encode_native(codes: np.ndarray, offsets: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    ns = offsets.shape[0] - 1
    per_seq = np.empty(ns, np.int64)
    lib.rle_measure(
        _u8p(codes), _i64p(offsets), ctypes.c_int64(ns), _i64p(per_seq)
    )
    rle_offsets = np.zeros(ns + 1, np.int64)
    np.cumsum(per_seq, out=rle_offsets[1:])
    total = int(rle_offsets[-1])
    rle = np.empty(total, np.uint8)
    counts = np.empty(total, np.int64)
    lib.rle_fill(
        _u8p(codes), _i64p(offsets), ctypes.c_int64(ns),
        _u8p(rle), _i64p(counts), _i64p(rle_offsets),
    )
    return rle, counts, rle_offsets


def rle_encode_store_native(codes: np.ndarray, offsets: np.ndarray):
    """Read-store RLE encode: uint8 clipped counts + per-sequence
    long-run flags in one native pass (no wide count arrays)."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    ns = offsets.shape[0] - 1
    per_seq = np.empty(ns, np.int64)
    lib.rle_measure(
        _u8p(codes), _i64p(offsets), ctypes.c_int64(ns), _i64p(per_seq)
    )
    rle_offsets = np.zeros(ns + 1, np.int64)
    np.cumsum(per_seq, out=rle_offsets[1:])
    total = int(rle_offsets[-1])
    rle = np.empty(total, np.uint8)
    counts = np.empty(total, np.uint8)
    has_long = np.empty(max(ns, 1), np.uint8)
    lib.rle_fill_u8(
        _u8p(codes), _i64p(offsets), ctypes.c_int64(ns),
        _u8p(rle), _u8p(counts), _i64p(rle_offsets), _u8p(has_long),
    )
    return rle, counts, rle_offsets, has_long[:ns].astype(bool)


# ---------------------------------------------------------------------------
# Transitive reduction BFS phase
# ---------------------------------------------------------------------------


def transitive_reduction_bfs_native(mg, candidates: np.ndarray, max_distance: int) -> bool:
    """Run the BFS phase natively over mg.removed_tr (in place).
    Returns False if unavailable (caller falls back)."""
    lib = get_lib()
    if lib is None:
        return False
    removed = mg.removed_tr.astype(np.uint8)
    src = np.ascontiguousarray(mg.source, np.int64)
    tgt = np.ascontiguousarray(mg.target, np.int64)
    rc = np.ascontiguousarray(mg.rc_edge, np.int64)
    off = np.ascontiguousarray(mg._by_source_off, np.int64)
    bys = np.ascontiguousarray(mg._by_source, np.int64)
    cand = np.ascontiguousarray(candidates, np.int64)
    lib.transitive_reduction_bfs(
        ctypes.c_int64(mg.vertex_count),
        ctypes.c_int64(mg.edge_count),
        _i64p(src), _i64p(tgt), _i64p(rc), _i64p(off), _i64p(bys),
        _i64p(cand), ctypes.c_int64(cand.shape[0]),
        ctypes.c_int64(max_distance), _u8p(removed),
    )
    mg.removed_tr[:] = removed.astype(bool)
    return True


# ---------------------------------------------------------------------------
# Chimera flagging
# ---------------------------------------------------------------------------


def flag_chimeric_native(graph, n_reads: int, max_distance: int):
    """Returns is_chimeric bool array or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(n_reads, np.uint8)
    orid0 = np.ascontiguousarray(graph.orid0, np.int64)
    orid1 = np.ascontiguousarray(graph.orid1, np.int64)
    crosses = np.ascontiguousarray(graph.crosses_strands, np.uint8)
    adj_off = np.ascontiguousarray(graph.adj_offsets, np.int64)
    adj_e = np.ascontiguousarray(graph.adj_edges, np.int64)
    lib.flag_chimeric_reads(
        ctypes.c_int64(n_reads),
        ctypes.c_int64(graph.edge_count),
        _i64p(orid0), _i64p(orid1), _u8p(crosses),
        _i64p(adj_off), _i64p(adj_e),
        ctypes.c_int64(max_distance), _u8p(out),
    )
    return out.astype(bool)


def poa_msa_native(seqs):
    """Partial-order-alignment MSA (spoa equivalent, native/poa.cpp).

    seqs: list of uint8 arrays (base codes). Returns a list of aligned
    uint8 rows with 255 at gap positions, or None if the native
    library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(seqs)
    if n == 0:
        return []
    offsets = np.zeros(n + 1, np.int64)
    for i, q in enumerate(seqs):
        offsets[i + 1] = offsets[i] + q.shape[0]
    flat = (
        np.concatenate([np.ascontiguousarray(q, np.uint8) for q in seqs])
        if offsets[-1]
        else np.zeros(0, np.uint8)
    )
    fn = lib.poa_msa
    fn.restype = ctypes.c_int64
    max_cols = int(offsets[-1]) + 16
    while True:
        out = np.empty(n * max_cols, np.uint8)
        ncols = fn(
            _u8p(flat),
            _i64p(offsets),
            ctypes.c_int64(n),
            _u8p(out),
            ctypes.c_int64(max_cols),
        )
        if ncols < 0:
            return None
        if ncols <= max_cols:
            break
        max_cols = int(ncols)
    mat = out[: n * ncols].reshape(n, int(ncols)) if ncols else np.zeros(
        (n, 0), np.uint8
    )
    return [mat[i] for i in range(n)]


def edge_consensus_batch_native(
    fill_b: np.ndarray,
    fill_r: np.ndarray,
    fill_off: np.ndarray,
    iv_idx: np.ndarray,
    edge_iv_off: np.ndarray,
    mode: int,
    priors: Optional[np.ndarray] = None,
    likelihood: Optional[np.ndarray] = None,
):
    """Batched mode-2 marker-graph edge consensus (native/poa.cpp
    edge_consensus_batch, threaded): dedup + POA + column consensus
    per edge. mode 0=Modal, 1=Median, 2=Bayesian (pass the model's
    priors (2, ny) and likelihood (4, ny, nx) log10 matrices).

    Returns (seq uint8, rep int32, out_len int64 [n_edges]) with
    seq/rep COMPACTED (edge e's consensus is the out_len[e]-long slice
    at cumsum position), or None if the library is unavailable / an
    edge overflowed its bound.

    Edges are processed in chunks so the bound-sized output buffer
    (each edge's bound = its TOTAL fill length ~= coverage x the
    consensus length) stays ~256 MB: the single whole-batch buffer
    was ~10 GB of the assembleMarkerGraphEdges 27.8 GB RSS peak at
    SCALE=50 (memprof r4)."""
    lib = get_lib()
    if lib is None:
        return None
    fill_b = np.ascontiguousarray(fill_b, np.uint8)
    fill_r = np.ascontiguousarray(fill_r, np.uint8)
    fill_off = np.ascontiguousarray(fill_off, np.int64)
    iv_idx = np.ascontiguousarray(iv_idx, np.int64)
    edge_iv_off = np.ascontiguousarray(edge_iv_off, np.int64)
    n_edges = edge_iv_off.shape[0] - 1
    # Bound: each edge's consensus is at most its total fill length.
    lens = fill_off[iv_idx + 1] - fill_off[iv_idx]
    per_edge = np.add.reduceat(
        lens, edge_iv_off[:-1]
    ) if n_edges else np.zeros(0, np.int64)
    per_edge = np.where(np.diff(edge_iv_off) > 0, per_edge, 0)
    bound_cum = np.cumsum(per_edge)
    if mode == 2:
        priors = np.ascontiguousarray(priors, np.float64)
        likelihood = np.ascontiguousarray(likelihood, np.float64)
        ny, nx = likelihood.shape[1], likelihood.shape[2]
        pp = priors.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        lp = likelihood.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    else:
        ny = nx = 0
        pp = lp = ctypes.POINTER(ctypes.c_double)()
    fn = lib.edge_consensus_batch
    fn.restype = ctypes.c_int64
    CAP = 1 << 28
    seq_parts, rep_parts, len_parts = [], [], []
    e0 = 0
    while e0 < n_edges:
        base = int(bound_cum[e0 - 1]) if e0 else 0
        e1 = int(np.searchsorted(bound_cum, base + CAP, side="right")) + 1
        e1 = max(e0 + 1, min(e1, n_edges))
        nb = e1 - e0
        out_off = np.zeros(nb + 1, np.int64)
        np.cumsum(per_edge[e0:e1], out=out_off[1:])
        out_b = np.empty(int(out_off[-1]), np.uint8)
        out_r = np.empty(int(out_off[-1]), np.int32)
        out_len = np.zeros(nb, np.int64)
        eoff = np.ascontiguousarray(edge_iv_off[e0 : e1 + 1])
        rc = fn(
            _u8p(fill_b), _u8p(fill_r), _i64p(fill_off),
            _i64p(iv_idx), _i64p(eoff), ctypes.c_int64(nb),
            ctypes.c_int32(mode),
            pp, lp, ctypes.c_int64(ny), ctypes.c_int64(nx),
            _u8p(out_b), out_r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _i64p(out_off), _i64p(out_len),
        )
        if rc != 0:
            return None
        # Compact this chunk: gather each edge's real consensus run.
        n_cols = int(out_len.sum())
        src = np.repeat(out_off[:-1], out_len) + (
            np.arange(n_cols, dtype=np.int64)
            - np.repeat(
                np.concatenate(([0], np.cumsum(out_len)[:-1])), out_len
            )
        )
        seq_parts.append(out_b[src])
        rep_parts.append(out_r[src])
        len_parts.append(out_len)
        e0 = e1
    return (
        np.concatenate(seq_parts) if seq_parts else np.zeros(0, np.uint8),
        np.concatenate(rep_parts) if rep_parts else np.zeros(0, np.int32),
        np.concatenate(len_parts) if len_parts else np.zeros(0, np.int64),
    )


def near_strand_jump_native(graph, n_reads: int, max_distance: int):
    """Per-oriented-read near-strand-jump flags (strand separation
    method 1 phase 1), or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(2 * n_reads, np.uint8)
    lib.near_strand_jump(
        ctypes.c_int64(n_reads),
        _i64p(np.ascontiguousarray(graph.orid0, np.int64)),
        _i64p(np.ascontiguousarray(graph.orid1, np.int64)),
        _i64p(np.ascontiguousarray(graph.adj_offsets, np.int64)),
        _i64p(np.ascontiguousarray(graph.adj_edges, np.int64)),
        ctypes.c_int64(max_distance),
        _u8p(out),
    )
    return out.astype(bool)


def cross_strand_edges2_native(graph, pairs_in_order: np.ndarray):
    """Strand separation method 2's sequential DSU sweep (reference:
    flagCrossStrandReadGraphEdges2, src/AssemblerReadGraph.cpp:1051),
    or None if the native library is unavailable. Sets
    graph.crosses_strands in place and returns the flagged count."""
    lib = get_lib()
    if lib is None:
        return None
    crosses = np.ascontiguousarray(graph.crosses_strands, np.uint8)
    n_flagged = np.zeros(1, np.int64)
    lib.cross_strand_edges2(
        ctypes.c_int64(graph.n_oriented_reads),
        _i64p(np.ascontiguousarray(graph.orid0, np.int64)),
        _i64p(np.ascontiguousarray(graph.orid1, np.int64)),
        _i64p(np.ascontiguousarray(pairs_in_order, np.int64)),
        ctypes.c_int64(pairs_in_order.shape[0]),
        _u8p(crosses),
        _i64p(n_flagged),
    )
    graph.crosses_strands[:] = crosses.astype(bool)
    return int(n_flagged[0])

def strict_interval_hashes_native(rle_bases, read_offsets, orid, pos0, pos1, k: int):
    """Dual 64-bit polynomial content hashes of strict-edge intervals,
    threaded, straight from the read store (no flat expansion).
    Returns (h1, h2) uint64 arrays or None when unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    rle = np.ascontiguousarray(rle_bases, np.uint8)
    ro = np.ascontiguousarray(read_offsets, np.int64)
    o = np.ascontiguousarray(orid, np.int64)
    p0 = np.ascontiguousarray(pos0, np.int64)
    p1 = np.ascontiguousarray(pos1, np.int64)
    n = o.shape[0]
    h1 = np.empty(n, np.uint64)
    h2 = np.empty(n, np.uint64)
    lib.strict_interval_hashes(
        _u8p(rle), _i64p(ro), _i64p(o), _i64p(p0), _i64p(p1),
        ctypes.c_int64(n), ctypes.c_int64(k),
        h1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        h2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return h1, h2


def counting_sort_by_key_native(key, starts):
    """Stable grouping order for a dense int64 key (one linear native
    pass; the numpy equivalent is a full argsort). ``starts`` are the
    exclusive prefix sums of the per-key counts. Returns order int64
    or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    key = np.ascontiguousarray(key, np.int64)
    next_pos = np.ascontiguousarray(starts, np.int64).copy()
    order = np.empty(key.shape[0], np.int64)
    lib.counting_sort_by_key(
        _i64p(key), ctypes.c_int64(key.shape[0]), _i64p(next_pos),
        _i64p(order),
    )
    return order


def counting_sort_by_key32_native(key, starts, n_out=None):
    """32-bit variant of :func:`counting_sort_by_key_native` (int32
    keys and order, negative keys skipped): half the index-array RAM
    for grouping 10^8 markers, and the skip rule builds filtered CSRs
    (e.g. vertex -> kept markers from vertex_table with INVALID = -1)
    in one pass without a flatnonzero index vector. Returns order
    int32 (length n_out, default = key length) or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    key = np.ascontiguousarray(key, np.int32)
    next_pos = np.ascontiguousarray(starts, np.int64).copy()
    order = np.empty(
        key.shape[0] if n_out is None else int(n_out), np.int32
    )
    lib.counting_sort_by_key32(
        _i32p(key), ctypes.c_int64(key.shape[0]), _i64p(next_pos),
        _i32p(order),
    )
    return order
