"""Driver entry points: the core compute step, and a multi-rank dry run.

Counterparts of ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``) for the port:

- ``entry()`` returns the core compute step (the batched banded
  marker-alignment DP forward, the pipeline's dominant kernel) and
  example arguments on the card (or on the CPU when asked).
- ``dryrun_multichip(n)`` spawns an n-rank ``torch.distributed`` world
  and runs, on every rank: one full sharded step (LowHash hashing with
  the histogram all-reduced, data-parallel banded alignment, union-find
  min-hooking with an all-reduce MIN), sharded LowHash candidates against
  the host implementation, and the whole pipeline on the mesh against
  the single-device pipeline in modes 0 and 2. Its inputs are the JAX
  dry run's, drawn from the same ``np.random.default_rng(1)`` in the same
  order, so the line it prints equals the JAX ``dryrun_multichip(n)``'s.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from shasta_tpu_torch.ops import align_kernel as AK


def entry(device="cuda"):
    """(step, args): ``step(*args)`` is each pair's best DP score from
    the forward kernel (its plain version for ``device="cpu"``)."""
    B, LA, LB, W = 8, 128, 128, 128
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 8192, 256).astype(np.int32)
    a = np.stack([genome[s : s + LA] for s in range(B)])
    b = np.stack([genome[s + 16 : s + 16 + LB] for s in range(B)])
    a_len = np.full(B, LA, np.int32)
    b_len = np.full(B, LB, np.int32)
    band_min = np.full(B, -W // 2, np.int32)

    def step(a, a_len, b, b_len, band_min):
        args = AK.prepare_inputs(a, a_len, b, b_len, band_min, LA=LA, LB=LB, W=W)
        _dirs, best, _bi, _bd = AK.banded_fwd(
            *args, LA=LA, LB=LB, W=W, match=6, mismatch=-1, gap=-1
        )
        return best

    dev = AK.resolve_device(device)
    args = tuple(
        torch.from_numpy(x).to(dev) for x in (a, a_len, b, b_len, band_min)
    )
    return step, args


def _check(ok, what) -> None:
    if not ok:
        raise AssertionError(what)


def _same_files(dir0, dir1, names, what) -> None:
    for name in names:
        with open(os.path.join(dir0, name), "rb") as f:
            b0 = f.read()
        with open(os.path.join(dir1, name), "rb") as f:
            b1 = f.read()
        _check(b0 == b1, f"{what}: {name}")


def dryrun_rank(mesh, n_devices: int) -> str:
    """The dry run's body on one rank of an ``n_devices``-rank world;
    returns the summary line (the same on every rank)."""
    from shasta_tpu_torch.data import bases as _B
    from shasta_tpu_torch.data.markers import MarkerStore
    from shasta_tpu_torch.ops import lowhash as LH
    from shasta_tpu_torch.parallel.mesh import fetch_tree, full_step, sharded_find_candidates
    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    _check(mesh.size == n_devices, f"mesh of {mesh.size} ranks, asked {n_devices}")
    rng = np.random.default_rng(1)

    N = 64 * n_devices  # features
    m = 4
    B = 8 * n_devices  # candidate pairs
    LA = LB = 128
    W = 128
    E = 32 * n_devices  # unite pairs
    n_markers = 256

    features = rng.integers(0, 2**32, (N, m), dtype=np.uint32)
    genome = rng.integers(0, 8192, 512).astype(np.int32)
    a = np.stack([genome[s % 64 : s % 64 + LA] for s in range(B)])
    b = np.stack([genome[s % 64 + 8 : s % 64 + 8 + LB] for s in range(B)])
    a_len = np.full(B, LA, np.int32)
    b_len = np.full(B, LB, np.int32)
    band_min = np.full(B, -W // 2, np.int32)
    u = rng.integers(0, n_markers, E).astype(np.int32)
    v = rng.integers(0, n_markers, E).astype(np.int32)

    hist, best_val, label = fetch_tree(full_step(
        mesh, features, a, a_len, b, b_len, band_min, u, v, n_markers,
        W=W, log2_buckets=8,
    ))
    _check(hist.sum() == N, (hist.sum(), N))
    _check(best_val.shape == (B,) and (best_val > 0).all(), best_val)
    _check(label.shape == (n_markers,), label.shape)
    # Labels must be valid representatives (idempotent mapping).
    _check((label[label] == label).all(), "labels are not representatives")

    # Sharded LowHash candidate generation (the bucket all_to_all over
    # the ranks) must reproduce the host implementation exactly.
    n_or = 8 * n_devices
    counts = np.full(n_or, 24, np.int64)
    offsets = np.zeros(n_or + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    base = rng.integers(0, 4096, 40, dtype=np.uint32)
    kmer_ids = np.concatenate(
        [base[(s % 8) : (s % 8) + 24] for s in range(n_or)]
    ).astype(np.uint32)
    ms = MarkerStore(
        k=6,
        kmer_ids=kmer_ids,
        positions=np.zeros(kmer_ids.shape[0], np.uint32),
        offsets=offsets,
    )
    params = LH.LowHashParams(
        m=4, hash_fraction=0.5, iteration_count=2, min_frequency=1,
        max_bucket_size=64,
    )
    host = LH.find_candidates_lowhash(ms, params)
    shard = sharded_find_candidates(mesh, ms, params)
    _check(shard.count == host.count, (shard.count, host.count))

    def _key(c):
        return np.lexsort((c.same_strand, c.read_id1, c.read_id0))

    kh, ks = _key(host), _key(shard)
    for f in ("read_id0", "read_id1", "same_strand", "frequency"):
        _check(np.array_equal(getattr(host, f)[kh], getattr(shard, f)[ks]), f)

    # Miniature end-to-end assembly on the mesh: the real pipeline
    # (LowHash all-to-all, sharded alignment batches, sharded union-find)
    # must produce output identical to the single-device path.
    g = rng.integers(0, 4, 15000).astype(np.uint8)
    starts = rng.integers(0, 13000, 80)
    reads = [g[s : s + 2000] for s in starts]
    reads = [
        r if i % 2 == 0 else _B.reverse_complement(r)
        for i, r in enumerate(reads)
    ]
    cfg = AssemblyConfig()
    cfg.reads.min_read_length = 500
    cfg.kmers.k = 8
    cfg.kmers.probability = 0.1
    cfg.min_hash.hash_fraction = 0.05
    cfg.min_hash.min_hash_iteration_count = 4
    cfg.min_hash.max_bucket_size = 60
    cfg.align.min_aligned_marker_count = 20
    cfg.align.max_skip = 60
    cfg.align.max_drift = 60
    cfg.align.max_trim = 60
    cfg.read_graph.max_alignment_count = 8
    cfg.marker_graph.min_coverage = 3
    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "reads.fasta")
        with open(fa, "wb") as f:
            for i, r in enumerate(reads):
                f.write(b">r%d\n%s\n" % (i, _B.decode_to_str(r).encode()))
        s_host = run_assembly([fa], os.path.join(td, "host"), cfg, device=mesh.device)
        s_mesh = run_assembly([fa], os.path.join(td, "mesh"), cfg, mesh=mesh)
        _check(
            s_host["alignmentCount"] == s_mesh["alignmentCount"],
            (s_host["alignmentCount"], s_mesh["alignmentCount"]),
        )
        _same_files(
            os.path.join(td, "host"), os.path.join(td, "mesh"), ["Assembly.fasta"],
            "mesh pipeline output diverged",
        )
        _check(s_mesh["totalAssembledSegmentLength"] > 10000, s_mesh)

    # Diploid (mode 2) on the mesh: strict edges + AssemblyGraph2 +
    # phasing replicate deterministically too.
    g2 = rng.integers(0, 4, 12000).astype(np.uint8)
    hapB = g2.copy()
    for p in range(300, 12000, 600):
        hapB[p] = (hapB[p] + 1) % 4
    reads2 = []
    for i, s in enumerate(rng.integers(0, 10000, 120)):
        src = g2 if i % 2 == 0 else hapB
        r = src[s : s + 2000]
        reads2.append(r if i % 4 < 2 else _B.reverse_complement(r))
    cfg2 = AssemblyConfig()
    for attr, val in vars(cfg.reads).items():
        setattr(cfg2.reads, attr, val)
    cfg2.reads.min_read_length = 500
    cfg2.kmers.k = 8
    cfg2.kmers.probability = 0.1
    cfg2.min_hash.hash_fraction = 0.05
    cfg2.min_hash.min_hash_iteration_count = 4
    cfg2.min_hash.max_bucket_size = 60
    cfg2.align.min_aligned_marker_count = 20
    cfg2.align.max_skip = 60
    cfg2.align.max_drift = 60
    cfg2.align.max_trim = 60
    cfg2.read_graph.max_alignment_count = 8
    cfg2.marker_graph.min_coverage = 3
    cfg2.assembly.mode = 2
    cfg2.marker_graph.min_edge_coverage = 3
    cfg2.marker_graph.min_edge_coverage_per_strand = 0
    cfg2.assembly.mode2_bubble_removal_component_size_threshold = 3
    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "reads.fasta")
        with open(fa, "wb") as f:
            for i, r in enumerate(reads2):
                f.write(b">r%d\n%s\n" % (i, _B.decode_to_str(r).encode()))
        run_assembly([fa], os.path.join(td, "host"), cfg2, device=mesh.device)
        m2_mesh = run_assembly([fa], os.path.join(td, "mesh"), cfg2, mesh=mesh)
        _same_files(
            os.path.join(td, "host"), os.path.join(td, "mesh"),
            ["Assembly-Phased.fasta", "Assembly-Haploid.fasta", "Assembly-Detailed.gfa"],
            "mode-2 mesh output diverged",
        )
        mode2_note = (
            f"mode2 mesh == host ({m2_mesh.get('phasedBubbleCount', 0)} "
            "bubbles phased)"
        )

    return (
        f"dryrun_multichip({n_devices}): ok — "
        f"hist_total={int(hist.sum())}, mean_align_score={best_val.mean():.1f}, "
        f"components={len(np.unique(label))}, "
        f"sharded_lowhash_candidates={shard.count} (== host), "
        f"e2e mesh assembly == host assembly "
        f"({s_mesh['totalAssembledSegmentLength']} bases), "
        f"{mode2_note}"
    )


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 900.0) -> str:
    """Spawn ``n_devices`` ranks (``parallel.distributed.spawn``: NCCL on
    cards, gloo on the CPU), run :func:`dryrun_rank` on each, print rank
    0's line and return it. Any rank's failure raises."""
    from shasta_tpu_torch.parallel.distributed import spawn

    lines = spawn(
        dryrun_rank, n_devices, device=device, args=(n_devices,), timeout=timeout,
    )
    _check(len(set(lines)) == 1, f"ranks disagree: {lines}")
    print(lines[0], flush=True)
    return lines[0]
