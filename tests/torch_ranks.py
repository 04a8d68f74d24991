"""Inputs and rank bodies for the port's mesh tests (numpy, torch and the
port only, so that the card tests can use them without jax).

A rank body is a module-level function ``fn(mesh, *args)`` that
``shasta_tpu_torch.parallel.distributed.spawn`` runs on every rank of a
spawned world; it returns host values, which are pickled back.
"""

import hashlib
import importlib
import json
import os
import time

import numpy as np

from tests.torch_common import SMALL_CONF, stage_hashes

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def golden_mismatches(run_dir, mode):
    """The golden values of ``mode`` (tests/golden/mode{mode}_stage_hashes.json:
    stage manifests, and mode 2's pinned output files) that ``run_dir``
    does not give."""
    with open(os.path.join(GOLDEN_DIR, f"mode{mode}_stage_hashes.json")) as f:
        want = json.load(f)
    got = stage_hashes(run_dir)
    bad = []
    for name, h in want.items():
        if name.startswith("file:"):
            with open(os.path.join(run_dir, name[5:]), "rb") as f:
                ok = hashlib.sha256(f.read()).hexdigest() == h
        else:
            ok = got.get(name) == h
        if not ok:
            bad.append(name)
    return bad


def small_config():
    """tests/test_assembly_e2e.py:small_config on the port's class."""
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    cfg = AssemblyConfig()
    for section, key, value in SMALL_CONF:
        cfg.set(section, key, value)
    return cfg


def pallas_test_batch(seed, B=8, LA=128, LB=128, W=128, alpha=50):
    """tests/test_align_pallas.py:make_batch (a copy, without jax)."""
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LB), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    for t in range(B):
        g = rng.integers(0, alpha, 400).astype(np.int32)
        la = int(rng.integers(20, LA))
        lb = int(rng.integers(20, LB))
        sa = int(rng.integers(0, 100))
        sb = max(0, sa + int(rng.integers(-20, 20)))
        a[t, :la] = g[sa : sa + la]
        b[t, :lb] = g[sb : sb + lb]
        a_len[t] = la
        b_len[t] = lb
        bm[t] = -W // 2
    return a, a_len, b, b_len, bm


def candidate_markers(pkg="shasta_tpu_torch"):
    """tests/test_sharded_lowhash.py:test_sharded_candidates_match_host's
    reads (genome seed 61, 80 reads of 3 kb, seed 62) and markers (k 8,
    probability 0.1, seed 231), built with the modules of ``pkg`` (the
    port, or "shasta_tpu" for the JAX package's, with tests/synth.py)."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    synth = mod("utils.synth") if pkg == "shasta_tpu_torch" else importlib.import_module("tests.synth")
    genome = synth.random_genome(20000, seed=61)
    reads = synth.sample_reads(genome, 80, 3000, seed=62, both_strands=True)
    fasta = b"".join(
        b">r%d\n%s\n" % (i, mod("data.bases").decode_to_str(r).encode())
        for i, r in enumerate(reads)
    )
    store = mod("data.reads").build_read_store(mod("io.fasta").parse_fasta_bytes(fasta))
    kt = mod("data.kmers").select_kmers_random(8, 0.1, seed=231)
    return mod("data.markers").find_markers(store, kt)


LOWHASH = dict(m=4, hash_fraction=0.05, iteration_count=4, min_frequency=2, max_bucket_size=60)


def mesh_inputs():
    """The mesh tests' inputs, each from its seed:
    - ``features``: dryrun_multichip(8)'s (N, 4) uint32 (rng 1);
    - ``markers``: :func:`candidate_markers` with the port's modules;
    - ``uf``: tests/test_sharded_lowhash.py's union-find edges (rng 3,
      n 4096, 8192 edges);
    - ``fwd``: its banded-forward batch (rng 4: B 16, LA 64, W 32, self
      alignments);
    - ``pallas``: tests/test_align_pallas.py:make_batch(9, B=6), the batch
      of test_mesh_take_feed_matches_single_device, with its CSR rows, its
      aux ordinals (rng 13) and the 6 live pairs padded to 8;
    - ``dry``: dryrun_multichip(8)'s full_step inputs (rng 1)."""
    out = {}
    rng = np.random.default_rng(1)
    N, B, E, n_markers = 512, 64, 256, 256
    features = rng.integers(0, 2**32, (N, 4), dtype=np.uint32)
    genome = rng.integers(0, 8192, 512).astype(np.int32)
    a = np.stack([genome[s % 64 : s % 64 + 128] for s in range(B)])
    b = np.stack([genome[s % 64 + 8 : s % 64 + 8 + 128] for s in range(B)])
    u = rng.integers(0, n_markers, E).astype(np.int32)
    v = rng.integers(0, n_markers, E).astype(np.int32)
    out["features"] = features
    out["dry"] = (
        features, a, np.full(B, 128, np.int32), b, np.full(B, 128, np.int32),
        np.full(B, -64, np.int32), u, v, n_markers,
    )
    out["markers"] = candidate_markers()

    rng = np.random.default_rng(3)
    out["uf"] = (
        4096, rng.integers(0, 4096, 8192).astype(np.int32),
        rng.integers(0, 4096, 8192).astype(np.int32),
    )

    rng = np.random.default_rng(4)
    fa = rng.integers(0, 50, (16, 64)).astype(np.int32)
    out["fwd"] = (
        fa, np.full(16, 64, np.int32), fa.copy(), np.full(16, 64, np.int32),
        np.full(16, -16, np.int32),
    )

    a, a_len, b, b_len, bm = pallas_test_batch(9, B=6)
    out["pallas"] = (a, a_len, b, b_len, bm)
    rows = [a[t, : a_len[t]] for t in range(6)] + [b[t, : b_len[t]] for t in range(6)]
    lens = np.array([r.shape[0] for r in rows], np.int32)
    off = np.zeros(lens.shape[0] + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    rng = np.random.default_rng(13)
    aux = np.concatenate([
        np.sort(rng.choice(4 * int(n), size=int(n), replace=False)).astype(np.int32)
        for n in lens
    ])
    ia = np.concatenate([np.arange(6), np.zeros(2)]).astype(np.int64)
    ib = np.concatenate([np.arange(6, 12), np.zeros(2)]).astype(np.int64)
    al = lens[ia].astype(np.int32)
    bl = lens[ib].astype(np.int32)
    al[6:] = 0
    bl[6:] = 0
    out["csr"] = (np.concatenate(rows).astype(np.int32), off, lens, aux)
    out["take"] = (ia, ib, al, bl, np.concatenate([bm, np.zeros(2, np.int32)]))
    return out


KW = dict(match=6, mismatch=-1, gap=-1)


def mesh_functions(mesh, inp):
    """Every sharded function of parallel/mesh.py on ``inp``
    (:func:`mesh_inputs`); host values."""
    from shasta_tpu_torch.ops.align import _DeviceCsr
    from shasta_tpu_torch.ops.lowhash import LowHashParams
    from shasta_tpu_torch.parallel import mesh as M

    out = {}
    out["lowhash"] = M.fetch_tree(M.sharded_lowhash_step(mesh, inp["features"], 3, 8))
    out["candidates"] = M.sharded_find_candidates(
        mesh, inp["markers"], LowHashParams(**LOWHASH)
    )
    n, u, v = inp["uf"]
    out["uf"] = {
        r: M.fetch(M.sharded_union_find(mesh, n, u, v, n_rounds=r)) for r in (2, 24)
    }
    out["uf_labels"] = M.sharded_union_find_labels(mesh, n, u, v)
    out["fwd"] = M.fetch_tree(M.sharded_banded_forward(mesh, *inp["fwd"], W=32, **KW))
    out["ftb"] = M.fetch(
        M.sharded_forward_traceback(mesh, *inp["fwd"], W=32, n_steps=128, **KW)
    )
    out["pallas"] = M.fetch(
        M.sharded_pallas_align(mesh, *inp["pallas"], LA=128, LB=128, W=128, **KW)
    )
    flat, off, lens, aux = inp["csr"]
    csr = _DeviceCsr(flat, off, lens, mesh.device, aux=aux)
    ia, ib, al, bl, bm = inp["take"]
    ra, rb = csr.local[ia], csr.local[ib]
    m, o = csr.matrix(128), csr.aux_matrix(128)
    out["take"] = M.fetch(M.sharded_align_take(
        mesh, m, ra, m, rb, al, bl, bm, LA=128, LB=128, W=128, **KW
    ))
    out["band"] = M.fetch(M.sharded_band_take(
        mesh, m, ra, o, m, rb, o, al, bl, bm, LA=128, LB=128, W=128, **KW
    ))
    *dry, n_markers = inp["dry"]
    out["full_step"] = M.fetch_tree(
        M.full_step(mesh, *dry, n_markers, W=128, log2_buckets=8)
    )
    out["calls"] = dict(mesh.calls)
    out["seconds"] = mesh.seconds
    out["ranks_per_device"] = mesh.ranks_per_device
    from shasta_tpu_torch.ops import align_kernel as AK

    out["launches"] = dict(AK.LAUNCHES)
    return out


def distributed_run(mesh, fastas, run_dir, mode):
    """``run_assembly_distributed`` on this world, small_config (mode 0)
    or the mode-2 golden configuration; returns (rank, summary or None,
    the mesh's collective calls, seconds)."""
    from shasta_tpu_torch.parallel import distributed as D
    from tests.torch_common import mode2_golden_config

    cfg = small_config() if mode == 0 else mode2_golden_config()
    t0 = time.perf_counter()
    summary = D.run_assembly_distributed(fastas, run_dir, cfg, device=mesh.device)
    return mesh.rank, summary, time.perf_counter() - t0


def dealt_reads(mesh, fastas):
    """What each rank would assemble if the input files were dealt out
    with ``shard_input_files`` (the JAX package's run_assembly_distributed):
    (the files, the number of reads), on every rank."""
    import tempfile

    from shasta_tpu_torch.parallel import distributed as D
    from shasta_tpu_torch.pipeline.assemble import Assembler

    files = D.shard_input_files(fastas)
    with tempfile.TemporaryDirectory() as td:
        a = Assembler(os.path.join(td, "run"), small_config(), device=mesh.device)
        a.add_reads(files)
        n = a.reads.read_count
    return files, n, D.allgather_to_hosts(np.array([n], np.int64)).tolist()


def two_files(mesh, fastas, run_dir):
    """Two input files on two ranks: what :func:`dealt_reads` gives, then
    ``run_assembly_distributed`` on both files."""
    dealt = dealt_reads(mesh, fastas)
    return dealt, distributed_run(mesh, fastas, run_dir, 0)


def peer_counts(mesh):
    """``ranks_per_device`` of this world's mesh, then of meshes built
    while every rank reports a card of its own UUID, and while all report
    one UUID (``device_key`` names a card by its UUID, whatever index
    ``CUDA_VISIBLE_DEVICES`` gives it)."""
    from unittest import mock

    from shasta_tpu_torch.parallel import mesh as M

    out = [mesh.ranks_per_device]
    for key in (lambda dev: f"card-{mesh.rank}", lambda dev: "card-0"):
        with mock.patch.object(M, "device_key", key):
            out.append(M.Mesh(mesh.group, mesh.backend, mesh.device).ranks_per_device)
    return out
