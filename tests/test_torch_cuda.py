"""The port's CUDA kernels on the card, against their plain version.

These tests need an NVIDIA card and skip without one. They import
neither jax nor shasta_tpu, so they also run on a machine that has only
PyTorch; there, skip the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is exact integer equality: the DP is int32 arithmetic
with a fixed tie-break, so kernel and plain version agree bit for bit.
"""

import numpy as np
import pytest
import torch

from shasta_tpu_torch.ops import align as A
from shasta_tpu_torch.ops import align_kernel as K
from shasta_tpu_torch.utils import peak, synth
from tests.torch_common import (
    compact_batch, compact_reference, edge_batch, full_matrix_batch, gap_batch,
    make_batch, mixed_batch, wide_batch,
)

KW = dict(match=6, mismatch=-1, gap=-1)
# The score sets of tests/test_torch_row_scan.py: dead-lane codes 3, 1, 3.
SCORE_SETS = [KW, dict(match=6, mismatch=0, gap=-1), dict(match=6, mismatch=-1, gap=-2)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "LA,W", [(128, 512), (2048, 128), (1024, 2048), (8192, 512), (512, 8192)]
)
def test_kernels_match_plain_on_card(card, LA, W):
    """Both CUDA kernels against the plain version on the same inputs:
    the fused (B, 16 + LA) output is equal, and each kernel launched.
    W 8192 runs the forward kernel's 16-lanes-per-thread instantiation."""
    a, a_len, b, b_len, bm = make_batch(LA, B=8, LA=LA, LB=LA, W=W)
    args = [torch.from_numpy(x).to(card) for x in (a, a_len, b, b_len, bm)]
    kw = dict(LA=LA, LB=LA, W=W, **KW)
    before = dict(K.LAUNCHES)
    got = K.banded_align_pairs(*args, **kw)
    ref = K.banded_align_pairs_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert int(got[:, 0].sum()) > 0  # the batch has real alignments
    assert K.LAUNCHES["banded_fwd"] > before["banded_fwd"]
    assert K.LAUNCHES["banded_tb"] > before["banded_tb"]


def fwd_tb_errors(args, LA, W, LB=None, scores=KW):
    """Each banded_fwd body that takes W against banded_fwd_plain (every
    dirs word of a processed row, best, bi, bd), banded_tb against
    banded_tb_plain on the plain dirs, and the fused output against
    banded_align_pairs_plain: the names of the outputs that differ.
    LB defaults to LA."""
    LB = LA if LB is None else LB
    kw = dict(LA=LA, LB=LB, W=W, **scores)
    pa, pal, pb, pbl, pbm = K.prepare_inputs(*args, LA=LA, LB=LB, W=W)
    pdirs, pbest, pbi, pbd = K.banded_fwd_plain(pa, pal, pb, pbl, pbm, **kw)
    rows = (torch.arange(K.n_words(LA), device=pa.device)[None, :] * 16) < pal[:, None]
    bad = []
    for body in ("diag", "rows") if W <= K.DIAG_W_LIMIT else ("rows",):
        dirs, best, bi, bd = K._banded_fwd_body(body, pa, pal, pb, pbl, pbm, **kw)
        if bool(((dirs != pdirs) & rows[:, :, None]).any()):
            bad.append(f"{body} dirs")
        for name, x, y in (("best", best, pbest), ("bi", bi, pbi), ("bd", bd, pbd)):
            if not torch.equal(x, y):
                bad.append(f"{body} {name}")
    mj = K.banded_tb(pdirs, pbi, pbd, pbm, LA=LA, W=W)
    if not torch.equal(mj, K.banded_tb_plain(pdirs, pbi, pbd, pbm, LA=LA, W=W)):
        bad.append("tb")
    if not torch.equal(K.banded_align_pairs(*args, **kw), K.banded_align_pairs_plain(*args, **kw)):
        bad.append("fused")
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize(
    "LA,W", [(256, 33), (128, 288), (256, 511), (128, 2049), (1, 128), (17, 512)]
)
def test_forward_bodies_match_plain_on_card(card, LA, W):
    """banded_fwd's anti-diagonal body (W <= DIAG_W_LIMIT) and row-scan
    body at widths that are not a multiple of 32 and at LA 1 and 17,
    and banded_tb, word for word against the plain version."""
    a, a_len, b, b_len, bm = make_batch(LA + W, B=8, LA=LA, LB=LA, W=W)
    args = [torch.from_numpy(x).to(card) for x in (a, a_len, b, b_len, bm)]
    assert fwd_tb_errors(args, LA, W) == []


@pytest.mark.cuda
@pytest.mark.parametrize("W", [16383, 16384, 16385, 16400, 20480, 40000])
def test_row_scan_body_past_16384_matches_plain_on_card(card, W):
    """Bands around and past 16384 lanes, whose live window (b of W + LA)
    passes what one block holds: the row-scan body runs them on a
    thread-block cluster. Its forward output, the traceback and the
    fused output equal the plain version bit for bit on paths that cross
    lane 16384 (tests/torch_common.py:wide_batch, LA 256, 4 pairs; up to
    16384 lanes, where no path can cross it, make_batch with b of
    W + LA)."""
    LA = 256
    if W > 16384:
        host = wide_batch(LA, W, B=4)
    else:
        host = make_batch(W, B=4, LA=LA, LB=W + LA, W=W)
    args = [torch.from_numpy(x).to(card) for x in host]
    assert K.fwd_body(LA, W) == "rows"
    before = dict(K.LAUNCHES)
    assert fwd_tb_errors(args, LA, W, LB=host[2].shape[1]) == []
    assert K.LAUNCHES["banded_fwd"] > before["banded_fwd"]
    assert K.LAUNCHES["banded_tb"] > before["banded_tb"]


# Windows (LB + 2 columns) at each switch point of the row-scan body
# (ops/align_kernel.py:rows_plan): the warp tier's K = 5, 9 (32 K +- 1),
# the block tier's edge with the cluster's (2048 +- 1), the cluster's
# step from 4 to 8 columns a thread (4096 +- 1), and its edge with the
# strips (32768 +- 1).
WINDOWS = [159, 160, 161, 287, 288, 289, 2047, 2048, 2049, 4095, 4096, 4097, 32767,
           32768, 32769]


@pytest.mark.cuda
@pytest.mark.parametrize("S", WINDOWS)
def test_row_scan_switch_points_match_plain_on_card(card, S):
    """Full-matrix bands whose widest window is S columns (LA 24, LB =
    S - 2, one pair with b_len = LB, one empty pair): the row-scan body,
    the traceback and the fused output equal the plain version bit for
    bit."""
    LA, LB = 24, S - 2
    W = LA + LB + 8
    host = full_matrix_batch(LA, W, B=5, seed=S, LB=LB, empty=True)
    assert K.rows_plan(LA, LB, W)["window"] == S
    args = [torch.from_numpy(x).to(card) for x in host]
    before = K.LAUNCHES["banded_fwd"]
    assert fwd_tb_errors(args, LA, W, LB=LB) == []
    assert K.LAUNCHES["banded_fwd"] > before


# Launch shapes rows_plan does not pick at these sizes: one block of few
# threads, clusters of 2 to 5 blocks, and strips of 128 and 256 columns
# (the strip path, which rows_plan reaches only past 32768 columns).
PLANS = [
    dict(tier="block", cols_per_thread=8, threads=96, blocks=1),
    dict(tier="cluster", cols_per_thread=4, threads=96, blocks=2),
    dict(tier="cluster", cols_per_thread=8, threads=32, blocks=3),
    dict(tier="cluster", cols_per_thread=4, threads=32, blocks=5),
    dict(tier="cluster", cols_per_thread=4, threads=32, blocks=2),
    dict(tier="block", cols_per_thread=4, threads=32, blocks=1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["full", "sliding"])
@pytest.mark.parametrize("k", range(len(PLANS)))
def test_row_scan_plans_match_plain_on_card(card, k, batch):
    """The row-scan body under each launch shape of PLANS equals the
    plain version bit for bit: full-matrix bands of up to 602 columns
    (LA 40, LB 600, an empty pair) and bands sliding along b (LA = LB =
    256, W 64, a window of 258 columns), so that the last two shapes
    sweep 3 to 5 strips."""
    if batch == "full":
        LA, LB = 40, 600
        W = LA + LB + 8
        host = full_matrix_batch(LA, W, B=6, seed=k, LB=LB, empty=True)
    else:
        LA = LB = 256
        W = 64
        host = make_batch(k, B=6, LA=LA, LB=LB, W=W)
    plan = dict(PLANS[k], window=min(LB + 2, LA + W))
    cap = plan["cols_per_thread"] * plan["threads"] * plan["blocks"]
    plan["strips"] = -(-plan["window"] // cap)
    kw = dict(LA=LA, LB=LB, W=W, **KW)
    args = [torch.from_numpy(x).to(card) for x in host]
    pa, pal, pb, pbl, pbm = K.prepare_inputs(*args, LA=LA, LB=LB, W=W)
    dirs, best, bi, bd = K._banded_fwd_body("rows", pa, pal, pb, pbl, pbm, plan=plan, **kw)
    pdirs, pbest, pbi, pbd = K.banded_fwd_plain(pa, pal, pb, pbl, pbm, **kw)
    torch.cuda.synchronize()
    rows = (torch.arange(K.n_words(LA), device=card)[None, :] * 16) < pal[:, None]
    assert not bool(((dirs != pdirs) & rows[:, :, None]).any())
    for x, y in ((best, pbest), (bi, pbi), (bd, pbd)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("scores", range(len(SCORE_SETS)))
@pytest.mark.parametrize("S", [160, 514, 4098, 32769])
def test_row_scan_score_sets_match_plain_on_card(card, S, scores):
    """The three score sets (dead-lane codes 3, 1, 3) at a window of each
    tier, with an empty pair: the row-scan body equals the plain
    version."""
    LA, LB = 40, S - 2
    W = LA + LB + 8
    host = full_matrix_batch(LA, W, B=6, seed=S + scores, LB=LB, empty=True)
    args = [torch.from_numpy(x).to(card) for x in host]
    assert fwd_tb_errors(args, LA, W, LB=LB, scores=SCORE_SETS[scores]) == []


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 512])
@pytest.mark.parametrize("batch", ["edge", "gap"])
def test_special_batches_match_plain_on_card(card, batch, W):
    """The edge-case batch (empty pairs, length-1 sequences, bands at
    both clamp limits, a full-length identical pair) and the long-gap
    batch (traceback paths across 32-lane chunks, both ways) on both
    forward bodies and banded_tb, word for word against the plain
    version."""
    LA = 128 if batch == "edge" else 256
    host = edge_batch(LA, W) if batch == "edge" else gap_batch(LA, W)
    args = [torch.from_numpy(x).to(card) for x in host]
    assert fwd_tb_errors(args, LA, W) == []


@pytest.mark.cuda
@pytest.mark.parametrize("waves", [2, 4])
@pytest.mark.parametrize(
    "LA,W,batch",
    [(2048, 128, "make"), (1024, 2048, "make"), (128, 33, "mixed"),
     (128, 128, "mixed"), (256, 512, "mixed")],
)
def test_waves_kernel_matches_plain_on_card(card, LA, W, batch, waves):
    """banded_fwd_waves, 2 or 4 pairs per warp, against the plain
    version: dirs of every processed row, best, bi, bd and the fused
    output are equal. B = 11 and 13 leave the last block partly empty;
    the mixed batch puts pairs of a_len 0, 1, 2, 17, LA / 2, LA and
    LA + 40 in one warp."""
    if batch == "make":
        host = make_batch(LA + waves, B=11, LA=LA, LB=LA, W=W)
    else:
        host = mixed_batch(LA, W, B=13)
    args = [torch.from_numpy(x).to(card) for x in host]
    kw = dict(LA=LA, LB=LA, W=W, **KW)
    pa, pal, pb, pbl, pbm = K.prepare_inputs(*args, LA=LA, LB=LA, W=W)
    before = K.LAUNCHES["banded_fwd_waves"]
    dirs, best, bi, bd = K.banded_fwd_waves(pa, pal, pb, pbl, pbm, waves=waves, **kw)
    pdirs, pbest, pbi, pbd = K.banded_fwd_plain(pa, pal, pb, pbl, pbm, **kw)
    got = K.banded_align_pairs(*args, waves=waves, **kw)
    ref = K.banded_align_pairs_plain(*args, **kw)
    torch.cuda.synchronize()
    rows = (torch.arange(K.n_words(LA), device=card)[None, :] * 16) < pal[:, None]
    assert not bool(((dirs != pdirs) & rows[:, :, None]).any())
    for x, y in ((best, pbest), (bi, pbi), (bd, pbd)):
        assert torch.equal(x, y)
    assert torch.equal(got, ref)
    assert int(got[:, 0].sum()) > 0
    assert K.LAUNCHES["banded_fwd_waves"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("devq", ["default", "0", "mixed"])
def test_align_candidates_card_matches_cpu(card, devq, monkeypatch):
    """align_candidates on the card (kernels) and on the CPU (plain
    version) give equal AlignmentStores, dtypes included. The card's
    phase-2 batches are collected by match_compact ("default"), all
    drained early and scattered on the host (SHASTA_TORCH_DEVQ_MB=0), or
    both in one call ("mixed": 4-pair flushes under a 32 KiB budget)."""
    from shasta_tpu_torch.data.kmers import select_kmers_random
    from shasta_tpu_torch.data.markers import find_markers
    from shasta_tpu_torch.data.reads import build_read_store
    from shasta_tpu_torch.io.fasta import parse_fasta_bytes
    from shasta_tpu_torch.ops import lowhash as LH
    from shasta_tpu_torch.data import bases as B

    genome = synth.random_genome(6000, seed=17)
    reads = synth.sample_reads(
        genome, 14, 1700, seed=18, error_rate=0.01, both_strands=True
    )
    fasta = b"".join(
        b">r%d\n%s\n" % (i, B.decode_to_str(r).encode())
        for i, r in enumerate(reads)
    )
    kt = select_kmers_random(10, 0.1, seed=231)
    markers = find_markers(
        build_read_store(parse_fasta_bytes(fasta), min_read_length=500), kt
    )
    cand = LH.find_candidates_lowhash(
        markers,
        LH.LowHashParams(
            m=3, hash_fraction=0.05, iteration_count=10, min_frequency=2,
            max_bucket_size=60,
        ),
    )
    params = A.AlignParams(
        min_aligned_marker_count=12, max_skip=60, max_drift=60, max_trim=60
    )
    args = (markers, cand.read_id0, cand.read_id1, cand.same_strand, params,
            kt.downsampling_hash_table())
    on_cpu = A.align_candidates(*args, device="cpu")
    if devq == "0":
        monkeypatch.setenv("SHASTA_TORCH_DEVQ_MB", "0")
    elif devq == "mixed":
        monkeypatch.setattr(A, "_FLUSH_PAIRS", 4)

        class Mixed(A._CsrStreamingRunner):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self._drain_budget = 32 << 10

        monkeypatch.setattr(A, "_CsrStreamingRunner", Mixed)
    before, compacts = K.LAUNCHES["banded_fwd"], K.COMPACT_LAUNCHES
    on_card = A.align_candidates(*args, device=card)
    assert K.LAUNCHES["banded_fwd"] > before
    assert K.COMPACT_LAUNCHES - compacts == A.COLLECT["device"]
    assert (A.COLLECT["device"] > 0) == (devq != "0")
    assert (A.COLLECT["host"] > 0) == (devq != "default")
    assert on_cpu.count > 0
    ga, ra = on_card.arrays(), on_cpu.arrays()
    for k, v in ra.items():
        assert ga[k].dtype == v.dtype, k
        assert np.array_equal(ga[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("keep", ["some", "all", "none"])
@pytest.mark.parametrize("LA", [128, 4096, 32768])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_match_compact_matches_plain_on_card(card, dtype, LA, keep):
    """csrc/match_compact.cu against match_compact_plain on the card and
    a numpy loop over the rows, at LA classes 128, 4096 and 32768: no
    row kept, every row kept, every other row; rows with no match; the
    kept rows' slots in another order than the batch's; uint16 and
    uint32 output (values past 65,535 in the uint32 case). One launch,
    counted apart from the DP kernels' LAUNCHES."""
    fused, dst, n = compact_batch(64 if LA < 32768 else 16, LA, keep=keep,
                                  big=dtype == np.uint32, seed=LA)
    tdt = torch.int16 if dtype == np.uint16 else torch.int32
    f, d = torch.from_numpy(fused).to(card), torch.from_numpy(dst).to(card)
    got = [torch.zeros(n, dtype=tdt, device=card) for _ in range(2)]
    ref = [torch.zeros(n, dtype=tdt, device=card) for _ in range(2)]
    before, dp = K.COMPACT_LAUNCHES, dict(K.LAUNCHES)
    K.match_compact(f, d, *got)
    K.match_compact_plain(f, d, *ref)
    torch.cuda.synchronize()
    assert K.COMPACT_LAUNCHES == before + 1 and K.LAUNCHES == dp
    want = compact_reference(fused, dst, n, dtype)
    for g, r, w in zip(got, ref, want):
        assert torch.equal(g, r)
        assert np.array_equal(g.cpu().numpy().view(dtype), w)


@pytest.mark.cuda
def test_match_compact_scalar_loads_on_card(card):
    """The kernel's one-column-a-thread body, taken where LA is not a
    multiple of 4 or the rows are not 16-byte aligned: LA 130, and LA
    128 on a view that starts one element into its storage."""
    for LA, shift in ((130, 0), (128, 1)):
        fused, dst, n = compact_batch(40, LA, seed=LA + shift)
        store = torch.zeros(fused.size + shift, dtype=torch.int32, device=card)
        f = store[shift:].view(fused.shape)
        f.copy_(torch.from_numpy(fused))
        assert (f.data_ptr() % 16 != 0) == bool(shift)
        d = torch.from_numpy(dst).to(card)
        got = [torch.zeros(n, dtype=torch.int16, device=card) for _ in range(2)]
        K.match_compact(f, d, *got)
        torch.cuda.synchronize()
        want = compact_reference(fused, dst, n, np.uint16)
        for g, w in zip(got, want):
            assert np.array_equal(g.cpu().numpy().view(np.uint16), w)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 512, 2048])
def test_grouped_run_matches_plain_on_card(card, W):
    """Method 4's grouped route on the card against the CPU run (the
    plain version) on the cases of one W class: per-pair matches and
    metrics equal, and the kernels launched."""
    from tests.torch_common import GROUPED, grouped_inputs

    cases = [c for c in GROUPED if A._bucket(c[2], A._W_BUCKETS) == W]
    a_rows, b_rows, bmins, widths = grouped_inputs(cases)
    params = A.AlignParams()
    before = dict(K.LAUNCHES)
    got, met = A._grouped_run(a_rows, b_rows, bmins, widths, params, device=card)
    want, want_met = A._grouped_run(a_rows, b_rows, bmins, widths, params, device="cpu")
    assert K.LAUNCHES["banded_tb"] > before["banded_tb"]
    assert np.array_equal(met, want_met) and (met[:, 0] > 0).all()
    for (g0, g1), (w0, w1) in zip(got, want):
        assert np.array_equal(g0, w0) and np.array_equal(g1, w1)


@pytest.mark.cuda
def test_mode2_golden_run_on_card(card, tmp_path):
    """The mode-2 golden run (tests/test_reference_parity.py:
    _golden_run_mode2's input and configuration) on the card: all 17
    values of tests/golden/mode2_stage_hashes.json."""
    import hashlib
    import json
    import os

    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from tests.torch_common import mode2_golden_config, stage_hashes, write_mode2_reads

    fasta = str(tmp_path / "reads.fasta")
    write_mode2_reads(fasta)
    run_dir = str(tmp_path / "run")
    before = K.LAUNCHES["banded_tb"]
    run_assembly([fasta], run_dir, mode2_golden_config(), device=card)
    assert K.LAUNCHES["banded_tb"] > before
    with open(os.path.join(os.path.dirname(__file__), "golden", "mode2_stage_hashes.json")) as f:
        pinned = json.load(f)
    got = stage_hashes(run_dir)
    for key in pinned:
        if key.startswith("file:"):
            with open(os.path.join(run_dir, key[5:]), "rb") as f:
                got[key] = hashlib.sha256(f.read()).hexdigest()
    assert got == pinned


@pytest.mark.cuda
def test_mesh_functions_one_rank_nccl_match_plain(card):
    """Every sharded function of parallel/mesh.py on a one-rank NCCL world
    on the card equals the same function on a one-rank gloo world on the
    CPU (the plain version), on the mesh tests' inputs
    (tests/torch_ranks.py); the card's rank launched both kernels."""
    from shasta_tpu_torch.parallel.distributed import spawn
    from tests import torch_ranks as TR

    inp = TR.mesh_inputs()
    (gpu,) = spawn(TR.mesh_functions, 1, device="cuda", args=(inp,), timeout=600)
    (cpu,) = spawn(TR.mesh_functions, 1, device="cpu", args=(inp,), timeout=600)
    for key in ("lowhash", "fwd", "full_step"):
        assert all(np.array_equal(x, y) for x, y in zip(gpu[key], cpu[key])), key
    for key in ("ftb", "pallas", "take", "band", "uf_labels"):
        assert np.array_equal(gpu[key], cpu[key]), key
    for r in gpu["uf"]:
        assert np.array_equal(gpu["uf"][r], cpu["uf"][r]), r
    for f in ("read_id0", "read_id1", "same_strand", "frequency"):
        assert np.array_equal(getattr(gpu["candidates"], f), getattr(cpu["candidates"], f)), f
    assert gpu["launches"]["banded_fwd"] > 0 and gpu["launches"]["banded_tb"] > 0
    assert cpu["launches"] == {k: 0 for k in cpu["launches"]}
    # NCCL spans are CUDA events: one per collective call, read at the end.
    assert set(gpu["seconds"]) == set(gpu["calls"])
    assert all(s > 0 for s in gpu["seconds"].values()), gpu["seconds"]
    assert gpu["ranks_per_device"] == 1


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(card, tmp_path):
    """run_assembly_distributed on two gloo ranks that share the card, the
    kernels on the card: every golden value of the mode-0 golden input
    holds in both ranks' run directories."""
    from shasta_tpu_torch.parallel.distributed import spawn
    from tests import torch_ranks as TR

    g = synth.random_genome(25000, seed=4242)
    fa = str(tmp_path / "r.fasta")
    synth.write_fasta(fa, synth.sample_reads(g, 130, 3000, seed=4243, both_strands=True))
    run_dir = str(tmp_path / "run")
    outs = spawn(
        TR.distributed_run, 2, device="cuda", backend="gloo",
        args=([fa], run_dir, 0), timeout=600,
    )
    assert outs[0][1]["alignmentCount"] == 1992 and outs[1][1] is None
    assert TR.golden_mismatches(run_dir, 0) == []
    assert TR.golden_mismatches(str(tmp_path / "run" / ".process1"), 0) == []


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 1, 2, 5, 256])
@pytest.mark.parametrize("values", ["bench", "full"])
def test_int32_chain_matches_plain_on_card(card, K, values):
    """csrc/int32_peak.cu against int32_chain_plain on the card, modulo
    2**32: bench.py's (1024, 512) tile and value range, and 100,003 values
    over the whole int32 range (a ragged last block); it launched."""
    rng = np.random.default_rng(K)
    if values == "bench":
        x = rng.integers(-1000, 1000, (1024, 512)).astype(np.int32)
    else:
        x = rng.integers(-(2**31), 2**31, 100_003).astype(np.int32)
    t = torch.from_numpy(x).to(card)
    before = peak.LAUNCHES["int32_chain"]
    got = peak.int32_chain(t, K)
    ref = peak.int32_chain_plain(t, K)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == t.shape
    assert torch.equal((got.long() - ref.long()) % 2**32, torch.zeros_like(got, dtype=torch.long))
    assert peak.LAUNCHES["int32_chain"] == before + 1


@pytest.mark.cuda
def test_bench_roofline_graphs_on_card(card):
    """The bench's roofline on the card: each chain captured in a CUDA
    graph, whose first replay must equal the chain called from Python
    (bench.graphed raises otherwise); both timings give positive rates."""
    from shasta_tpu_torch import bench as PB

    rep, eager, first = PB.kernel_roofline_prepare(card, K0=1, K1=3)
    for gcells, pairs in (rep(), eager()):
        assert gcells > 0 and pairs > 0
    assert first != 0


@pytest.mark.cuda
def test_bench_graph_keeps_its_inputs(card):
    """bench.graphed's replay keeps the function it captured, and so the
    tensors the graph reads: a replay after every other reference to them
    is gone, and their memory could be handed out again, gives the
    captured output."""
    from shasta_tpu_torch import bench as PB

    def doubled_sum(n):
        x = torch.arange(n, dtype=torch.int64, device=card)
        return lambda: (x * 2).sum()

    replay = PB.graphed(doubled_sum(1 << 20))
    want = (1 << 20) * ((1 << 20) - 1)
    assert replay().item() == want
    junk = [torch.full((1 << 20,), 7, dtype=torch.int64, device=card) for _ in range(8)]
    assert replay().item() == want
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("waves", [2, 4])
def test_bench_roofline_waves_on_card(card, waves):
    """The roofline chain at waves 2 and 4 (waves_ab's variants) launches
    banded_fwd_waves and gives the waves-1 chain's output; on the whole
    roofline batch banded_align_pairs at that waves equals the plain
    version bit for bit."""
    from shasta_tpu_torch import bench as PB

    want = PB.kernel_roofline_prepare(card, K0=1, K1=2, waves=1)[2]
    before = K.LAUNCHES["banded_fwd_waves"]
    rep, _eager, first = PB.kernel_roofline_prepare(card, K0=1, K1=2, waves=waves)
    assert first == want
    assert K.LAUNCHES["banded_fwd_waves"] > before
    assert rep()[0] > 0
    args = [torch.from_numpy(x).to(card) for x in PB.roofline_batch()]
    kw = dict(LA=args[0].shape[1], LB=args[2].shape[1], W=PB.ROOFLINE_W, **PB.SCORES)
    assert torch.equal(K.banded_align_pairs(*args, waves=waves, **kw),
                       K.banded_align_pairs_plain(*args, **kw))
