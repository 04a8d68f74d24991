"""The port's banded DP (shasta_tpu_torch.ops.align_kernel) against the
JAX package's kernel and oracle.

Every comparison is exact integer equality: the DP is int32 arithmetic
with a fixed tie-break, so the port must reproduce the reference bit for
bit. On the CPU the port runs its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode (the monkeypatch of
tests/test_align_pallas.py) or its jnp oracle.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import shasta_tpu.ops.align as A
import shasta_tpu.ops.align_pallas as AP
from shasta_tpu_torch.ops import align_kernel as K
from tests.torch_common import make_batch, one_torch_thread  # noqa: F401

KW = dict(match=6, mismatch=-1, gap=-1)


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX kernel in Pallas interpret mode, with its int16 transfer
    packing off so that it returns int32 like the port."""
    monkeypatch.setattr(
        AP.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    monkeypatch.setenv("SHASTA_TPU_INT16", "0")
    AP.banded_align_pairs.clear_cache()
    yield
    AP.banded_align_pairs.clear_cache()


def port(a, a_len, b, b_len, bm, **kw):
    args = [torch.from_numpy(np.asarray(x)) for x in (a, a_len, b, b_len, bm)]
    return K.banded_align_pairs(*args, **kw, **KW).numpy()


def jax_kernel(a, a_len, b, b_len, bm, **kw):
    args = [jnp.asarray(x) for x in (a, a_len, b, b_len, bm)]
    return np.asarray(AP.banded_align_pairs(*args, **kw, **KW))


@pytest.mark.parametrize(
    "LA,W,force_chunked",
    [(128, 128, False), (128, 288, False), (256, 128, True)],
    ids=["monolithic-128", "monolithic-W288", "chunked-256"],
)
def test_plain_matches_pallas_interpret(interpret_mode, LA, W, force_chunked):
    """Exact equality of the whole fused (B, 16 + LA) output with the
    JAX kernel on its monolithic and chunked routes, both int32."""
    a, a_len, b, b_len, bm = make_batch(LA + W, LA=LA, LB=LA, W=W)
    got = port(a, a_len, b, b_len, bm, LA=LA, LB=LA, W=W)
    ref = jax_kernel(
        a, a_len, b, b_len, bm, LA=LA, LB=LA, W=W, force_chunked=force_chunked
    )
    assert got.dtype == np.int32 and got.shape == (8, 16 + LA)
    assert ref.dtype == np.int32 and np.array_equal(got, ref)
    assert (got[:, 0] > 0).sum() >= 3  # the batch has real alignments


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jnp_oracle(seed):
    """The matched pairs and best score equal the jnp oracle
    (banded_forward + traceback), exactly."""
    LA = LB = W = 128
    a, a_len, b, b_len, bm = make_batch(seed, LA=LA, LB=LB, W=W)
    fused = port(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W)
    # The oracle takes the wrapper's clamped inputs.
    leftpad = LA + W
    ok = (bm >= -leftpad) & (bm <= LB)
    al = np.where(ok, a_len, 0).astype(np.int32)
    bmc = np.clip(bm, -leftpad, LB).astype(np.int32)
    dirs, bi, bd, bv = A.banded_forward(a, al, b, b_len, bmc, W=W, **KW)
    m0r, m1r = A.traceback(dirs, a, b, bmc, bi, bd, n_steps=LA + LB)
    m0r, m1r, bv = map(np.asarray, (m0r, m1r, bv))
    for t in range(a.shape[0]):
        o0 = np.flatnonzero(fused[t, 16:] >= 0)
        o1 = fused[t, 16 + o0]
        rr0 = m0r[m0r[:, t] >= 0, t][::-1]
        rr1 = m1r[m1r[:, t] >= 0, t][::-1]
        assert np.array_equal(o0, rr0) and np.array_equal(o1, rr1), t
        assert fused[t, 0] == o0.shape[0]
        assert fused[t, 9] == bv[t], t
        if o0.shape[0]:
            ms, md, omin, omax = A._metrics_from_ordinals(
                o0.astype(np.uint32), o1.astype(np.uint32)
            )
            assert list(fused[t, 1:9]) == [
                o0[0], o0[-1], o1[0], o1[-1], omin, omax, ms, md
            ], t


def test_edge_cases_match_pallas_interpret(interpret_mode):
    """The batch of test_align_pallas.py::test_edge_cases_match_jnp_kernel:
    empty pairs, length-1 sequences, bands at both clamp limits, a
    full-length identical pair and padding rows; exact equality."""
    B, LA, LB, W = 8, 128, 128, 128
    rng = np.random.default_rng(9)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LB), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    g = rng.integers(0, 30, 300).astype(np.int32)
    b[0, :50] = g[:50]; b_len[0] = 50
    a[1, :50] = g[:50]; a_len[1] = 50
    a[2, 0] = 7; b[2, 0] = 7; a_len[2] = 1; b_len[2] = 1
    a[3, :60] = g[:60]; b[3, :60] = g[:60]
    a_len[3] = 60; b_len[3] = 60; bm[3] = -(LA + W)
    a[4, :60] = g[:60]; b[4, :60] = g[:60]
    a_len[4] = 60; b_len[4] = 60; bm[4] = LB
    a[5] = g[:LA]; b[5] = g[:LA]; a_len[5] = LA; b_len[5] = LB
    got = port(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W)
    ref = jax_kernel(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W)
    assert ref.dtype == np.int32 and np.array_equal(got, ref)
    for t in (0, 1, 3, 4, 6, 7):
        assert got[t, 0] == 0, t
    assert got[2, 0] == 1 and got[2, 16] == 0
    assert got[5, 0] == LA
    assert np.array_equal(got[5, 16 : 16 + LA], np.arange(LA))


def test_metrics_exact_past_row_32768():
    """skip/drift at rows >= 32768 (the 65536 length class) equal the
    host metric definition. The JAX package's packed (row << 16) key
    overflows int32 there and reports a wrong max_skip (ROADMAP.md,
    Faults); the port does not copy that."""
    LA = 65536
    mj = np.full((1, LA), -1, np.int32)
    rows = np.array([32760, 32768, 32769, 32770])
    mj[0, rows] = rows + 5
    host = A._metrics_from_ordinals(
        rows.astype(np.uint32), (rows + 5).astype(np.uint32)
    )
    met = K.metrics_from_mj(torch.from_numpy(mj), torch.zeros(1, dtype=torch.int32))
    met = met.numpy()[0]
    assert (met[7], met[8], met[5], met[6]) == host
    assert list(met[:5]) == [4, 32760, 32770, 32765, 32775]
    jax_met = np.asarray(AP._metrics_from_mj(jnp.asarray(mj.T), jnp.zeros(1, jnp.int32), LA))
    # The reference's fault, pinned: rows >= 32768 pair with the match
    # at row 32760, so it reports max_skip 10 where the path has 8.
    assert host[0] == 8 and jax_met[0, 7] == 10


def test_dirs_budget_chunks_give_same_output(monkeypatch):
    """Splitting a batch across launches under a smaller dirs budget
    leaves the output unchanged (exact integer equality)."""
    LA = LB = W = 128
    a, a_len, b, b_len, bm = make_batch(4, B=8, LA=LA, LB=LB, W=W)
    whole = port(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W)
    assert K.dirs_chunk_pairs(LA, W) >= 8
    monkeypatch.setattr(K, "_DIRS_BYTES", 0)
    assert K.dirs_chunk_pairs(LA, W) == 1
    split = port(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W)
    assert np.array_equal(whole, split)


def test_import_needs_no_nvcc_or_triton():
    """Importing the kernel module builds nothing and imports no triton:
    the kernels build at their first CUDA launch."""
    code = (
        "import sys\n"
        "from shasta_tpu_torch.ops import align_kernel as K\n"
        "assert K._lib is None\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_device_without_card_raises(tmp_path):
    """device='cuda' with no card raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    from shasta_tpu_torch.pipeline.assemble import Assembler

    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Assembler(str(tmp_path / "run"), device="cuda")
    assert K.resolve_device("cpu").type == "cpu"
