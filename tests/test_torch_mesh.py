"""The port's mesh (shasta_tpu_torch/parallel/mesh.py) against the JAX
package's on its 8-virtual-device CPU mesh (tests/conftest.py).

The port's functions run in spawned gloo worlds of 1, 2 and 4 ranks on
the CPU (``parallel.distributed.spawn``), one world per size running
every function (tests/torch_ranks.py:mesh_functions); the JAX functions
run once, on ``make_mesh(8)``. The inputs are those of
tests/test_sharded_lowhash.py and tests/test_align_pallas.py:389 (and
dryrun_multichip(8)'s for the LowHash step and full_step), made from
their seeds. Every comparison is exact.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
from jax.experimental import pallas as pl

import shasta_tpu.ops.align_pallas as AP
from shasta_tpu.parallel import mesh as JM
from shasta_tpu_torch.parallel import mesh as M
from shasta_tpu_torch.parallel.distributed import spawn
from tests import torch_ranks as TR
from tests.torch_common import one_torch_thread  # noqa: F401

RANKS = [1, 2, 4]


@pytest.fixture(scope="module")
def inputs():
    return TR.mesh_inputs()


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """Every JAX sharded function on the 8-device mesh (the Pallas kernel
    in interpret mode with int32 transfer, as the port's kernel tests run
    it), and the host references."""
    from shasta_tpu.graph.marker_graph import union_find_labels
    from shasta_tpu.ops import lowhash as JLH
    from shasta_tpu.ops.align import _DeviceCsr

    mp = pytest.MonkeyPatch()
    mp.setattr(AP.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    mp.setenv("SHASTA_TPU_INT16", "0")
    for fn in (JM._align_take_fn, JM._band_take_fn):
        fn.cache_clear()
    AP.banded_align_pairs.clear_cache()
    try:
        mesh = JM.make_mesh(8)
        ref = {}
        ref["lowhash"] = tuple(
            np.asarray(x) for x in JM.sharded_lowhash_step(mesh, jnp.asarray(inputs["features"]), 3, 8)
        )
        jmarkers = TR.candidate_markers("shasta_tpu")
        params = JLH.LowHashParams(**TR.LOWHASH)
        ref["candidates"] = JM.sharded_find_candidates(mesh, jmarkers, params)
        ref["candidates_host"] = JLH.find_candidates_lowhash(jmarkers, params)
        n, u, v = inputs["uf"]
        ref["uf"] = {
            r: np.asarray(JM.sharded_union_find(mesh, n, u, v, n_rounds=r)) for r in (2, 24)
        }
        ref["uf_labels"] = JM.sharded_union_find_labels(mesh, n, u, v)
        ref["uf_host"] = union_find_labels(n, u, v)
        ref["fwd"] = tuple(
            np.asarray(x) for x in JM.sharded_banded_forward(mesh, *inputs["fwd"], W=32)
        )
        ref["ftb"] = tuple(
            np.asarray(x) for x in JM.sharded_forward_traceback(
                mesh, *inputs["fwd"], W=32, n_steps=128, **TR.KW
            )
        )
        a, a_len, b, b_len, bm = inputs["pallas"]
        pad = lambda x, f: np.concatenate([x, np.full((2,) + x.shape[1:], f, x.dtype)])  # noqa: E731
        ref["pallas"] = np.asarray(JM.sharded_pallas_align(
            mesh, pad(a, -1), pad(a_len, 0), pad(b, -2), pad(b_len, 0), pad(bm, 0),
            LA=128, LB=128, W=128, **TR.KW,
        ))[:6]
        flat, off, lens, aux = inputs["csr"]
        dev_m = _DeviceCsr(flat, off, lens, aux=aux, mesh=mesh)
        ia, ib, al, bl, bm8 = inputs["take"]
        ra = dev_m.local[ia].astype(np.int32)
        rb = dev_m.local[ib].astype(np.int32)
        ref["take"] = np.asarray(JM.sharded_align_take(
            mesh, dev_m.matrix(128), ra, dev_m.matrix(128), rb, al, bl, bm8,
            LA=128, LB=128, W=128, pack_u8=False, **TR.KW,
        ))
        ref["band"] = np.asarray(JM.sharded_band_take(
            mesh, dev_m.matrix(128), ra, dev_m.aux_matrix(128),
            dev_m.matrix(128), rb, dev_m.aux_matrix(128), al, bl, bm8,
            LA=128, LB=128, W=128, **TR.KW,
        ))
        *dry, n_markers = inputs["dry"]
        ref["full_step"] = tuple(np.asarray(x) for x in JM.full_step(
            mesh, *(jnp.asarray(x) for x in dry), n_markers, W=128, log2_buckets=8
        ))
    finally:
        for fn in (JM._align_take_fn, JM._band_take_fn):
            fn.cache_clear()
        AP.banded_align_pairs.clear_cache()
        mp.undo()
    return ref


@pytest.fixture(scope="module", params=RANKS, ids=[f"{d}ranks" for d in RANKS])
def port(request, inputs):
    """The port's functions in a spawned gloo world of D ranks on the
    CPU: (D, every rank's results)."""
    D = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")  # the ranks share the test's cores
    try:
        outs = spawn(TR.mesh_functions, D, device="cpu", args=(inputs,), timeout=300)
    finally:
        mp.undo()
    return D, outs


def test_mix64_bit_equal():
    """_mix64 emulates the JAX package's uint32 mixer in int64 exactly,
    wrap-around included."""
    import torch

    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    for seed in (0, 37, 2**32 - 1):
        ref = np.asarray(JM._mix64(jnp.asarray(x), jnp.uint32(seed)))
        got = M._mix64(torch.from_numpy(x.astype(np.int64)), seed).numpy()
        assert ref.dtype == np.uint32 and np.array_equal(got, ref.astype(np.int64)), seed


def test_every_rank_has_the_full_result(port):
    """Every sharded function returns the same full result on every rank."""
    D, outs = port
    assert len(outs) == D
    for o in outs[1:]:
        for key in ("lowhash", "fwd", "full_step"):
            assert all(np.array_equal(x, y) for x, y in zip(o[key], outs[0][key])), key
        for key in ("ftb", "pallas", "take", "band", "uf_labels"):
            assert np.array_equal(o[key], outs[0][key]), key
        assert o["candidates"].count == outs[0]["candidates"].count
    calls = outs[0]["calls"]
    assert set(outs[0]["seconds"]) == set(calls), outs[0]["seconds"]
    assert calls["all_to_all"] == TR.LOWHASH["iteration_count"], calls
    assert calls["all_reduce_min"] == 2 + 24 + 16 + 8, calls


def test_lowhash_step_bit_equal(port, jax_ref):
    h, bucket, hist = port[1][0]["lowhash"]
    jh, jb, jhist = jax_ref["lowhash"]
    assert np.array_equal(h, jh.astype(np.int64))
    assert np.array_equal(bucket, jb) and np.array_equal(hist, jhist)
    assert hist.sum() == 512


def test_candidates_equal_jax_and_host(port, jax_ref):
    got = port[1][0]["candidates"]

    def key(c):
        return np.lexsort((c.same_strand, c.read_id1, c.read_id0))

    for ref in (jax_ref["candidates"], jax_ref["candidates_host"]):
        assert got.count == ref.count > 100
        kg, kr = key(got), key(ref)
        for f in ("read_id0", "read_id1", "same_strand", "frequency"):
            assert np.array_equal(getattr(got, f)[kg], getattr(ref, f)[kr]), f


def test_union_find_equal(port, jax_ref):
    """The raw labels after 2 rounds (not converged) and after 24 equal
    the JAX package's at every D; the wrapper gives union_find_labels."""
    got = port[1][0]
    for r in (2, 24):
        assert np.array_equal(got["uf"][r], jax_ref["uf"][r]), r
    assert not np.array_equal(got["uf"][2], jax_ref["uf_host"])
    assert np.array_equal(got["uf_labels"], jax_ref["uf_labels"])
    assert np.array_equal(got["uf_labels"], jax_ref["uf_host"])


def test_alignment_wrappers_bit_equal(port, jax_ref):
    got = port[1][0]
    for x, y in zip(got["fwd"], jax_ref["fwd"]):
        assert np.array_equal(x, y)
    # The jnp route's (n_steps, B) match lists against the fused layout.
    m0, m1 = jax_ref["ftb"]
    fused = got["ftb"]
    for t in range(fused.shape[0]):
        o0 = np.flatnonzero(fused[t, 16:] >= 0)
        assert np.array_equal(o0, m0[m0[:, t] >= 0, t][::-1]), t
        assert np.array_equal(fused[t, 16 + o0], m1[m1[:, t] >= 0, t][::-1]), t
    assert (fused[:, 0] > 0).all()
    for key in ("pallas", "take", "band"):
        assert got[key].shape == jax_ref[key].shape, key
        assert np.array_equal(got[key], jax_ref[key]), key


def test_full_step_bit_equal(port, jax_ref):
    for x, y in zip(port[1][0]["full_step"], jax_ref["full_step"]):
        assert np.array_equal(x, y)
