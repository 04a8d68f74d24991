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
