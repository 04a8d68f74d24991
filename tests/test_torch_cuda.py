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
from shasta_tpu_torch.utils import synth
from tests.torch_common import make_batch

KW = dict(match=6, mismatch=-1, gap=-1)


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


@pytest.mark.cuda
def test_align_candidates_card_matches_cpu(card):
    """align_candidates on the card (kernels) and on the CPU (plain
    version) give equal AlignmentStores, dtypes included."""
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
    before = K.LAUNCHES["banded_fwd"]
    on_card = A.align_candidates(*args, device=card)
    on_cpu = A.align_candidates(*args, device="cpu")
    assert K.LAUNCHES["banded_fwd"] > before
    assert on_cpu.count > 0
    ga, ra = on_card.arrays(), on_cpu.arrays()
    for k, v in ra.items():
        assert ga[k].dtype == v.dtype, k
        assert np.array_equal(ga[k], v), k
