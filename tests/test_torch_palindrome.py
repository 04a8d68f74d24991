"""The palindrome pass with a band wider than 16384 lanes against the
JAX package's (ROADMAP.md fault 2).

deltaThreshold 8200 gives the self-alignment band 2 x 8200 = 16400
lanes, which the align engine runs in its W class 32768; on the card
the row-scan body then keeps its rows in device memory and runs each
row in tiles. The input is the first six reads of the mode-0 golden
input and one palindromic read (tests/torch_common.py:palindrome_reads):
on the CPU the plain version takes about 1.5 s per read at this width,
so the 130 golden reads would take minutes. The flags are compared
exactly.
"""

import numpy as np

from shasta_tpu.ops.palindrome import flag_palindromic_reads as ref_flag
from shasta_tpu.pipeline.assemble import Assembler as RefAssembler
from shasta_tpu_torch.ops import align as A
from shasta_tpu_torch.ops.palindrome import flag_palindromic_reads
from shasta_tpu_torch.pipeline.assemble import Assembler
from shasta_tpu_torch.utils import synth
from tests.test_assembly_e2e import small_config as ref_small_config
from tests.test_torch_pipeline import port_small_config
from tests.torch_common import one_torch_thread, palindrome_reads  # noqa: F401

DELTA = 8200


def markers(asm, fasta):
    asm.add_reads([fasta])
    asm.select_kmers()
    asm.find_markers()
    return asm.markers


def test_palindrome_flags_at_delta_8200_equal_reference(tmp_path):
    fasta = str(tmp_path / "reads.fasta")
    synth.write_fasta(fasta, palindrome_reads())
    assert A._bucket(2 * DELTA, A._W_BUCKETS) == 32768
    port = flag_palindromic_reads(
        markers(Assembler(str(tmp_path / "port"), port_small_config(), device="cpu"), fasta),
        delta_threshold=DELTA, device="cpu",
    )
    ref = ref_flag(
        markers(RefAssembler(str(tmp_path / "ref"), ref_small_config()), fasta),
        delta_threshold=DELTA,
    )
    assert port.dtype == ref.dtype and np.array_equal(port, ref)
    assert port.tolist() == [False] * 6 + [True]
