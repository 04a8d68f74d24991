"""The port's mode-2 pipeline under a mesh on the CPU, on the mode-2
golden input: a one-rank mesh in this process, and
``run_assembly_distributed`` on two spawned gloo ranks. Each run gives
all 17 values of tests/golden/mode2_stage_hashes.json (8 stage
manifests and the 9 pinned output files, whose hashes are those of the
port's single-device run: tests/test_torch_mode2.py)."""

import pytest

from tests.test_torch_distributed import (  # noqa: F401
    one_rank_mesh_run, one_rank_world, two_rank_distributed_run,
)
from tests.torch_common import one_torch_thread, write_mode2_reads  # noqa: F401


@pytest.fixture(scope="module")
def mode2_fasta(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mode2") / "mode2.fasta")
    write_mode2_reads(path)
    return path


def test_one_rank_mesh_run_mode2(mode2_fasta, tmp_path, one_rank_world):
    one_rank_mesh_run(mode2_fasta, str(tmp_path / "run"), 2)


def test_two_rank_distributed_run_mode2(mode2_fasta, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    two_rank_distributed_run(mode2_fasta, str(tmp_path / "run"), 2)
