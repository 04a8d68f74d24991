"""The port's pipeline under a mesh (shasta_tpu_torch/parallel), on the
CPU, on the mode-0 golden input: a one-rank mesh in this process, and
``run_assembly_distributed`` in spawned gloo worlds of two ranks, on the
input as one file and as two. (Mode 2: test_torch_distributed_mode2.py.)

Each run must give every golden value of
tests/golden/mode0_stage_hashes.json and output files byte-equal to the
port's single-device run. Every spawned world has its own timeout.
"""

import json
import os

import numpy as np
import pytest
import torch.distributed as dist

from shasta_tpu_torch.parallel import distributed as D
from shasta_tpu_torch.parallel.mesh import make_mesh
from shasta_tpu_torch.pipeline.assemble import run_assembly
from shasta_tpu_torch.utils import synth
from tests import torch_ranks as TR
from tests.test_reference_parity import MODE2_PINNED_FILES
from tests.torch_common import mode2_golden_config, one_torch_thread  # noqa: F401

MODE0_FILES = ["Assembly.fasta", "Assembly.gfa", "Assembly-BothStrands.gfa"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The mode-0 golden input as one file, and cut in two files (its
    first 65 records, then the other 65: the same reads, names and order)."""
    d = tmp_path_factory.mktemp("golden_inputs")
    g = synth.random_genome(25000, seed=4242)
    fa0 = str(d / "mode0.fasta")
    synth.write_fasta(fa0, synth.sample_reads(g, 130, 3000, seed=4243, both_strands=True))
    with open(fa0) as f:
        lines = f.readlines()
    halves = [str(d / "half0.fasta"), str(d / "half1.fasta")]
    for path, part in zip(halves, (lines[:130], lines[130:])):
        with open(path, "w") as f:
            f.writelines(part)
    return {0: fa0, "halves": halves}


@pytest.fixture(scope="module")
def single(inputs, tmp_path_factory):
    """The port's single-device run on the CPU of the mode-0 golden input."""
    run_dir = str(tmp_path_factory.mktemp("single") / "mode0")
    run_assembly([inputs[0]], run_dir, TR.small_config(), device="cpu")
    return run_dir


def assert_golden_run(run_dir, mode, single_dir=None):
    """Every golden value of ``mode`` holds in ``run_dir`` (stage
    manifests; mode 2's pinned output files too); mode 0's output files
    are byte-equal to ``single_dir``'s."""
    assert TR.golden_mismatches(run_dir, mode) == []
    if mode == 0:
        for name in MODE0_FILES:
            with open(os.path.join(run_dir, name), "rb") as f, open(
                os.path.join(single_dir, name), "rb"
            ) as g:
                assert f.read() == g.read(), name
    else:
        with open(os.path.join(TR.GOLDEN_DIR, "mode2_stage_hashes.json")) as f:
            assert {f"file:{n}" for n in MODE2_PINNED_FILES} <= set(json.load(f))


@pytest.fixture
def one_rank_world():
    """A one-rank gloo world in this process, ended after the test."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_and_helpers(one_rank_world):
    D.initialize(device="cpu")
    D.initialize(device="cpu")  # idempotent: adopts the world it started
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert str(dist.get_backend()) == "gloo"
    assert D.is_coordinator()
    mesh = D.global_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend, str(mesh.device)) == (1, 0, "gloo", "cpu")
    assert mesh.ranks_per_device == 1
    with pytest.raises(ValueError, match="world has 1 ranks"):
        make_mesh(2, device="cpu")
    sl = D.process_local_slice(10)
    assert (sl.start, sl.stop) == (0, 10)
    assert D.shard_input_files(["a", "b"]) == ["a", "b"]
    arr = np.arange(12).reshape(3, 4)
    assert np.array_equal(D.allgather_to_hosts(arr), arr)
    D.barrier()


def test_ranks_per_device_counts_ranks_on_one_card(monkeypatch):
    """Two ranks share a device only where their device keys agree: two
    CPU ranks share the host, ranks that report different card UUIDs
    count one rank a card, ranks that report one UUID count two."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    outs = D.spawn(TR.peer_counts, 2, device="cpu", timeout=120)
    assert outs == [[2, 1, 2], [2, 1, 2]]


def one_rank_mesh_run(fasta, run_dir, mode, single_dir=None):
    """run_assembly(mesh=) on a one-rank mesh that make_mesh starts itself:
    the sharded LowHash, alignment batches and union-find all run."""
    mesh = make_mesh(1, device="cpu")
    cfg = TR.small_config() if mode == 0 else mode2_golden_config()
    run_assembly([fasta], run_dir, cfg, mesh=mesh)
    assert_golden_run(run_dir, mode, single_dir)
    assert mesh.calls["all_to_all"] == cfg.min_hash.min_hash_iteration_count
    assert mesh.calls["all_reduce_min"] == 16
    # The candidates' keys, then at least one phase-1 and one phase-2 batch.
    assert mesh.calls["all_gather"] >= 3


def test_one_rank_mesh_run(inputs, single, tmp_path, one_rank_world):
    one_rank_mesh_run(inputs[0], str(tmp_path / "run"), 0, single)


def test_device_must_agree_with_the_mesh(one_rank_world, tmp_path):
    from shasta_tpu_torch.pipeline.assemble import Assembler

    mesh = make_mesh(device="cpu")
    assert Assembler(str(tmp_path / "a"), mesh=mesh).device == mesh.device
    assert Assembler(str(tmp_path / "b"), mesh=mesh, device="cpu").device == mesh.device
    with pytest.raises((ValueError, RuntimeError)):
        Assembler(str(tmp_path / "c"), mesh=mesh, device="cuda")


def two_rank_distributed_run(fasta, run_dir, mode, single_dir=None):
    """run_assembly_distributed on two gloo ranks: rank 0 writes the run
    directory and returns the summary, rank 1 writes .process1."""
    outs = D.spawn(
        TR.distributed_run, 2, device="cpu", args=([fasta], run_dir, mode), timeout=400,
    )
    assert [o[0] for o in outs] == [0, 1]
    assert outs[0][1] is not None and outs[1][1] is None
    assert_golden_run(run_dir, mode, single_dir)
    assert_golden_run(os.path.join(run_dir, ".process1"), mode, single_dir)


def test_two_rank_distributed_run(inputs, single, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    two_rank_distributed_run(inputs[0], str(tmp_path / "run"), 0, single)


def test_two_files_on_two_ranks(inputs, single, tmp_path, monkeypatch):
    """Two input files on two ranks. Dealt out as the JAX package's
    run_assembly_distributed deals them (shard_input_files), each rank
    reads a different half of the reads, and nothing in the pipeline
    gathers them back (ROADMAP.md, queue 3). The port gives every rank
    every file: its output is the one-process output on both files, which
    hold the golden input's reads in its order."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    halves = inputs["halves"]
    run_dir = str(tmp_path / "run")
    outs = D.spawn(TR.two_files, 2, device="cpu", args=(halves, run_dir), timeout=400)
    (files0, n0, counts), _ = outs[0]
    (files1, n1, _), _ = outs[1]
    assert files0 == [halves[0]] and files1 == [halves[1]]
    assert counts == [n0, n1] == [65, 65]
    assert outs[0][1][1]["readCount"] == 130
    assert_golden_run(run_dir, 0, single)
