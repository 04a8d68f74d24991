"""The port's command line (python -m shasta_tpu_torch) against the JAX
package's, and the commands and options it refuses.

The list commands print what the JAX CLI prints. ``assemble`` runs with
``--device cpu`` on a small seeded input, under modes 2 and 3, iterative
assembly and alignment methods 0, 1 and 4 too; ``explore`` refuses what
the JAX CLI refuses before it serves anything (its pages are held to the
JAX explorer's in test_torch_explore.py).
"""

import json
import os

import pytest
import torch

from shasta_tpu.__main__ import main as ref_main
from shasta_tpu_torch.__main__ import main
from shasta_tpu_torch.utils import synth
from tests.test_reference_parity import MODE0_FILE_FAMILY
from tests.torch_common import one_torch_thread  # noqa: F401

# tests/test_assembly_e2e.py:small_config as --Section.key overrides.
SMALL = [
    "--Reads.minReadLength", "500", "--Kmers.k", "8",
    "--Kmers.probability", "0.1", "--MinHash.hashFraction", "0.05",
    "--MinHash.minHashIterationCount", "6", "--MinHash.maxBucketSize", "60",
    "--Align.minAlignedMarkerCount", "20", "--Align.maxSkip", "60",
    "--Align.maxDrift", "60", "--Align.maxTrim", "60",
    "--ReadGraph.maxAlignmentCount", "8", "--MarkerGraph.minCoverage", "3",
]


@pytest.fixture(scope="module")
def small_input(tmp_path_factory):
    """60 reads of 3 kb from a 12 kb genome, both strands, and an empty
    conf file (the configuration defaults)."""
    d = tmp_path_factory.mktemp("cli")
    genome = synth.random_genome(12000, seed=77)
    fasta = str(d / "reads.fasta")
    synth.write_fasta(
        fasta, synth.sample_reads(genome, 60, 3000, seed=78, both_strands=True)
    )
    conf = d / "empty.conf"
    conf.write_text("")
    return fasta, str(conf)


def assemble_args(small_input, run_dir, *extra, device="cpu"):
    fasta, conf = small_input
    return [
        "--command", "assemble", "--config", conf, "--input", fasta,
        "--assemblyDirectory", str(run_dir), "--device", device, *SMALL, *extra,
    ]


@pytest.mark.parametrize(
    "argv",
    [
        ["--command", "listCommands"],
        ["--command", "listConfigurations"],
        ["--command", "listConfiguration", "--config", "Nanopore-May2022"],
    ],
    ids=["listCommands", "listConfigurations", "listConfiguration"],
)
def test_list_commands_print_what_the_reference_prints(argv, capsys):
    assert ref_main(argv) == 0
    ref = capsys.readouterr().out
    assert main(argv) == 0
    assert capsys.readouterr().out == ref
    assert ref


def test_assemble_on_cpu_writes_the_file_family(small_input, tmp_path, capsys):
    """assemble --device cpu returns 0, prints the summary JSON and
    writes the mode-0 file family; a second run into the same,
    now non-empty, directory is refused."""
    run_dir = tmp_path / "run"
    assert main(assemble_args(small_input, run_dir)) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["readCount"] == 60 and summary["assembledSegmentCount"] >= 1
    for name in MODE0_FILE_FAMILY:
        assert (run_dir / name).exists(), name
    with open(run_dir / "index.html") as f:
        index = f.read()
    assert "shasta_tpu_torch" in index and "python -m shasta_tpu " not in index
    assert main(assemble_args(small_input, run_dir)) == 1
    assert "not empty" in capsys.readouterr().err


def test_binary_data_commands(small_input, tmp_path, capsys):
    """saveBinaryData copies Data/ to DataOnDisk/; cleanupBinaryData
    replaces Data/ by a link to it."""
    run_dir = tmp_path / "run"
    assert main(assemble_args(small_input, run_dir)) == 0
    capsys.readouterr()
    argv = ["--assemblyDirectory", str(run_dir)]
    assert main(["--command", "saveBinaryData", *argv]) == 0
    assert (run_dir / "DataOnDisk").is_dir()
    assert main(["--command", "cleanupBinaryData", *argv]) == 0
    assert os.path.islink(run_dir / "Data")


def test_bash_completion_script(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["--command", "createBashCompletionScript"]) == 0
    text = (tmp_path / "shasta_tpu_torchCompletion.sh").read_text()
    assert "--device" in text and "Nanopore-May2022" in text


@pytest.mark.parametrize(
    "extra",
    [
        ["--Assembly.mode", "2"],
        ["--Assembly.mode", "3"],
        ["--Assembly.iterative", "true"],
        ["--Align.alignMethod", "0"],
        ["--Align.alignMethod", "1"],
        ["--Align.alignMethod", "4"],
    ],
    ids=["mode2", "mode3", "iterative", "align0", "align1", "align4"],
)
def test_ported_options_run_as_the_reference(small_input, tmp_path, extra, capsys):
    """Modes 2 and 3, iterative assembly and alignment methods 0, 1 and 4
    run through the assemble command with --device cpu; the summary's
    counts (the mode3* values too) and stage list and Assembly.fasta
    equal the JAX CLI's on the same arguments."""
    fasta, conf = small_input
    ref_dir = tmp_path / "ref"
    assert ref_main([
        "--command", "assemble", "--config", conf, "--input", fasta,
        "--assemblyDirectory", str(ref_dir), *SMALL, *extra,
    ]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert main(assemble_args(small_input, tmp_path / "port", *extra)) == 0
    port = json.loads(capsys.readouterr().out)
    assert port["alignmentCount"] > 0
    for key in ("alignmentCount", "markerGraphVertexCount", "markerGraphEdgeCount",
                "assembledSegmentCount", "totalAssembledSegmentLength",
                "phasedBubbleCount", "mode3SegmentCount", "mode3LinkCount",
                "mode3JaccardEdgeCount", "mode3JaccardPathCount",
                "mode3JaccardPathTotalLength"):
        assert port.get(key) == ref.get(key), key
    assert list(port["stageSeconds"]) == list(ref["stageSeconds"])
    assert (tmp_path / "port" / "Assembly.fasta").read_bytes() == (
        ref_dir / "Assembly.fasta"
    ).read_bytes()


def test_explore_raises(tmp_path):
    """explore raises before it serves: on a PAF file that is not there,
    on an --exploreAccess the reference does not know (as the JAX CLI
    does), and on --device cuda without a card (nothing falls back)."""
    base = ["--command", "explore", "--assemblyDirectory", str(tmp_path)]
    with pytest.raises(SystemExit, match="not found"):
        main(base + ["--alignmentsPafFile", str(tmp_path / "none.paf")])
    with pytest.raises(SystemExit, match="not found"):
        ref_main(base + ["--alignmentsPafFile", str(tmp_path / "none.paf")])
    with pytest.raises(ValueError, match="exploreAccess"):
        main(base + ["--exploreAccess", "everyone", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(base + ["--device", "cuda"])


def test_device_cuda_without_card_raises(small_input, tmp_path):
    """--device cuda (the default) raises on a machine without a card,
    before the run directory is made; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    run_dir = tmp_path / "run"
    fasta, conf = small_input
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--command", "assemble", "--config", conf, "--input", fasta,
              "--assemblyDirectory", str(run_dir)])
    assert not run_dir.exists()
