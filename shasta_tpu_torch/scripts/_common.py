"""Shared helpers for the stage-wise drivers.

Every driver that opens a run takes ``--device`` ("cuda" by default: the
alignment DP on the card's CUDA kernels, raising when there is no card;
"cpu": their plain PyTorch version)."""

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DEVICE_HELP = 'where the alignment DP runs: "cuda" (default) or "cpu"'


def take_device(argv=None):
    """``(device, rest)``: ``--device D`` (or ``--device=D``) taken out of
    ``argv`` (default ``sys.argv[1:]``); the device is "cuda" when the
    arguments name none."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--device", default="cuda", help=DEVICE_HELP)
    ns, rest = parser.parse_known_args(sys.argv[1:] if argv is None else list(argv))
    return ns.device, rest


def attach(run_dir, device):
    """Reattach an Assembler on ``device`` to an existing run directory."""
    from shasta_tpu_torch.data.kmers import KmerTable
    from shasta_tpu_torch.data.markers import MarkerStore
    from shasta_tpu_torch.data.reads import ReadStore
    from shasta_tpu_torch.graph.marker_graph import MarkerGraph
    from shasta_tpu_torch.graph.read_graph import ReadGraph
    from shasta_tpu_torch.ops.align import AlignmentStore
    from shasta_tpu_torch.ops.lowhash import CandidatePairs
    from shasta_tpu_torch.pipeline.assemble import Assembler
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    conf = os.path.join(run_dir, "shasta.conf")
    config = AssemblyConfig.from_conf_file(conf) if os.path.exists(conf) else None
    a = Assembler(run_dir, config, device=device)
    store = a.store

    def soft(stage, cls):
        try:
            return cls.from_arrays(store.load_stage(stage))
        except KeyError:
            return None

    a.reads = soft("Reads", ReadStore)
    a.kmer_table = soft("Kmers", KmerTable)
    a.markers = soft("Markers", MarkerStore)
    a.candidates = soft("AlignmentCandidates", CandidatePairs)
    a.alignments = soft("Alignments", AlignmentStore)
    a.read_graph = soft("ReadGraph", ReadGraph)
    a.marker_graph = soft("MarkerGraph", MarkerGraph)
    if a.marker_graph is not None and a.marker_graph.source is not None:
        a.marker_graph.build_adjacency()
    return a


def open_run(argv=None):
    """``(assembler, args)``: the run directory ``args[0]`` (default ".")
    reattached on the device ``--device`` names; ``args`` are the
    arguments (default ``sys.argv[1:]``) without ``--device``."""
    device, args = take_device(argv)
    return attach(args[0] if args else ".", device), args


def load(name):
    """The driver ``name`` (a file of this directory, without ".py") as a
    module, whose ``main(argv)`` runs it in this process."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        "shasta_torch_script_" + name.replace("-", "_"), os.path.join(HERE, name + ".py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
