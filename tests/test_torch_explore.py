"""The port's explorer (shasta_tpu_torch/http) against the JAX package's,
page by page, on the same run directories.

The run directories are those of tests/test_cli.py:46 (the assemble
command under HiFi-Oct2021), tests/test_paf_overlay.py:85 (``tiny_run``)
and tests/test_mode3.py:49 (mode 3), written by the JAX package. The
port's explorer runs its on-demand alignments on the CPU. Every page
must equal the JAX explorer's byte for byte: no page of these runs
carries a time of its own (the index page shows AssemblySummary.json,
whose times both read from the same file).
"""

import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import HTTPServer
from urllib.parse import parse_qs, urlparse

import pytest

from shasta_tpu.http import explore as JE
from shasta_tpu_torch.http import explore as PE
from shasta_tpu_torch.ops import align_kernel as AK
from tests import synth
from tests.torch_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_cli.py:test_assemble_cli_end_to_end's explorer paths.
CLI_PATHS = [
    "/", "/read?readId=0&strand=0", "/alignments?readId=0",
    "/read?readId=read-0&strand=0",
    "/readGraph?readId=0", "/markerGraph?vertexId=0",
    "/localReadGraph?readId=0&strand=0",
    "/localMarkerGraph?vertexId=0&maxDistance=2",
    "/localMarkerGraph?vertexId=0&maxDistance=2&label=sequence&color=distance",
    "/alignmentMatrix?readId0=0&readId1=1",
    "/assemblyGraph?segment=0&maxDistance=2",
    "/alignment?readId0=0&strand0=0&readId1=1&strand1=0",
    "/blastRead?readId=0&strand=0&beginPosition=0&endPosition=400",
    "/exploreAlignmentCoverage?readId=0&strand=0",
    "/computeAllAlignments?readId=0",
    "/exploreAlignmentCandidateGraph?readId=0",
    "/exploreAlignmentGraph?readId=0",
    "/alignSequencesInBaseRepresentation?sequence0=ACGTACGT&sequence1=ACGGACGT",
    "/assessAlignments",
    "/markerGraphEdge?edgeId=0",
    "/exploreMarkerCoverage?readId=0&strand=0",
    "/inducedAlignment?readId0=0&readId1=1",
    "/followReadInMarkerGraph?readId=0&strand=0",
    "/exploreMarkerConnectivity?readId=0&strand=0&ordinal=0",
    "/assemblyGraphEdge?edgeId=0",
    "/exploreAssemblyGraphEdgesSupport?edgeId=0",
    "/compressedAssemblyGraph?edgeId=0",
    "/assemblySummary.json",
    "/localReadGraph?readId=0&strand=0&maxDistance=2",
    "/localMarkerGraph?vertexId=0&maxDistance=2&label=sequence",
    "/read?readId=read-1&strand=0",
]

# tests/test_mode3.py:test_mode3_pipeline's mode-3 pages.
MODE3_PATHS = [
    "/mode3?segmentId=0",
    "/mode3Segment?segmentId=0",
    "/mode3SegmentPair?segmentId0=0&segmentId1=1",
    "/mode3Link?linkId=0",
    "/mode3MetaAlignment?readId0=0&readId1=1",
    "/mode3AssemblyPath?segmentId=0",
    "/mode3LinkAssembly?linkId=0",
]

# tests/test_paf_overlay.py:test_all_explorer_routes_render's query.
DEFAULTS = {
    "readId": ["0"], "strand": ["0"], "readId0": ["0"],
    "readId1": ["1"], "strand0": ["0"], "strand1": ["0"],
    "vertexId": ["0"], "edgeId": ["0"], "segmentId": ["0"],
    "segmentId0": ["0"], "segmentId1": ["1"], "linkId": ["0"],
    "alignmentId": ["0"], "maxDistance": ["1"], "ordinal": ["0"],
    "sequence": ["ACGTACGT"], "sequence0": ["ACGTACGT"],
    "sequence1": ["ACGTACGT"],
}


def _small_config():
    from tests.test_assembly_e2e import small_config

    return small_config()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three run directories, written by the JAX package."""
    from shasta_tpu.__main__ import main as ref_main
    from shasta_tpu.pipeline.assemble import run_assembly

    d = tmp_path_factory.mktemp("explore_runs")
    out = {}
    # tests/test_cli.py:test_assemble_cli_end_to_end
    genome = synth.random_genome(20000, seed=3)
    fa = str(d / "cli.fasta")
    synth.write_fasta(fa, synth.sample_reads(genome, 100, 3000, seed=4, both_strands=True))
    out["cli"] = str(d / "cli")
    rc = ref_main([
        "--command", "assemble", "--input", fa, "--config", "HiFi-Oct2021",
        "--assemblyDirectory", out["cli"],
        "--Reads.minReadLength", "500", "--Kmers.k", "8",
        "--MinHash.hashFraction", "0.05", "--MinHash.minHashIterationCount", "6",
        "--MinHash.minFrequency", "2", "--Align.minAlignedMarkerCount", "20",
        "--Align.minAlignedFraction", "0.5", "--Align.maxSkip", "60",
        "--Align.maxDrift", "60", "--Align.maxTrim", "60",
        "--ReadGraph.maxAlignmentCount", "8", "--MarkerGraph.minCoverage", "3",
        "--Assembly.consensusCaller", "Modal",
    ])
    assert rc == 0
    # tests/test_paf_overlay.py:tiny_run (small_config's values)
    genome = synth.random_genome(20000, seed=91)
    fa = str(d / "tiny.fasta")
    synth.write_fasta(fa, synth.sample_reads(genome, 100, 2500, seed=92, both_strands=True))
    out["tiny"] = str(d / "tiny")
    run_assembly([fa], out["tiny"], _small_config())
    # tests/test_mode3.py:test_mode3_pipeline
    genome = synth.random_genome(20000, seed=91)
    fa = str(d / "mode3.fasta")
    synth.write_fasta(fa, synth.sample_reads(genome, 120, 3000, seed=92, both_strands=True))
    cfg = _small_config()
    cfg.assembly.mode = 3
    out["mode3"] = str(d / "mode3")
    run_assembly([fa], out["mode3"], cfg)
    return out


def aligned_pair_path(run_dir):
    """/alignment of the first stored alignment's two reads: a pair the
    on-demand DP aligns."""
    from shasta_tpu_torch.data.store import RunStore
    from shasta_tpu_torch.ops.align import AlignmentStore

    al = AlignmentStore.from_arrays(RunStore(run_dir, create=False).load_stage("Alignments"))
    r0, r1 = int(al.read_id0[0]), int(al.read_id1[0])
    s1 = 0 if bool(al.same_strand[0]) else 1
    return f"/alignment?readId0={r0}&strand0=0&readId1={r1}&strand1={s1}"


def serve(explorer):
    server = HTTPServer(("127.0.0.1", 0), explorer)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, r.read()


def test_cli_run_pages_equal_over_http(runs):
    """Each of test_cli.py's paths, served over HTTP by both explorers:
    status 200 and the same bytes; and the on-demand alignment of a pair
    that aligns (the port's DP on the CPU)."""
    run_dir = runs["cli"]
    port_srv = serve(PE.make_handler(PE.Explorer(run_dir, device="cpu")))
    ref_srv = serve(JE.make_handler(JE.Explorer(run_dir)))
    try:
        for path in CLI_PATHS + [aligned_pair_path(run_dir)]:
            s0, b0 = get(port_srv.server_address[1], path)
            s1, b1 = get(ref_srv.server_address[1], path)
            assert s0 == s1 == 200, path
            assert b0 == b1 and len(b0) > 0, path
        assert b"aligned markers" in b0
    finally:
        port_srv.shutdown()
        ref_srv.shutdown()


def test_every_route_equals_on_tiny_run(runs):
    """Every registered route, with test_all_explorer_routes_render's
    query, renders the JAX explorer's page on ``tiny_run``."""
    ex = PE.Explorer(runs["tiny"], device="cpu")
    ref = JE.Explorer(runs["tiny"])
    table, ref_table = PE._routes(ex), JE._routes(ref)
    assert sorted(table) == sorted(ref_table)
    for path in sorted(table):
        got = table[path](dict(DEFAULTS))
        assert isinstance(got, str) and got, path
        assert got == ref_table[path](dict(DEFAULTS)), path


def test_mode3_pages_equal(runs):
    ex = PE.Explorer(runs["mode3"], device="cpu")
    ref = JE.Explorer(runs["mode3"])
    table, ref_table = PE._routes(ex), JE._routes(ref)
    for url in MODE3_PATHS:
        parsed = urlparse(url)
        got = table[parsed.path](parse_qs(parsed.query))
        assert "not available" not in got, url
        assert got == ref_table[parsed.path](parse_qs(parsed.query)), url


def test_explorer_device(runs):
    """The explorer's on-demand alignments run on its device: the CPU
    path moves no kernel counter; without a card, the default (the card)
    raises rather than falling back."""
    import torch

    before = dict(AK.LAUNCHES)
    ex = PE.Explorer(runs["cli"], device="cpu")
    assert ex.device == torch.device("cpu")
    q = parse_qs(urlparse(aligned_pair_path(runs["cli"])).query)
    assert "aligned markers" in PE._routes(ex)["/alignment"](q)
    assert AK.LAUNCHES == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PE.Explorer(runs["cli"])


def test_cli_explore_serves_index(runs):
    """python -m shasta_tpu_torch --command explore starts and serves /,
    equal to the JAX explorer's index page."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "shasta_tpu_torch", "--command", "explore",
         "--assemblyDirectory", runs["cli"], "--port", str(port), "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.monotonic() + 120
        body = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status, body = get(port, "/")
                break
            except OSError:
                time.sleep(0.5)
        assert proc.poll() is None, proc.stdout.read().decode(errors="replace")[-2000:]
        assert status == 200 and body
        ref = JE._routes(JE.Explorer(runs["cli"]))["/"]({})
        assert body.decode() == "<html><head>" + JE._STYLE + "</head><body>" + ref + "</body></html>"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode is not None


def test_mode3_link_lookup_stays_static():
    """The JAX explorer mixes _Mode3Views._find_m3_link into Explorer with
    getattr, which makes the staticmethod a method: /mode3 then raises
    TypeError on any segment with a link to draw (ROADMAP.md, queue 3).
    The port keeps it static."""
    import inspect
    import types

    import numpy as np

    m3 = types.SimpleNamespace(link_source=np.array([0, 2]), link_target=np.array([1, 0]))
    assert isinstance(inspect.getattr_static(PE.Explorer, "_find_m3_link"), staticmethod)
    ex = PE.Explorer.__new__(PE.Explorer)
    assert ex._find_m3_link(m3, 2, 0) == 1 and ex._find_m3_link(m3, 1, 0) is None
    ref = JE.Explorer.__new__(JE.Explorer)
    with pytest.raises(TypeError, match="positional arguments"):
        ref._find_m3_link(m3, 2, 0)
