"""The ``hifi`` configuration and the ``assemble-hifi`` traffic: found by
name, their planted fault seen under HiFi's limits at ``tiny.py``'s
scale, and the readers of LowHash's spans and counter."""

import json
import os
from types import SimpleNamespace

import pytest

from perfbench import drivers, harness, reference, reference_lowhash
from perfbench.trace import Trace
from perfbench.tests import tiny

LOWHASH = ("lowhash_step_s.hash", "lowhash_step_s.group", "lowhash_step_s.pairs",
           "lowhash_pairs_ns_per_key")
MS = 1_000_000


def test_hifi_config_and_traffic_load_by_name():
    from shasta_tpu_torch.pipeline.configurations import CONFIGURATIONS

    spec = harness.load_spec()
    w = harness.cell(spec, "hifi.assemble")
    cfg, traffic = harness.config_of(spec, w), harness.traffic_of(w)
    assert traffic["driver"] == "assemble" and traffic["driver"] in drivers.DRIVERS
    assert set(traffic["check"]["assembly"]) == {"contig_errors_per_100kb", "genome_missing_pct"}
    assert cfg["conf"].strip() == CONFIGURATIONS["HiFi-Oct2021"].strip()
    conf = drivers.assembly_config(cfg)
    p = reference.Params.from_config(cfg)
    assert (p.max_skip, p.max_drift, p.max_trim) == (conf.align.max_skip, conf.align.max_drift,
                                                    conf.align.max_trim) == (6, 4, 2)
    assert p.min_aligned_marker_count == conf.align.min_aligned_marker_count == 200
    assert p.min_read_length == conf.reads.min_read_length == cfg["reads"]["min_length"]
    lh = reference_lowhash.LowHashParams.from_config(cfg)
    mh = conf.min_hash
    assert (lh.m, lh.hash_fraction, lh.iterations, lh.log2_buckets, lh.min_bucket_size,
            lh.max_bucket_size, lh.min_frequency) == (
        mh.m, mh.hash_fraction, mh.min_hash_iteration_count, mh.log2_min_hash_bucket_count,
        mh.min_bucket_size, mh.max_bucket_size, mh.min_frequency)
    ul = harness.cell(spec, "ont-ul.assemble")
    assert harness.traffic_of(ul)["driver"] == "assemble"
    for name in ("assembly_s", "setup_s", "peak_host_gib"):
        assert any(m["name"] == name for m in harness.metrics_of(spec, w, False))
        assert any(m["name"] == name for m in harness.metrics_of(spec, ul, False))


def tiny_hifi(root: str) -> str:
    """Add ``tiny-hifi``: HiFi-Oct2021's conf and read model at tiny.py's
    scale (15 kb, k 10, reads of about 2.5 kb, so fewer aligned markers
    and shorter reads allowed), its cell checked under assemble-hifi's
    limit of contig errors."""
    bench = os.path.join(root, "perfbench")
    with open(os.path.join(bench, "configs", "hifi.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "traffic", "assemble-hifi.json")) as f:
        errors = json.load(f)["check"]["assembly"]["contig_errors_per_100kb"]
    # A 15 kb genome's ends are covered thinly: tiny.py's own share missed.
    limits = dict(tiny.TINY_ASSEMBLY_LIMITS, contig_errors_per_100kb=errors)
    cfg["conf"] = (cfg["conf"].replace("minReadLength = 8000", "minReadLength = 500")
                   .replace("k = 14", "k = 10")
                   .replace("minAlignedMarkerCount = 200", "minAlignedMarkerCount = 20"))
    cfg["reads"].update(coverage=20.0, median_length=2500, min_length=1000)
    cfg["reference"].update(min_read_length=500, k=10, min_aligned_marker_count=20)
    with open(os.path.join(bench, "configs", "tiny-hifi.json"), "w") as f:
        json.dump(cfg, f)
    traffic = {"driver": "assemble", "genome_bases": 15000,
               "check": {"random": 24, "longest": 4, "assembly": limits}}
    with open(os.path.join(bench, "traffic", "tiny-hifi-assemble.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny-hifi", "source": "cut-size test configuration",
                            "file": "perfbench/configs/tiny-hifi.json", "reduced": [],
                            "why": "tests"})
    spec["workloads"].append({"name": "tiny-hifi.assemble", "config": "tiny-hifi",
                              "traffic": "tiny-hifi-assemble", "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "hifi.assemble" in m.get("workloads", []):
            m["workloads"].append("tiny-hifi.assemble")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return root


@pytest.fixture(scope="module")
def hifi_root(tmp_path_factory):
    return tiny_hifi(tiny.make(str(tmp_path_factory.mktemp("bench_hifi"))))


@pytest.mark.parametrize("fault", [None, "edge_consensus_skipped"])
def test_hifi_limits_see_the_skipped_consensus(fault, hifi_root, capsys, monkeypatch):
    """Traced runs of the tiny HiFi cell: as configured it is correct;
    with the edges' consensus skipped (``control.py``'s control) its
    contigs break assemble-hifi's limit. Both report LowHash's spans."""
    from perfbench import control

    if fault is not None:
        group, key, value = control.ASSEMBLY_CONTROLS[fault]
        configured = drivers.assembly_config

        def broken(cfg):
            conf = configured(cfg)
            setattr(getattr(conf, group), key, value)
            return conf

        monkeypatch.setattr(drivers, "assembly_config", broken)
    assert tiny.run(hifi_root, "tiny-hifi.assemble", seed=2**31 + 41, trace=1) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    c = res["checks"]["contig_errors_per_100kb"]
    if fault is None:
        assert res["correct"] is True, res["checks"]
    else:
        assert res["correct"] is False and c["value"] > c["limit"], res["checks"]
    for name in LOWHASH:
        assert res["metrics"][name]["value"] > 0, name


def hand_trace() -> Trace:
    """Two assemblies; in each, spans of 10, 20 and 30 ms a step, twice."""
    t = Trace()
    for a in range(2):
        base = a * 1000 * MS
        t.spans.append((base, base + 1000 * MS, "assembly"))
        for i, step in enumerate(("hash", "group", "pairs")):
            for k in range(2):
                lo = base + (100 * i + 10 * k + 1) * MS
                t.spans.append((lo, lo + (i + 1) * 5 * MS, f"stage:lowhash.{step}"))
    t.spans.sort()
    return t


def test_lowhash_readers_on_a_hand_trace(monkeypatch):
    from shasta_tpu_torch.ops import lowhash as LH

    monkeypatch.setitem(LH.COUNTS, "pair_keys", 3_000_000)
    run = SimpleNamespace(trace=hand_trace(), kind="assemble", items=2)
    want = {"lowhash_step_s.hash": 0.010, "lowhash_step_s.group": 0.020,
            "lowhash_step_s.pairs": 0.030, "lowhash_pairs_ns_per_key": 0.030 * 1e9 / 3e6}
    for name, v in want.items():
        assert harness.reader(name)(run) == pytest.approx(v, rel=1e-12), name


@pytest.mark.parametrize("name", LOWHASH)
@pytest.mark.parametrize("case", ["align", "untraced", "no_spans"])
def test_lowhash_readers_none_without_spans(name, case, monkeypatch):
    """On an align run, untraced, or on a program that opens no
    ``stage:lowhash.*`` span (the parent's), every reader gives None."""
    from shasta_tpu_torch.ops import lowhash as LH

    monkeypatch.setitem(LH.COUNTS, "pair_keys", 1000)
    run = {
        "align": SimpleNamespace(trace=hand_trace(), kind="align", items=2),
        "untraced": SimpleNamespace(trace=None, kind="assemble", items=2),
        "no_spans": SimpleNamespace(trace=Trace(spans=[(0, 10, "assembly")]), kind="assemble",
                                    items=2),
    }[case]
    assert harness.reader(name)(run) is None
