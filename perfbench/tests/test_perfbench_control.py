"""The check's controls come out as not correct at a cut size, on
several seeds: the phase-2 band narrowed to the phase-1 offsets, and the
assembly with its edges' consensus skipped. An answer computed in the
band the configuration states, without the program's class padding, is
taken as correct."""

import pytest

from perfbench import control, harness


@pytest.mark.parametrize("seed", [2**31 + 31, 2**31 + 32])
def test_control_is_not_correct(seed, tiny_root):
    s = harness.load_spec(tiny_root)
    w = harness.cell(s, "tiny.align")
    r = control.control_reading(harness.config_of(s, w, tiny_root),
                                harness.traffic_of(w, tiny_root), seed, "cpu")
    assert r["reference_aligned"] > 0
    assert r["mismatched_alignments"] > 0


@pytest.mark.parametrize("seed", [2**31 + 33, 2**31 + 34])
def test_assembly_control_is_not_correct(seed, tiny_root):
    s = harness.load_spec(tiny_root)
    w = harness.cell(s, "tiny.assemble")
    traffic = harness.traffic_of(w, tiny_root)
    limits = traffic["check"]["assembly"]
    runs = {r["run"]: r for r in control.assembly_readings(
        harness.config_of(s, w, tiny_root), traffic, seed, "cpu")}
    assert all(runs["as_configured"][k] <= v for k, v in limits.items())
    assert any(runs["edge_consensus_skipped"][k] > v for k, v in limits.items())


@pytest.mark.parametrize("seed", [2**31 + 35, 2**31 + 36])
def test_stated_band_answers_are_correct(seed, tiny_root):
    import shutil
    import tempfile

    from perfbench import drivers, reference
    from shasta_tpu_torch.pipeline.assemble import Assembler

    s = harness.load_spec(tiny_root)
    w = harness.cell(s, "tiny.align")
    cfg = harness.config_of(s, w, tiny_root)
    work = tempfile.mkdtemp()
    try:
        inputs = drivers.Inputs(cfg, harness.traffic_of(w, tiny_root), seed, work)
        a = Assembler(work + "/run", drivers.assembly_config(cfg), device="cpu")
        a.add_reads([inputs.fasta])
        a.select_kmers()
        a.find_markers()
        a.flag_palindromic_reads()
        a.find_alignment_candidates()
        c = a.candidates
        cands = list(zip(c.read_id0.tolist(), c.read_id1.tolist(), c.same_strand.tolist()))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mk = inputs.markers({r for p in cands for r in p[:2]})
    p = inputs.params
    stated = reference.align(mk, cands, p, "cpu", band="stated")
    classed = reference.align(mk, cands, p, "cpu")
    assert reference.mismatched(mk, cands, p, "cpu", [stated, classed])[0] == 0


def test_mismatched_takes_either_sound_answer(monkeypatch):
    from perfbench import reference

    A, B, C = ({"marker_count": n} for n in (1, 2, 3))
    by_band = {"class": [A, A, None], "stated": [B, A, None]}
    monkeypatch.setattr(reference, "align",
                        lambda _mk, cands, _p, _dev, band="class": [by_band[band][c[0]]
                                                                    for c in cands])
    cands = [(q, q, True) for q in range(3)]
    assert reference.mismatched(None, cands, None, "cpu", [[B, A, None], [A, A, None]]) == (0, 2)
    assert reference.mismatched(None, cands, None, "cpu", [[C, A, None]]) == (1, 2)
    assert reference.mismatched(None, cands, None, "cpu", [[A, None, A]]) == (2, 2)
