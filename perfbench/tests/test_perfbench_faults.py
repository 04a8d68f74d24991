"""The check sees a broken timed path: the rest of a run with the
program's alignment stage, or its assembly's output, broken underneath
comes out not correct."""

import json

import pytest

from perfbench.tests import tiny


def broken(kind):
    from shasta_tpu_torch.ops.align import align_candidates

    def align(markers, r0, r1, ss, *args, **kw):
        if kind == "half":  # half of the candidates left out
            return align_candidates(markers, r0[::2], r1[::2], ss[::2], *args, **kw)
        store = align_candidates(markers, r0, r1, ss, *args, **kw)
        if kind == "altered":  # each alignment's last matched marker moved
            last = store.offsets[1:] - 1
            store.ord1[last[store.offsets[1:] > store.offsets[:-1]]] += 1
        return store

    return align


@pytest.mark.parametrize("kind", ["half", "altered"])
def test_broken_alignment_is_not_correct(kind, tiny_root, capsys, monkeypatch):
    from shasta_tpu_torch.pipeline import assemble

    monkeypatch.setattr(assemble, "align_candidates", broken(kind))
    assert tiny.run(tiny_root, "tiny.align", seed=2**31 + 21) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["checks"]["mismatched_alignments"]["value"] > 0


def test_altered_assembly_is_not_correct(tiny_root, capsys, monkeypatch):
    from shasta_tpu_torch.graph import assembly_graph as AG

    write = AG.write_fasta

    def altered(path, graph, *args, **kw):  # every 50th base of the contigs changed
        write(path, graph, *args, **kw)
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")
        for n, line in enumerate(lines):
            if line and not line.startswith(b">"):
                seq = bytearray(line)
                seq[::50] = bytes(ord("C") if c == ord("A") else ord("A") for c in seq[::50])
                lines[n] = bytes(seq)
        with open(path, "wb") as f:
            f.write(b"\n".join(lines))

    monkeypatch.setattr(AG, "write_fasta", altered)
    assert tiny.run(tiny_root, "tiny.assemble", seed=2**31 + 22) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False
    c = res["checks"]["contig_errors_per_100kb"]
    assert c["value"] > c["limit"]
