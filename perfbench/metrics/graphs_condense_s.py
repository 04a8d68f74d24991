"""graphs_condense_s: seconds per assembly in the program's span
``stage:graphs.condense`` (``graph/assembly_graph.py:create_assembly_graph``:
the alive mask and the native condensation of the marker graph's alive
edges into assembly-graph chains, 11 to 12 times a mode-0 assembly), on
the host's clock of the device trace. None where the program opens no
such span."""

from perfbench.spans_lowhash import seconds_per_assembly


def read(run):
    return seconds_per_assembly(run, "stage:graphs.condense")
