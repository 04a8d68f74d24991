"""lowhash_step_s.pairs: seconds per assembly in the program's span
``stage:lowhash.pairs`` (every iteration's collision-group pairs
expanded, counted and merged into the running table of distinct pairs;
then the minFrequency cut and the candidates' fetch), on the host's
clock of the device trace."""

from perfbench.spans_lowhash import seconds_per_assembly


def read(run):
    return seconds_per_assembly(run, "stage:lowhash.pairs")
