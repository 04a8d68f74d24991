"""lowhash_step_s.hash: seconds per assembly in the program's span
``stage:lowhash.hash`` (the feature words' upload and premix once a
LowHash call, then every iteration's feature hashes and low-hash filter,
on the run's device), on the host's clock of the device trace."""

from perfbench.spans_lowhash import seconds_per_assembly


def read(run):
    return seconds_per_assembly(run, "stage:lowhash.hash")
