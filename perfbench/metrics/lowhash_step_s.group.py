"""lowhash_step_s.group: seconds per assembly in the program's span
``stage:lowhash.group`` (every iteration's bucket sort, bucket-size
filter, bucket statistics and high-bits collision groups), on the
host's clock of the device trace."""

from perfbench.spans_lowhash import seconds_per_assembly


def read(run):
    return seconds_per_assembly(run, "stage:lowhash.group")
