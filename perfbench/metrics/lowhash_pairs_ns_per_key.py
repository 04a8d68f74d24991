"""lowhash_pairs_ns_per_key: seconds per assembly in the program's span
``stage:lowhash.pairs`` over the pair keys that an assembly's LowHash
counted (``ops/lowhash.py:COUNTS``, its last call; every assembly of a
window runs on the same reads), in ns."""

from perfbench.spans_lowhash import pair_keys, seconds_per_assembly


def read(run):
    s = seconds_per_assembly(run, "stage:lowhash.pairs")
    keys = pair_keys()
    if s is None or keys is None:
        return None
    return s * 1e9 / keys
