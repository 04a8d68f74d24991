"""peak_host_gib: the process's peak resident memory within the window
(sampled every 10 ms from the window's start to its end), in GiB."""


def read(run):
    return run.host_peak_bytes / float(1 << 30)
