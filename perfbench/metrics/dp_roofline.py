"""dp_roofline: the least time of the window's DP launches, forward and
traceback (roofline.py on the program's launch trace: in-matrix band
cells x 13 int32 operations, or walked rows x 12, at the issue limit, or
bytes at the HBM rate, whichever is longer), over the device time of
every kernel the window launched, whatever its name (copies and fills
left out), in %."""


def read(run):
    if run.trace is None or not run.dp_bound_s:
        return None
    kernel_s = run.trace.kernel_seconds()
    if kernel_s <= 0:
        return None
    return 100.0 * run.dp_bound_s / kernel_s
