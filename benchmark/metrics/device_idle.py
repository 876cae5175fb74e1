"""device_idle.<mix>: the share of the traced sub-window, in %, in which
no device operation ran (the union of the profiler's device intervals
against the window). Silent where the trace holds no device operation."""


def read(trace):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
