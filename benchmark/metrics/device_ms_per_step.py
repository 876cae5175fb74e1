"""device_ms_per_step.<mix>: milliseconds in which some device operation
ran (the union of the profiler's device intervals), per step completed in
the profiled window: the traced sub-window for a per-layer metric, the
whole timed window for an end-to-end one. Beside a host-bound rate, which
follows the shared host's speed from run to run, this is the steady part
of a step."""


def read(trace):
    if not trace.device or trace.units <= 0:
        return None
    return 1e3 * trace.busy_s() / trace.units
