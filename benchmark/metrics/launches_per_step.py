"""launches_per_step.<mix>: device operations (kernels, copies, fills)
the profiler saw in the traced sub-window, per optimizer step completed
in it."""


def read(trace):
    if not trace.device or trace.units <= 0:
        return None
    return len(trace.device) / trace.units
