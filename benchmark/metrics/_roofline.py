"""A dual-attention kernel's share of its roofline, in %: the least time of
the dual attention the traced units needed (the driver's ``kernel_work``
per unit, from the configuration and the mix, at ``yardstick/peaks.py``'s
bounds), over the summed device time of the kernel's events. Silent where
the kernel did not run or the units need none of its work."""
from benchmark.yardstick import peaks

BOUNDS = {"k1": peaks.k1_bound_s, "k2": peaks.k2_bound_s}


def share(key, trace):
    calls = trace.counts.get("kernel_work", {}).get(key) or []
    launches, seconds = trace.kernel_time_s(key)
    if not calls or launches == 0 or seconds <= 0 or trace.units <= 0:
        return None
    return 100.0 * trace.units * sum(BOUNDS[key](*c) for c in calls) / seconds
