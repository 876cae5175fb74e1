"""mfu.<mix>: the whole step's (or request's) share of the card's peak, in
%: the floating-point operations its outputs need (``yardstick/flops.py``,
counted by the driver for the units it completed) over the traced
sub-window's seconds and the peak of the configuration's precision
(``yardstick/peaks.py``). Unrounded. Silent where nothing ran on the
device."""
from benchmark.yardstick.peaks import PEAK_FLOPS


def read(trace):
    flops = trace.counts.get("flops")
    if not flops or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * PEAK_FLOPS[trace.counts["peak_flops"]])
