"""refresh_share.<mix>: the share of the traced sub-window, in %, spent in
the per-epoch context and pair refresh (``PMGTTask.on_epoch_start``),
timed by the benchmark's span around it between device syncs. Silent
where no refresh ran."""


def read(trace):
    t = trace.span_time_s("refresh")
    if t <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * t / trace.window_s
