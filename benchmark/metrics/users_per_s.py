"""users_per_s.<mix>: users whose top-k reached the host in the traced
sub-window, per second of it (host clock, under the profiler). Where the
cell's end-to-end metric is the device's time a request, this is where
the host's dispatch shows. Silent where the driver counts no users."""


def read(trace):
    users = trace.counts.get("users")
    if not users or not trace.device or trace.window_s <= 0:
        return None
    return users / trace.window_s
