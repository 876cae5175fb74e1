"""nodes_per_s.<mix>: target nodes of the optimizer steps completed in the
traced sub-window, per second of it (host clock, under the profiler).
Where the cell's end-to-end metric is the device's time a step, this is
where the host's dispatch and the refresh show. Silent where the driver
counts no nodes."""


def read(trace):
    nodes = trace.counts.get("nodes")
    if not nodes or not trace.device or trace.window_s <= 0:
        return None
    return nodes / trace.window_s
