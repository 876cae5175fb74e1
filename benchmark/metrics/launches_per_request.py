"""launches_per_request.<mix>: device operations (kernels, copies, fills)
the profiler saw in the traced sub-window, per request completed in it:
the reader of ``launches_per_step``, whose unit is the driver's."""
from benchmark.metrics.launches_per_step import read  # noqa: F401
