"""device_ms_per_request.<mix>: device milliseconds per request completed
in the profiled window (the traced sub-window for a per-layer metric, the
whole timed window for an end-to-end one): the reader of
``device_ms_per_step``, whose unit is the driver's."""
from benchmark.metrics.device_ms_per_step import read  # noqa: F401
