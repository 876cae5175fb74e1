"""untraced_idle_ms.<mix>: card-idle milliseconds a unit of the traced
sub-window in which no program span was open on the host: the caller's
code (the benchmark's own, around its calls) and the program's code that
no span covers (see ``_program_spans.py``)."""
from benchmark.metrics._program_spans import untraced_idle_ms


def read(trace):
    return untraced_idle_ms(trace)
