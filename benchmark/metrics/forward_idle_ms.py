"""forward_idle_ms.<mix>: card-idle milliseconds a unit (step or request) of
the traced sub-window under the program's ``forward`` spans and their
children (see ``_program_spans.py``)."""
from benchmark.metrics._program_spans import idle_ms_under


def read(trace):
    return idle_ms_under(trace, "forward")
