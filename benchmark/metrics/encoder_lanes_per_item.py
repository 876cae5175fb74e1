"""encoder_lanes_per_item.<mix>: the encoder lanes serving ran a catalogue
item, the work done over the work needed: the ``lanes`` of the program's
``forward`` spans under its ``serve`` spans over the ``items`` of its
``tile`` spans there (each served user's tile lanes, the last tile's
padding included, against each catalogue item once a tile). 1.0: each
ranked item encoded once. Silent where the window holds no serving tile."""
from benchmark.metrics._program_spans import phase_of, records


def read(trace):
    recs = records(trace)
    if recs is None:
        return None
    served = phase_of(recs, {"serve"})
    lanes = sum(r.counts.get("lanes", 0) for r in recs
                if r.name == "forward" and served[r.id] == "serve")
    items = sum(r.counts.get("items", 0) for r in recs
                if r.name == "tile" and served[r.id] == "serve")
    return lanes / items if items else None
