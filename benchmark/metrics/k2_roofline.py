"""k2_roofline.<mix>: kernel K2's share of its roofline, in % (see
``_roofline.py``)."""
from benchmark.metrics._roofline import share


def read(trace):
    return share("k2", trace)
