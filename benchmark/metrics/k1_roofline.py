"""k1_roofline.<mix>: kernel K1's share of its roofline, in % (see
``_roofline.py``)."""
from benchmark.metrics._roofline import share


def read(trace):
    return share("k1", trace)
