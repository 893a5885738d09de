"""K1 (oriented nearest neighbour) share of its roofline over the live
rows its launches are given (yardstick.launch_work), in %."""
from regbench.layers import roofline_pct


def read(run):
    return roofline_pct(run, "k1")
