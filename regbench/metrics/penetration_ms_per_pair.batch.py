"""Device ms a pair of operations launched inside plade.penetration (the
penetration filter: its dense test geometry and the point-counting walk)."""
from regbench.layers import device_ms_per_pair


def read(run):
    return device_ms_per_pair(run, ("plade.penetration",))
