"""Device ms a pair of operations launched inside plade.spacing."""
from regbench.layers import device_ms_per_pair


def read(run):
    return device_ms_per_pair(run, ("plade.spacing",))
