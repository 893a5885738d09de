"""Device ms a pair of operations launched inside the registration
core's ranges (descriptors through rescore)."""
from regbench.layers import CORE, device_ms_per_pair


def read(run):
    return device_ms_per_pair(run, CORE)
