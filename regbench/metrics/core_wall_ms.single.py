"""Host ms a pair inside the registration core's ranges (descriptors
through rescore)."""
from regbench.layers import CORE, wall_ms_per_pair


def read(run):
    return wall_ms_per_pair(run, CORE)
