"""Host ms a pair inside plade.extract (the host sets the pace there)."""
from regbench.layers import wall_ms_per_pair


def read(run):
    return wall_ms_per_pair(run, ("plade.extract",))
