"""Host reads of device values (core.types.HOST_SYNCS) a pair, over the
whole window."""
from regbench.layers import host_syncs_per_pair


def read(run):
    return host_syncs_per_pair(run)
