"""Host ms a pair in the registration core's spans (descriptors through
rescore, and icp)."""
from regbench.layers import CORE
from regbench.spans import span_ms_per_pair


def read(run):
    return span_ms_per_pair(run, tuple(n.split(".", 1)[1] for n in CORE))
