"""Host ms a pair in the program's ``prepare`` spans."""
from regbench.spans import span_ms_per_pair


def read(run):
    return span_ms_per_pair(run, ("prepare",))
