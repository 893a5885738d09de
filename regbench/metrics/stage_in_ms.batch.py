"""Host ms a pair in ``entry.stage_in`` and ``step.setup``: the host's work
at the head of a call (cap, pad, stack, copy in, generators), with
nothing of the call queued on the card yet."""
from regbench.spans import span_ms_per_pair


def read(run):
    return span_ms_per_pair(run, ("entry.stage_in", "step.setup"))
