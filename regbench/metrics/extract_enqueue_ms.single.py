"""Host ms a pair in ``extract`` less its ``extract.done_read`` spans: the
host issuing extraction's work, not waiting for it."""
from regbench.spans import span_ms_per_pair


def read(run):
    return span_ms_per_pair(run, ("extract",), less=("extract.done_read",))
