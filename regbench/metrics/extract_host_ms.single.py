"""Host ms a pair in the program's ``extract`` spans (both clouds), over
the window's untraced calls."""
from regbench.spans import span_ms_per_pair


def read(run):
    return span_ms_per_pair(run, ("extract",))
