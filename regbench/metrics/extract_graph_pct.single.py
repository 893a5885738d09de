"""The share of extraction's lockstep passes replayed from a CUDA graph:
100 x ``extract.graph_rounds`` over ``extract.rounds``, over the window's
untraced calls; None where the program counts no graph rounds."""
from regbench.spans import counter_pct, window_calls


def read(run):
    recs = window_calls(run)
    if not recs or not any("extract.graph_rounds" in r.get("counters", {})
                           for r in recs):
        return None
    return counter_pct(run, "extract.graph_rounds", "extract.rounds")
