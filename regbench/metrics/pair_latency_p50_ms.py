"""Median time from a one-pair call to its returned transform, over
every pair of the window (host clock)."""
from regbench.yardstick import percentile


def read(run):
    lat = run.pair_latencies_s
    return 1e3 * percentile(lat, 50) if lat else None
