"""Pairs registered in the window over its seconds (host clock)."""


def read(run):
    return run.pairs / run.window_s if run.window_s else None
