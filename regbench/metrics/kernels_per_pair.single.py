"""Kernels in the traced stretch a pair."""


def read(run):
    t = run.trace
    return None if t is None or not t.pairs else t.kernels / t.pairs
