"""Passes of extraction's lockstep round loop a pair (the program's
``extract.rounds`` counter)."""
from regbench.spans import counter_per_pair


def read(run):
    return counter_per_pair(run, "extract.rounds")
