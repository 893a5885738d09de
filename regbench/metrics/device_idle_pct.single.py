"""Share of the traced stretch in which the card ran nothing: 1 - the
union of its kernels, copies and sets over the stretch (the mean over the
cards used)."""
from regbench.layers import idle_pct


def read(run):
    return idle_pct(run)
