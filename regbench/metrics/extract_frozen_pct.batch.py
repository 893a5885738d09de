"""The share of extraction's lockstep cloud-rounds computed for clouds
already done and discarded: 100 x ``extract.frozen`` over
``extract.cloud_rounds``."""
from regbench.spans import counter_pct


def read(run):
    return counter_pct(run, "extract.frozen", "extract.cloud_rounds")
