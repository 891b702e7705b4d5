"""The share of the traced batches' time in which no device operation
ran, in % (bulk cells)."""
from portbench.metrics._idle import idle_share


def read(run):
    return idle_share(run, "bulk")
