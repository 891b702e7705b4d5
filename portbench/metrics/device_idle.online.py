"""The share of the traced second of online serving in which no device
operation ran, in % (online cells)."""
from portbench.metrics._idle import idle_share


def read(run):
    return idle_share(run, "online")
