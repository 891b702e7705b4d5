"""95th percentile of the latency of every request due in the window,
each from the time it was due to the return of the round that harvested
its answer, both on the harness's clock (not the program's stamps); a
request that failed or never came back counts as infinitely late (then no
number)."""
import math

from portbench.stats import percentile


def read(run):
    if run["kind"] != "online":
        return None
    value = percentile(run["latency_ms"], 95)
    return value if math.isfinite(value) else None
