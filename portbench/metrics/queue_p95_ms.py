"""95th percentile of the time the window's answered requests waited in
the admission queue (the runtime's ``RequestRecord``: admit - due)."""
import math

from portbench.stats import percentile


def read(run):
    if run["kind"] != "online" or len(run["queue_ms"]) == 0:
        return None
    value = percentile(run["queue_ms"], 95)
    return value if math.isfinite(value) else None
