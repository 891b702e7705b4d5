"""The runtime's lane occupancy over the window: busy lane-steps over
lane-steps (``ServingMetrics.occupancy`` read as the window closes)."""


def read(run):
    if run["kind"] != "online":
        return None
    return run["occupancy"]
