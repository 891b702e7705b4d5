"""The share of a traced stretch in which no device operation ran, in %
(shared by the ``device_idle.*`` readers)."""


def idle_share(run, kind):
    t = run.get("trace")
    if run["kind"] != kind or not t or t.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
