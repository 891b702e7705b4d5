"""Queries completed in the window over the window's seconds (host clock;
the window ends with the last batch that started in it)."""


def read(run):
    if run["kind"] != "bulk" or run["window_s"] <= 0:
        return None
    return run["completed"] / run["window_s"]
