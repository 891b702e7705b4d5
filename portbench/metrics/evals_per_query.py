"""Measure evaluations per query over the window's answers (the search
results' ``n_eval``: the paper's Table 2 count)."""


def read(run):
    if not run["completed"]:
        return None
    return run["n_eval"] / run["completed"]
