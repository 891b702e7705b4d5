"""Seconds of the index build by the program's own stage timers
(``build_l2_graph(stats=)``: kNN, prune and symmetrize)."""


def read(run):
    b = run.get("build")
    if not b:
        return None
    return b["knn_s"] + b["prune_s"] + b["symmetrize_s"]
