"""The window's seconds over the engine's steps in it
(``engine.stats['steps']``), in microseconds."""


def read(run):
    if run["kind"] != "bulk" or not run["steps"]:
        return None
    return 1e6 * run["window_s"] / run["steps"]
