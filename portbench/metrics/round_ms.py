"""The window's seconds over the runtime's rounds in it (``step_once``
calls, counted by the benchmark), in ms."""


def read(run):
    if run["kind"] != "online" or not run["rounds"]:
        return None
    return 1e3 * run["window_s"] / run["rounds"]
