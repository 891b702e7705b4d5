"""Seconds from the process's start to the first timed query: inputs,
index build, store, kernel library, capture and warm-up."""


def read(run):
    return run["setup_s"]
