"""One reader per metric, ``<metric>.py``, found by the metric's name in
``BENCHMARK.json``. Each defines ``read(run) -> float | None`` over what
the run produced (``drivers.py``: the window's counts and times, the
judge's recall, the reduced trace) and returns None where it finds
nothing to read; the harness then leaves the metric out of the line."""
