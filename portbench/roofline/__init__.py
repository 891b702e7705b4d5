"""Frozen roofline arithmetic of the search: H100 peaks (``peaks.json``),
the operations and bytes of each stage's work counted from the program's
counters (``stages.py``), and the kernels that do each stage's work
(``kernels.json``)."""
