"""Tools that fix the benchmark's numbers once, on the card: the online
cells' sustained rate (``sweep.py``) and the controls' readings
(``control.py``). The benchmark's own runs use neither."""
