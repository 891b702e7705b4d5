"""Traffic mixes: one data file per mix (``<mix>.json``), read by the one
general generator in ``generator.py``."""
