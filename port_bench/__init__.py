"""The port's benchmark: one run of one cell is ``run.py``."""
