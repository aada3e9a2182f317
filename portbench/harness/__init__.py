"""The port's benchmark harness: one cell, one run (run.py)."""
