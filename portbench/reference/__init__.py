"""Plain references of the benchmark's configurations (see ``gp.py``)."""
