"""The plain reference of the benchmark's programs (``graph.py``)."""
