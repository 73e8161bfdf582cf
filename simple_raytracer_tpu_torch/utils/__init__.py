"""Host utilities of the port: timing and throughput (``metrics.py``)."""
