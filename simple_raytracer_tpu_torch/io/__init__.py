"""Image files of the port (``image.py``)."""
