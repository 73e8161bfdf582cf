"""The plain reference that decides ``correct``: a path tracer in plain
PyTorch (``tracer.py``) over its own linear BVH (``lbvh.py``) and the
reference application's hash RNG (``rng.py``).  It imports nothing of the
program and takes nothing the program made."""
