"""The benchmark's harness: discovery by name (``spec``), the scene made
from a configuration (``scenes``), the window's arithmetic (``stats``),
the traced frames (``profiling``), the yardstick's constants
(``kernels``), the check (``check``) and the JAX guard (``nojax``)."""
