"""Build a CUDA source of the port with ``nvcc`` and bind it with ctypes.

Each kernel source under ``csrc/`` is compiled on first use into a shared
library with a plain C interface under ``build/srt_torch_kernels/``,
named by a hash of the source, the headers beside it and the flags, and
loaded with ``ctypes``.
No PyTorch header is compiled, so a build takes seconds.  A ``Kernel``
also counts its launches, in all and per variant.  ``build_all`` builds
several at once, one nvcc each.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "srt_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def interface(lib: ctypes.CDLL, name: str) -> int:
    """The version of a build's C interface, which its source exports as
    the int function ``name``; a build of a source from before the export
    has version 1."""
    if not hasattr(lib, name):
        return 1
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


class Kernel:
    """One CUDA source: its built library, nvcc's output and counts of
    launches, in all (``launches``) and per variant
    (``variant_launches``).  ``bind`` sets the library's argtypes."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None],
                 extra_flags: Sequence[str] = ()):
        self.source = Path(source)
        self.flags = NVCC_FLAGS + list(extra_flags)
        self.launches = 0
        self.variant_launches = collections.Counter()
        self.build_log = ""
        self.build_seconds = None
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def reset_counts(self) -> None:
        with self._lock:
            self.launches = 0
            self.variant_launches.clear()

    def count(self, variant: str) -> None:
        """Count one launch of ``variant``; called right after it (under
        the lock: launches may come from several threads)."""
        with self._lock:
            self.launches += 1
            self.variant_launches[variant] += 1

    def library(self) -> ctypes.CDLL:
        """Build (once per source hash) and load the shared library."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build()
            return self._lib

    def _build(self) -> ctypes.CDLL:
        import time
        t0 = time.perf_counter()
        headers = sorted(self.source.parent.glob("*.cuh"))
        src = b"".join(p.read_bytes() for p in [self.source, *headers])
        digest = hashlib.sha256(src + " ".join(self.flags).encode()
                                ).hexdigest()[:16]
        out = BUILD_DIR / f"{self.source.stem}-{digest}.so"
        if not out.exists():
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the CUDA toolkit is "
                                   f"needed to build {self.source.name}")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # two Kernels of one source and flags may build at once
            tmp = out.with_suffix(f".{os.getpid()}.{id(self)}.tmp")
            proc = subprocess.run(
                [nvcc, *self.flags, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{self.source.name}:\n{self.build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.srt_error_string.argtypes = [ctypes.c_int]
        lib.srt_error_string.restype = ctypes.c_char_p
        self._bind(lib)
        self.build_seconds = time.perf_counter() - t0
        return lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            raise RuntimeError(f"{what} launch failed: "
                               + self.library().srt_error_string(err).decode())


def build_all(kernels: Sequence[Kernel]) -> None:
    """Build every kernel at once (a thread and one nvcc each); raise
    RuntimeError naming each source that failed, after all have ended."""
    errors = []

    def build(kernel):
        try:
            kernel.library()
        except Exception as exc:          # reported below, for any cause
            errors.append(f"{kernel.source}: {exc!r}")

    threads = [threading.Thread(target=build, args=(k,)) for k in kernels]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
