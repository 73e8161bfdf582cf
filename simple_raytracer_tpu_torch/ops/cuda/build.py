"""Build a source of the port into a shared library and bind it with ctypes.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` on first use
into a shared library with a plain C interface under
``build/srt_torch_kernels/``, named by a hash of the source, the headers
beside it, the compiler and the flags, and loaded with ``ctypes``.
No PyTorch header is compiled, so a build takes seconds.  With
``SRT_NO_COMPILE_CACHE`` set (the JAX package's opt-out of its persistent
compile cache), every source is built anew into a fresh temporary
directory under ``build/`` instead.  A ``Kernel`` also counts its
launches, in all and per variant.  ``HostLibrary`` is the
same for a C++ source of the host (``csrc/host_accel.cpp``), compiled by
the host compiler (``$CXX``, else ``c++``) into the same directory.
``build_all`` builds several at once, one compiler each.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "srt_torch_kernels"
# SRT_NO_COMPILE_CACHE, read once, at import, as the JAX package's
# __init__.py reads it: set (to anything but ""), no build of BUILD_DIR is
# reused; each source is built into a fresh temporary directory beside it
COMPILE_CACHE = not os.environ.get("SRT_NO_COMPILE_CACHE")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# no -march=native: the library's results must not depend on the host
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]


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

    headers = ("*.cuh",)     # the sources beside it that it includes

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None],
                 extra_flags: Sequence[str] = (), tag: str = ""):
        self.source = Path(source)
        self.flags = NVCC_FLAGS + list(extra_flags)
        self.tag = tag        # a name for a build of its own (its flags')
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

    def compiler(self) -> str:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA toolkit is "
                               f"needed to build {self.source.name}")
        return nvcc

    def _build(self) -> ctypes.CDLL:
        import time
        t0 = time.perf_counter()
        headers = sorted(p for pattern in self.headers
                         for p in self.source.parent.glob(pattern))
        src = b"".join(p.read_bytes() for p in [self.source, *headers])
        cc = self.compiler()
        digest = hashlib.sha256(src + " ".join([cc, *self.flags]).encode()
                                ).hexdigest()[:16]
        directory = BUILD_DIR
        if not COMPILE_CACHE:
            BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
            directory = Path(tempfile.mkdtemp(prefix=BUILD_DIR.name + "-",
                                              dir=BUILD_DIR.parent))
        tag = f"-{self.tag}" if self.tag else ""
        out = directory / f"{self.source.stem}{tag}-{digest}.so"
        if not out.exists():
            directory.mkdir(parents=True, exist_ok=True)
            # two processes (or Kernels) of one source may build at once
            tmp = out.with_suffix(f".{os.getpid()}.{id(self)}.tmp")
            try:
                proc = subprocess.run(
                    [cc, *self.flags, "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True)
            except OSError as exc:
                raise RuntimeError(f"{cc} could not be run to build "
                                   f"{self.source.name}: {exc}") from exc
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{cc} failed ({proc.returncode}) on "
                                   f"{self.source.name}:\n{self.build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        self._loaded(lib)
        self.build_seconds = time.perf_counter() - t0
        return lib

    def _loaded(self, lib: ctypes.CDLL) -> None:
        lib.srt_error_string.argtypes = [ctypes.c_int]
        lib.srt_error_string.restype = ctypes.c_char_p
        self._bind(lib)

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            raise RuntimeError(f"{what} launch failed: "
                               + self.library().srt_error_string(err).decode())


class HostLibrary(Kernel):
    """A C++ source of the host, built by the host compiler (``$CXX``,
    else ``c++``) with ``HOST_FLAGS``; it launches nothing on the card,
    so its counts stay 0."""

    headers = ()

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        super().__init__(source, bind)
        self.flags = list(HOST_FLAGS)

    def compiler(self) -> str:
        return (os.environ.get("CXX") or shutil.which("c++")
                or shutil.which("g++") or "c++")

    def _loaded(self, lib: ctypes.CDLL) -> None:
        self._bind(lib)


def build_all(kernels: Sequence[Kernel]) -> None:
    """Build every kernel at once (a thread and one compiler each); raise
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
