"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``. The build happens at first use, from the sources in
this checkout only, into ``build/kernels/`` at the repository root; the
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded. :func:`build_all`
starts one ``nvcc`` per source, all at once.

A worker process of the mp executor never builds: it calls
:func:`forbid_builds` and loads what its parent's :func:`build_all` built,
and a library that is missing there is an error.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; a non-zero
code raises here. Each :class:`CudaKernel` counts its successful launches
in ``launches`` — a run reads the counts to show which kernels its path
went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: False in a worker process (:func:`forbid_builds`)
_BUILDS_ALLOWED = True


def forbid_builds() -> None:
    """From now on this process loads built libraries only, and raises
    where one is missing instead of starting ``nvcc``."""
    global _BUILDS_ALLOWED
    _BUILDS_ALLOWED = False


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the toolkit
    PyTorch found; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit with sm_90a support")


class CudaLibrary:
    """One ``csrc`` source, built into one shared library; ``flags`` are
    extra ``nvcc`` flags (``-D`` overrides of a source's tile sizes)."""

    def __init__(self, source: str, signatures: dict[str, list], flags: tuple[str, ...] = ()):
        self.source = CSRC / source
        #: C entry point -> ctypes argtypes (each returns an int error code)
        self.signatures = signatures
        self.flags = tuple(flags)
        self._lib: ctypes.CDLL | None = None
        self._tmp: Path | None = None  # where a running nvcc writes
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS + self.flags).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    @property
    def log_path(self) -> Path:
        return self.path.with_suffix(".log")

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this source unless its library exists; the
        caller passes the process to :meth:`finish_build`."""
        if self.path.exists():
            return None
        if not _BUILDS_ALLOWED:
            raise RuntimeError(f"{self.source.name}: no built library at {self.path}, and "
                               "this process may not build (a worker loads what its parent "
                               "built: call kernels.build_all() there first)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = self.path.with_name(f"{self.path.stem}.{os.getpid()}.tmp.so")
        log = open(self.log_path, "w")
        try:
            return subprocess.Popen([find_nvcc(), *NVCC_FLAGS, *self.flags, "-o", str(self._tmp),
                                     str(self.source)],
                                    stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{self.log_path.read_text()}")
        os.replace(self._tmp, self.path)  # atomic: a reader never sees half a library

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.path))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.error_string.argtypes = [ctypes.c_int]
                lib.error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


class CudaKernel:
    """One C entry point of a :class:`CudaLibrary`, with its launch count."""

    def __init__(self, name: str, library: CudaLibrary, entry: str):
        self.name = name
        self.library = library
        self.entry = entry
        self.launches = 0
        self._lock = threading.Lock()
        KERNELS.append(self)

    @property
    def source(self) -> Path:
        return self.library.source

    def launch(self, *args) -> None:
        """Call the entry point with ``args`` (pointers and the stream as
        ints, sizes as ints) and count the launch; raises on a CUDA error."""
        lib = self.library.load()
        err = getattr(lib, self.entry)(*args)
        if err != 0:
            msg = lib.error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        with self._lock:
            self.launches += 1


#: every kernel of the port, in the order its module registered it
KERNELS: list[CudaKernel] = []


def build_all() -> float:
    """Build every kernel library that is not built yet, one ``nvcc`` per
    source, all started together. Returns the wall-clock seconds."""
    t0 = time.monotonic()
    libraries = list(dict.fromkeys(k.library for k in KERNELS))
    procs = [(lib, lib.start_build()) for lib in libraries]
    for lib, proc in procs:
        lib.finish_build(proc)
    load_all()
    return time.monotonic() - t0


def load_all() -> None:
    """Load every kernel library (a worker's start-up, with builds
    forbidden: each must exist)."""
    for lib in dict.fromkeys(k.library for k in KERNELS):
        lib.load()


def reset_launches() -> None:
    for k in KERNELS:
        with k._lock:
            k.launches = 0
