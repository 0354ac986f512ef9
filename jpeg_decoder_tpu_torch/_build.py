"""Compile one source file into a cached shared library.

Both native builds of the port, the entropy library (g++) and the CUDA
kernels (nvcc), go through :func:`shared_lib`.  The library's name carries a
hash of the source bytes and the compiler flags, so an edited source or a
changed flag set never loads a stale build, whatever the files' mtimes say.
:class:`CudaLib` builds one ``csrc/*.cu`` file with nvcc for sm_90a at first
use and binds its plain C entry points with ctypes.  A source may include
headers of ``csrc/`` (``#include "name.cuh"``): every compile gets ``-I
csrc``, and the hash covers those headers' bytes too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections.abc import Sequence

from .utils import profiling

#: Root of the build cache, ``.cache/torch/`` beside the package.
CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".cache", "torch")
#: The port's CUDA sources.
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class KernelBuildFailure(RuntimeError):
    """nvcc is missing or refused a ``csrc/*.cu`` source."""


def _local_headers(code: bytes) -> list[str]:
    """The ``csrc/`` headers a source names in ``#include "..."`` lines."""
    return [os.path.join(CSRC, m.decode()) for m in
            re.findall(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', code,
                       re.M)]


def lib_path(src: str, flags: Sequence[str], subdir: str, stem: str) -> str:
    """``.cache/torch/<subdir>/lib<stem>_<hash>.so`` for this source, the
    ``csrc/`` headers it includes and the flag set."""
    with open(src, "rb") as f:
        key = f.read()
    for header in _local_headers(key):
        with open(header, "rb") as f:
            key += b"\0" + f.read()
    key += "\0".join(flags).encode()
    tag = hashlib.sha256(key).hexdigest()[:16]
    return os.path.join(CACHE, subdir, f"lib{stem}_{tag}.so")


def shared_lib(compiler: str, flags: Sequence[str], src: str, subdir: str,
               stem: str, error: type[Exception]) -> tuple[str, str | None]:
    """Build ``src`` with ``compiler flags -o <lib> src`` unless that exact
    build is cached.  Returns the library's path and the compiler's output
    (None when the cached build was used).  A missing compiler or a failed
    build raises ``error``."""
    path = lib_path(src, flags, subdir, stem)
    if os.path.exists(path):
        return path, None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        proc = subprocess.run(
            [compiler, *flags, "-I", CSRC, "-o", tmp, src],
            capture_output=True, text=True)
    except FileNotFoundError as e:
        raise error(f"{compiler} not found: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise error(f"{compiler} failed on {src}:\n{log}")
    os.replace(tmp, path)
    return path, log


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, ``$PATH``, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildFailure("nvcc not found (set CUDA_HOME)")


class CudaLib:
    """One ``csrc/<name>`` built with nvcc at first use (into
    ``.cache/torch/kernels/lib<stem>_<hash>.so``) and loaded with ctypes.

    ``signatures`` maps each C entry point to its ctypes argument types;
    every entry point returns an int (``cudaGetLastError()`` after its
    launch, 0 = launched).  A missing nvcc or a refused source raises
    :class:`KernelBuildFailure`."""

    def __init__(self, name: str, stem: str,
                 signatures: dict[str, list]):
        self.src = os.path.join(CSRC, name)
        self.stem = stem
        self.signatures = signatures
        #: nvcc's output of the last build (register and shared-memory use).
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> str:
        """Where this source's build lives (built or not)."""
        return lib_path(self.src, NVCC_FLAGS, "kernels", self.stem)

    def load(self):
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                path, log = shared_lib(nvcc(), NVCC_FLAGS, self.src,
                                       "kernels", self.stem,
                                       KernelBuildFailure)
                if log is not None:
                    self.build_log = log
                    profiling.count("kernels.build")
                lib = ctypes.CDLL(path)
                profiling.count("kernels.load")
                for fn, argtypes in self.signatures.items():
                    getattr(lib, fn).restype = ctypes.c_int
                    getattr(lib, fn).argtypes = argtypes
                self._lib = lib
        return self._lib


def launch_check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
