"""Compile one source file into a cached shared library.

Both native builds of the port, the entropy library (g++) and the CUDA
kernel (nvcc), go through :func:`shared_lib`.  The library's name carries a
hash of the source bytes and the compiler flags, so an edited source or a
changed flag set never loads a stale build, whatever the files' mtimes say.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from collections.abc import Sequence

#: Root of the build cache, ``.cache/torch/`` beside the package.
CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".cache", "torch")


def lib_path(src: str, flags: Sequence[str], subdir: str, stem: str) -> str:
    """``.cache/torch/<subdir>/lib<stem>_<hash>.so`` for this source and
    flag set."""
    with open(src, "rb") as f:
        key = f.read() + "\0".join(flags).encode()
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
        proc = subprocess.run([compiler, *flags, "-o", tmp, src],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise error(f"{compiler} not found: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise error(f"{compiler} failed on {src}:\n{log}")
    os.replace(tmp, path)
    return path, log
