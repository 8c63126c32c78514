"""Build-at-first-use shared libraries (host C++ and CUDA) bound with ctypes.

Sources ship in the package; each library is compiled into the git-ignored
``_build/`` directory beside this file the first time it is loaded, and again
whenever a source is newer than the library.  Nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

__all__ = ["BUILD_DIR", "nvcc_path", "build_library"]

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_LOCK = threading.Lock()  # guards _LOCKS
_LOCKS: Dict[str, threading.Lock] = {}  # one per library: builds run in parallel
_LOADED: Dict[str, ctypes.CDLL] = {}
# compiler output of every build made by this process (chip_smoke prints it)
BUILD_LOG: List[str] = []


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default home."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build_library(name: str, sources: Sequence[str], command: Sequence[str],
                  headers: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``sources`` into ``_build/lib<name>.so`` (if stale) and load it.

    ``command`` is the compiler invocation without its output and sources;
    ``-o <lib> <sources>`` are appended.  ``headers`` are the sources' own
    includes: a newer one makes the library stale too.  The library is
    written under a temporary name and renamed, so a concurrent loader never
    sees a partial file.
    """
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"lib{name}.so")
        stale = not os.path.exists(path) or any(
            os.path.getmtime(path) < os.path.getmtime(s) for s in (*sources, *headers))
        if stale:
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run(list(command) + ["-o", tmp, *sources],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed:\n{proc.stdout}\n{proc.stderr}")
            BUILD_LOG.append(f"[{name}] {proc.stdout}{proc.stderr}".strip())
            os.replace(tmp, path)
        lib = _LOADED[name] = ctypes.CDLL(path)
        return lib
