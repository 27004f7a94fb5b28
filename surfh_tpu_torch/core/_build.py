"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from ``surfh_tpu_torch/csrc/`` into
``build/surfh_tpu_torch/`` at the repository root (git-ignored), for
``sm_90a`` (Hopper), as a shared object with a plain C interface — no
PyTorch headers, so a build takes seconds.  The file name carries a hash
of the flags and of every file the build reads (the sources and the
headers of ``csrc/`` that they include), so an edited source or header
rebuilds and a stale library is never loaded.  Nothing is downloaded; a
missing nvcc raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "surfh_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the build log
]

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_loaded: dict = {}
build_logs: dict = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, else raise."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME, $PATH, /usr/local/cuda)")


def build_inputs(sources) -> list:
    """Every file the build of `sources` reads: the sources and, followed
    through, the files of csrc/ they include (``#include "name"``)."""
    files = list(sources)
    for f in files:  # grows while it is walked
        for inc in _INCLUDE.findall((CSRC / f).read_text()):
            if inc not in files:
                files.append(inc)
    return files


def library_path(name: str, sources) -> Path:
    """lib<name>-<hash>.so under BUILD_DIR, the hash over the flags and the
    name and contents of every file of `build_inputs(sources)`."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in build_inputs(sources):
        h.update(f.encode() + b"\0" + (CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_library(name: str, sources) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) into lib<name>-<hash>.so
    once per process and version of the files the build reads; return the
    loaded library."""
    paths = [CSRC / s for s in sources]
    so = library_path(name, sources)
    if so in _loaded:
        return _loaded[so]
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{build_logs[name]}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _loaded[so] = lib
    return lib
