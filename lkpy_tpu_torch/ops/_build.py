"""
Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``lib<name>-<hash>.so`` in the kernel build directory
(:func:`lkpy_tpu_torch.config.kernel_build_dir`: ``compile_cache.dir`` or
``$LKT_CACHE_DIR`` where set, else ``build/lkpy_tpu_torch/`` under the
repository root), and is loaded with :mod:`ctypes`.  The file name carries a
hash of the source, of every header under ``csrc/`` that it includes (by
``#include "..."``, directly or through another such header) and of the
flags, so an edited source or header builds anew and an unchanged one is
reused.  Nothing but the repository's own sources goes into a build.
Threads of one process that ask for the same kernel build it once: the
check and the build run under that kernel's lock, so different kernels
still build side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

from lkpy_tpu_torch.config import kernel_build_dir

__all__ = ["NVCC_FLAGS", "library_path", "load", "source_files", "sources"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"

#: sm_90a keeps Hopper-only instructions available
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def sources() -> list[str]:
    """The names of the kernels under ``csrc/``."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
            found = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the headers under ``csrc/`` that it includes in
    quotes, directly or through one another, each once, in the order found.
    A quoted header that is missing raises."""
    found: list[Path] = []
    todo = [_CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = (path.parent / inc.decode()).resolve()
            if not header.is_file():
                raise FileNotFoundError(f"{path.name} includes \"{inc.decode()}\", which is not under {_CSRC}")
            todo.append(header)
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return kernel_build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    # a quoted include is looked up beside the file that names it, so csrc's headers need no -I
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(_compile(name)))
        return lib
