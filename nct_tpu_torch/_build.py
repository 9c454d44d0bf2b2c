"""Build the sources in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` (a CUDA source, built with nvcc) or
``csrc/<name>.cpp`` (a host source, built with the host C++ compiler)
becomes ``_build/<name>-<hash>.so``, where the hash covers the source and
the compiler flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing is built at import: the first call of ``load(name)``
compiles, and raises ``RuntimeError`` when it cannot.  Each library has a
plain C interface, so the build needs no PyTorch headers and takes seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

# No fast math: the NN kernel's IEEE division must match the reference.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# Host sources: no fast math, no -march, so every host decodes alike.
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _host_cxx() -> str:
    for cand in ("c++", "g++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (c++ or g++) found to build "
                       "the host sources in csrc/")


def _source(name: str) -> str:
    """csrc/<name>.cu if there is one, else csrc/<name>.cpp."""
    cu = os.path.join(CSRC, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC, f"{name}.cpp")


def _flags(src: str) -> tuple[str, ...]:
    return NVCC_FLAGS if src.endswith(".cu") else HOST_FLAGS


def library_path(name: str) -> str:
    """Path of the built library for csrc/<name>.cu or .cpp (built or
    not)."""
    src = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(src)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu or .cpp unless an up-to-date library exists.
    Returns the library path; the compiler's output (for nvcc, register
    and shared-memory use from ``-Xptxas -v``) is kept beside it as
    ``.log``."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    src = _source(name)
    compiler = _nvcc() if src.endswith(".cu") else _host_cxx()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *_flags(src), "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(out[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(compiler)} failed for "
                           f"{os.path.basename(src)}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu or .cpp as a ctypes
    library; ``RuntimeError`` when either step fails."""
    path = build(name)
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
