"""Build the package's CUDA kernels from its sources, on first use.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``_build/`` beside this file, named by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is built once per checkout.  The compiler's report
(``-Xptxas -v``: registers, shared memory and spills per kernel) is kept
beside it as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

__all__ = ["SOURCES", "BUILD_DIR", "find_nvcc", "build", "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_HERE, "csrc", "dia_spmv.cu"),)
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc():
    """Path of ``nvcc``: on ``PATH``, else in ``$CUDA_HOME/bin``
    (default ``/usr/local/cuda``)."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = (shutil.which("nvcc")
            or shutil.which("nvcc", path=os.path.join(cuda_home, "bin")))
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or in %s/bin: the CUDA kernels of "
            "pykrylov_tpu_torch are compiled from csrc/ at first use and "
            "need the CUDA toolkit (set CUDA_HOME to its root)" % cuda_home)
    return nvcc


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the sources unless this version is built; return the
    library's path."""
    lib = os.path.join(BUILD_DIR, "libpykrylov_cuda_%s.so" % _digest())
    if os.path.exists(lib):
        return lib
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *SOURCES],
                          capture_output=True, text=True)
    with open(lib + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed with exit code %d:\n%s"
                           % (proc.returncode, proc.stdout + proc.stderr))
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial
    return lib


@functools.lru_cache(maxsize=None)
def load():
    """The built library, loaded once per process."""
    return ctypes.CDLL(build())
