"""Build the package's CUDA kernels from their sources, on first use.

Each source under ``csrc/`` is compiled by its own ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``.  The libraries land in ``_build/`` beside this file, each named
by a hash of its source, the ``.cuh`` headers beside it and the flags, so
an edited source is rebuilt and an unchanged one is built once per
checkout.  :func:`build` with no name
starts every missing compile at once and waits for all of them.  The
compiler's report (``-Xptxas -v``: registers, shared memory and spills
per kernel) is kept beside each library as ``<library>.log``.
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
SOURCES = {name: os.path.join(_HERE, "csrc", name + ".cu")
           for name in ("dia_spmv", "sell_spmv", "dia_spmm", "sell_spmm",
                        "probe_stream", "probe_dia_ring",
                        "probe_sell_ablation", "probe_onehot_mma",
                        "probe_bell_mma")}
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


def _digest(name):
    """Hash of the flags, the source and the headers beside it (a source
    may include any of them)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    csrc = os.path.dirname(SOURCES[name])
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    for path in [SOURCES[name]] + [os.path.join(csrc, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _library(name):
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, _digest(name)))


def build(name=None):
    """Compile the named source (every source when ``name`` is None)
    unless this version is built.  Returns the library's path, or a dict
    of name -> path."""
    names = list(SOURCES) if name is None else [name]
    libs = {n: _library(n) for n in names}
    todo = [n for n in names if not os.path.exists(libs[n])]
    if todo:
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for n in todo:  # all compiles run at once
            tmp = "%s.%d.tmp" % (libs[n], os.getpid())
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[n]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            report = proc.communicate()[0]
            with open(libs[n] + ".log", "w") as f:
                f.write(report)
            if proc.returncode != 0:
                failed.append("%s: nvcc failed with exit code %d:\n%s"
                              % (n, proc.returncode, report))
            else:
                # atomic: a concurrent build never sees a partial library
                os.replace(tmp, libs[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs if name is None else libs[name]


@functools.lru_cache(maxsize=None)
def load(name):
    """The named kernel's library, loaded once per process."""
    return ctypes.CDLL(build(name))
