"""Build and load the port's CUDA kernels.

Each kernel lives in ``csrc/<name>.cu`` with a plain C entry point. At
first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``_build/`` beside this file, named by a digest of its source
and flags (a changed source builds anew), and loaded with ``ctypes``.
:func:`build` starts one ``nvcc`` per missing library, all at once, so a
process that needs several kernels pays for the slowest build only.

Nothing here runs at import time: the CPU tests import every module on a
host that has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .base import MXNetError

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: nvcc flags: Hopper with the arch-specific features (``sm_90a``), no
#: ``--use_fast_math`` (kernels rely on IEEE division and rounding), and
#: ptxas's register/shared-memory report in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: name -> nvcc's output (ptxas report) of the build this process ran
BUILD_LOG = {}

_LIBS = {}
_LOCK = threading.Lock()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise MXNetError("no nvcc found (set CUDA_HOME): the port's CUDA "
                     "kernels are built from csrc/ at first use")


def _target(name):
    src = os.path.join(_CSRC, name + ".cu")
    if not os.path.exists(src):
        raise MXNetError("no kernel source %s" % src)
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, "lib%s-%s.so"
                             % (name, h.hexdigest()[:16]))


def build(names):
    """Compile every named kernel whose library is missing, in parallel.
    Returns ``{name: library path}``; raises with nvcc's output on a
    failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        src, lib = _target(name)
        out[name] = lib
        if os.path.exists(lib):
            continue
        # compile to a private name, then rename: a concurrent process
        # never loads a half-written library
        tmp = "%s.tmp%d" % (lib, os.getpid())
        procs[name] = (tmp, lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (tmp, lib, p) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[name] = log
        if p.returncode != 0:
            raise MXNetError("nvcc failed building %s (exit %d):\n%s"
                             % (name, p.returncode, log))
        os.replace(tmp, lib)
    return out


def load(name):
    """The ``ctypes.CDLL`` of kernel ``name``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _LIBS[name] = lib
        return lib
