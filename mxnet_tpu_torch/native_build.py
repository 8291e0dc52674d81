"""Build and load the data tier's native host library.

The RecordIO reader (``src/io/recordio_reader.cc``) and the fused JPEG
decode/augment stage (``src/io/image_decode.cc``) are plain C++ with a C
interface that ``ctypes`` loads. The JAX package builds them into
``lib/libmxtpu_io.so`` with ``make -C src``; the port compiles the same
two sources with ``g++`` and the Makefile's flags, linking libjpeg, into
``_build/`` beside this file under a name that is a digest of the sources
and the flags (a changed source builds anew), as :mod:`cuda_build` names
the kernels' libraries.

The build runs at first use, never at import. A failed build raises
:class:`MXNetError` carrying the compiler's output, and every later call in
the process raises the same error.
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
SRC_DIR = os.path.join(os.path.dirname(_PKG), "src", "io")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("recordio_reader.cc", "image_decode.cc")
#: ``src/Makefile``'s flags
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
LIBS = ("-ljpeg",)

_LIB = None
_ERROR = None
_LOCK = threading.Lock()


def _cxx():
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise MXNetError("no C++ compiler found (g++ or $CXX): the data "
                         "tier's native library is built from src/io/ at "
                         "first use")
    return cxx


def _target():
    """(source paths, library path) of the native library."""
    srcs = [os.path.join(SRC_DIR, s) for s in SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        if not os.path.exists(s):
            raise MXNetError("no native source %s" % s)
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXXFLAGS + LIBS).encode())
    return srcs, os.path.join(BUILD_DIR,
                              "libmxtpu_io-%s.so" % h.hexdigest()[:16])


def build():
    """Compile the library if it is missing; returns its path. Raises
    :class:`MXNetError` with the compiler's output on a failed build."""
    srcs, lib = _target()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = "%s.tmp%d" % (lib, os.getpid())
    cmd = [_cxx(), *CXXFLAGS, "-o", tmp, *srcs, *LIBS]
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise MXNetError("g++ failed building the native IO library "
                         "(exit %d): %s\n%s"
                         % (p.returncode, " ".join(cmd), p.stdout))
    os.replace(tmp, lib)
    return lib


def probe():
    """What this host offers the native build, found without building it:
    ``{"pillow": version or None, "jpeglib_h": the C++ preprocessor finds
    <jpeglib.h>, "libjpeg": libjpeg's lines of ``ldconfig -p``, "cxx": the
    compiler's first ``--version`` line or None, "cpu_count": n}``;
    ``"native"`` is True where both libjpeg's header and library are
    present (the build needs both)."""
    out = {"pillow": None, "jpeglib_h": False, "libjpeg": [], "cxx": None,
           "cpu_count": os.cpu_count()}
    try:
        import PIL
        out["pillow"] = PIL.__version__
    except ImportError:
        pass
    try:
        cxx = _cxx()
        v = subprocess.run([cxx, "--version"], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        out["cxx"] = v.stdout.splitlines()[0] if v.stdout else cxx
        pre = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                             input="#include <jpeglib.h>\n", text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        out["jpeglib_h"] = pre.returncode == 0
    except (MXNetError, OSError):
        pass
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        ld = subprocess.run([ldconfig, "-p"], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
        out["libjpeg"] = [ln.strip() for ln in ld.stdout.splitlines()
                          if "libjpeg.so" in ln]
    except OSError:
        pass
    out["native"] = bool(out["jpeglib_h"] and out["libjpeg"])
    return out


def _declare(lib):
    lib.mxtpu_rio_open.restype = ctypes.c_void_p
    lib.mxtpu_rio_open.argtypes = [ctypes.c_char_p]
    lib.mxtpu_rio_next.restype = ctypes.POINTER(ctypes.c_char)
    lib.mxtpu_rio_next.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint64)]
    lib.mxtpu_rio_rewind.argtypes = [ctypes.c_void_p]
    lib.mxtpu_rio_close.argtypes = [ctypes.c_void_p]
    lib.mxtpu_rio_build_index.restype = ctypes.c_int64
    lib.mxtpu_rio_build_index.argtypes = [ctypes.c_void_p]
    lib.mxtpu_rio_read_at.restype = ctypes.POINTER(ctypes.c_char)
    lib.mxtpu_rio_read_at.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_uint64)]
    lib.mxtpu_rio_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mxtpu_rio_prefetch_next.restype = ctypes.c_int64
    lib.mxtpu_rio_prefetch_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_uint64]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mxtpu_img_decode_batch.restype = ctypes.c_int
    lib.mxtpu_img_decode_batch.argtypes = [
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, f32p, f32p, f32p, ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int]
    lib.mxtpu_img_decode_one.restype = ctypes.c_int
    lib.mxtpu_img_decode_one.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_int, u8p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    return lib


def load():
    """The ``ctypes.CDLL`` of the native library, built at first use."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _ERROR is not None:
            raise MXNetError(_ERROR)
        try:
            _LIB = _declare(ctypes.CDLL(build()))
        except (MXNetError, OSError, AttributeError) as e:
            _ERROR = str(e)
            raise MXNetError(_ERROR) from e
        return _LIB
