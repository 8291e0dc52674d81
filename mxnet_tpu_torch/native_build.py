"""Build and load the data tier's native host libraries.

The RecordIO reader (``src/io/recordio_reader.cc``) and the fused JPEG
decode/augment stage (``src/io/image_decode.cc``) are plain C++ with a C
interface that ``ctypes`` loads. The JAX package builds both into
``lib/libmxtpu_io.so`` with ``make -C src``; the port compiles the same
sources with ``g++`` and the Makefile's flags into two libraries
(:data:`LIBRARIES`) under ``_build/`` beside this file, each named by a
digest of its sources and flags (a changed source builds anew), as
:mod:`cuda_build` names the kernels' libraries:

- ``"reader"``: ``recordio_reader.cc`` alone, with no ``-ljpeg``. It builds
  wherever a C++ compiler does, the card machine included (which has no
  libjpeg); :class:`~mxnet_tpu_torch.recordio.NativeRecordIOReader` loads
  only it.
- ``"decoder"``: ``image_decode.cc``, linked with ``-ljpeg``. The host
  route of :class:`~mxnet_tpu_torch.image.ImageRecordIter`
  (``device="cpu"``) and :func:`~mxnet_tpu_torch.image.imdecode` load it;
  the card route decodes with nvJPEG instead
  (:mod:`~mxnet_tpu_torch.jpeg_decode`).

A build runs at first use of its library, never at import. A failed build
raises :class:`MXNetError` carrying the compiler's output, and every later
call for that library in the process raises the same error.
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
#: library name -> (sources, libraries it links)
LIBRARIES = {"reader": (("recordio_reader.cc",), ()),
             "decoder": (("image_decode.cc",), ("-ljpeg",))}
#: every source of the two libraries
SOURCES = ("recordio_reader.cc", "image_decode.cc")
#: ``src/Makefile``'s flags
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

#: library name -> its ``ctypes.CDLL``, and -> the error of a failed build
_LIB = {}
_ERROR = {}
_LOCK = threading.Lock()


def _cxx():
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise MXNetError("no C++ compiler found (g++ or $CXX): the data "
                         "tier's native library is built from src/io/ at "
                         "first use")
    return cxx


def _target(name):
    """(source paths, link flags, library path) of library ``name``."""
    if name not in LIBRARIES:
        raise MXNetError("no native library %r (one of %s)"
                         % (name, ", ".join(sorted(LIBRARIES))))
    sources, libs = LIBRARIES[name]
    srcs = [os.path.join(SRC_DIR, s) for s in sources]
    h = hashlib.sha256()
    for s in srcs:
        if not os.path.exists(s):
            raise MXNetError("no native source %s" % s)
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXXFLAGS + libs).encode())
    return srcs, libs, os.path.join(
        BUILD_DIR, "libmxtpu_io-%s-%s.so" % (name, h.hexdigest()[:16]))


def build(name="decoder"):
    """Compile library ``name`` if it is missing; returns its path. Raises
    :class:`MXNetError` with the compiler's output on a failed build."""
    srcs, libs, lib = _target(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = "%s.tmp%d" % (lib, os.getpid())
    cmd = [_cxx(), *CXXFLAGS, "-o", tmp, *srcs, *libs]
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise MXNetError("g++ failed building the native IO %s library "
                         "(exit %d): %s\n%s"
                         % (name, p.returncode, " ".join(cmd), p.stdout))
    os.replace(tmp, lib)
    return lib


def probe():
    """What this host offers the data tier, found without building
    anything: ``{"pillow": version or None, "jpeglib_h": the C++
    preprocessor finds <jpeglib.h>, "libjpeg": libjpeg's lines of
    ``ldconfig -p``, "cxx": the compiler's first ``--version`` line or
    None, "cpu_count": n}``; ``"native"`` is True where both libjpeg's
    header and library are present (the decoder library needs both).
    For the card route: ``"nvjpeg_h"`` (the path of the CUDA toolkit's
    ``nvjpeg.h`` or None) and ``"libnvjpeg"`` (the library
    :func:`~mxnet_tpu_torch.jpeg_decode.find_library` would open, or
    None)."""
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
    from . import jpeg_decode
    out["nvjpeg_h"] = jpeg_decode.find_header()
    out["libnvjpeg"] = jpeg_decode.find_library()[0]
    return out


def _declare_reader(lib):
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
    return lib


def _declare_decoder(lib):
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


_DECLARE = {"reader": _declare_reader, "decoder": _declare_decoder}


def load(name="decoder"):
    """The ``ctypes.CDLL`` of library ``name`` (``"reader"`` or
    ``"decoder"``), built at first use."""
    if name not in LIBRARIES:
        raise MXNetError("no native library %r (one of %s)"
                         % (name, ", ".join(sorted(LIBRARIES))))
    with _LOCK:
        lib = _LIB.get(name)
        if lib is not None:
            return lib
        if name in _ERROR:
            raise MXNetError(_ERROR[name])
        try:
            lib = _LIB[name] = _DECLARE[name](ctypes.CDLL(build(name)))
        except (MXNetError, OSError, AttributeError) as e:
            _ERROR[name] = str(e)
            raise MXNetError(_ERROR[name]) from e
        return lib
