"""JPEG decode on the card: nvJPEG behind ``csrc/jpeg_decode.cu``.

The card route of :class:`~mxnet_tpu_torch.image.ImageRecordIter` decodes
a batch's JPEGs here at full size into one uint8 buffer (interleaved RGB,
HWC, the images one after another) and hands it to
:func:`~mxnet_tpu_torch.ops.image_augment.image_augment`. It is the
counterpart of the host route's libjpeg call
(``src/io/image_decode.cc:53-88``); the JPEG decode itself is nvJPEG, not
a kernel of this repository.

- **Loading.** ``libnvjpeg`` is found at first use (:func:`find_library`:
  ``$CUDA_HOME``'s and ``/usr/local/cuda``'s library directories, the
  ``nvidia`` wheels beside torch, then the loader's path) and opened by the
  C side with ``dlopen``; the C side is built by :mod:`cuda_build` like the
  kernels. No library, or handles that will not initialise, raise
  :class:`MXNetError` naming what was searched and ``device="cpu"``: there
  is no Pillow or host fallback on a CUDA device.
- **Routes**, per image, from its header alone (:meth:`Decoder.info`):
  ``"hardware"`` (the card's JPEG engines, one batched call) where nvJPEG's
  hardware backend takes the image, else ``"hybrid"`` (nvJPEG's default
  backend, one call an image).
- **Threads and streams.** A :class:`Decoder` holds nvJPEG states and a
  CUDA stream of its own; :func:`acquire` hands one to the calling thread
  for one batch and :func:`release` takes it back, so every decode worker
  works on its own state and stream and the process keeps as many decoders
  as it ran batches at once.
- :data:`LAUNCHES_BY_ROUTE` counts the decode calls by route (one batched
  hardware call, one hybrid call an image) and :data:`IMAGES_BY_ROUTE` the
  images, under a lock; :func:`reset_launches` sets both to 0.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading

import numpy as np
import torch

from .base import MXNetError

#: decode calls by route
LAUNCHES_BY_ROUTE = {"hardware": 0, "hybrid": 0}
#: images decoded by route
IMAGES_BY_ROUTE = {"hardware": 0, "hybrid": 0}
ROUTES = ("hardware", "hybrid")

_COUNT_LOCK = threading.Lock()
_LOCK = threading.Lock()
_FREE = []
_FN = None
_LIBPATH = None

#: each image's offset in the decode buffer is a multiple of this
ALIGN = 256


def _search_dirs():
    dirs = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home:
            dirs += [os.path.join(home, "lib64"), os.path.join(home, "lib"),
                     os.path.join(home, "targets", "x86_64-linux", "lib")]
    dirs += ["/usr/local/cuda/lib64",
             "/usr/local/cuda/targets/x86_64-linux/lib"]
    tdir = os.path.dirname(os.path.abspath(torch.__file__))
    dirs.append(os.path.join(os.path.dirname(tdir), "nvidia", "nvjpeg",
                             "lib"))
    dirs.append(os.path.join(tdir, "lib"))
    return dirs


def find_library():
    """``(path or None, what was searched)``: the first ``libnvjpeg.so*``
    in :func:`_search_dirs`, else the loader's own ``libnvjpeg.so.12`` or
    ``libnvjpeg.so`` where ``ctypes`` can open one."""
    dirs = _search_dirs()
    for d in dirs:
        hits = sorted(glob.glob(os.path.join(d, "libnvjpeg.so*")))
        if hits:
            return hits[0], dirs
    for name in ("libnvjpeg.so.12", "libnvjpeg.so"):
        try:
            ctypes.CDLL(name)
            return name, dirs
        except OSError:
            pass
    return None, dirs + ["the loader's path (libnvjpeg.so.12, libnvjpeg.so)"]


def find_header():
    """The path of ``nvjpeg.h`` under the CUDA toolkit, or None."""
    homes = [os.environ.get(v) for v in ("CUDA_HOME", "CUDA_PATH")]
    for home in [h for h in homes if h] + ["/usr/local/cuda"]:
        for sub in ("include", os.path.join("targets", "x86_64-linux",
                                            "include")):
            p = os.path.join(home, sub, "nvjpeg.h")
            if os.path.exists(p):
                return p
    return None


def _lib():
    global _FN, _LIBPATH
    with _LOCK:
        if _FN is None:
            path, searched = find_library()
            if path is None:
                raise MXNetError(
                    "ImageRecordIter decodes on the card with nvJPEG, and no "
                    "libnvjpeg was found (searched %s); pass device='cpu' "
                    "to decode on the host with libjpeg"
                    % ", ".join(searched))
            from . import cuda_build
            lib = cuda_build.load("jpeg_decode")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            lib.jpeg_decoder_create.argtypes = [ctypes.c_char_p, ci,
                                                ctypes.c_char_p, ci]
            lib.jpeg_decoder_create.restype = vp
            lib.jpeg_hardware_status.argtypes = [
                ctypes.POINTER(ctypes.c_uint)] * 2
            lib.jpeg_hardware_status.restype = ci
            bp = ctypes.POINTER(ctypes.c_char_p)
            sp = ctypes.POINTER(ctypes.c_size_t)
            lib.jpeg_info.argtypes = [vp, bp, sp, ci, ip, ip, ip, ip]
            lib.jpeg_info.restype = ci
            lib.jpeg_decode.argtypes = [vp, bp, sp, ci, ip,
                                        ctypes.POINTER(vp), sp, vp, ip, ip]
            lib.jpeg_decode.restype = ci
            _FN, _LIBPATH = lib, path
        return _FN


def _ints(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


class Decoder(object):
    """nvJPEG states and a CUDA stream on one device, for one thread at a
    time (:func:`acquire`)."""

    def __init__(self, device):
        self.device = torch.device(device)
        lib = _lib()
        err = ctypes.create_string_buffer(512)
        self._h = lib.jpeg_decoder_create(_LIBPATH.encode(),
                                          self.device.index, err, 512)
        if not self._h:
            raise MXNetError(
                "nvJPEG did not initialise on %s (library %s): %s; pass "
                "device='cpu' to decode on the host with libjpeg"
                % (self.device, _LIBPATH, err.value.decode()))
        self._lib = lib
        self.stream = torch.cuda.Stream(device=self.device)

    def finish(self):
        """Wait for the work queued on :attr:`stream`."""
        self.stream.synchronize()

    @staticmethod
    def _bufs(bufs):
        n = len(bufs)
        ptrs = (ctypes.c_char_p * n)(*bufs)
        lens = (ctypes.c_size_t * n)(*[len(b) for b in bufs])
        return ptrs, lens

    def info(self, bufs):
        """Per image, from its header: ``(widths, heights, routes, status)``
        int32 arrays; route 0 is ``"hardware"``, 1 ``"hybrid"``; status 0,
        or nvJPEG's status where it rejects the header."""
        n = len(bufs)
        w, h, r, s = (np.zeros(n, np.int32) for _ in range(4))
        ptrs, lens = self._bufs(bufs)
        self._lib.jpeg_info(self._h, ptrs, lens, n, _ints(w), _ints(h),
                            _ints(r), _ints(s))
        return w, h, r, s

    def decode(self, bufs, widths, heights, routes):
        """Decode ``bufs`` on :attr:`stream` into one uint8 buffer made
        there: ``(pixels, offsets, status)``, image ``i`` at
        ``offsets[i]`` with row pitch ``3 * widths[i]`` (the alignment
        gaps between images are not written); status 0, or
        nvJPEG's status for an image it failed. Counts the calls and images
        by route. The caller waits with :meth:`finish`."""
        n = len(bufs)
        sizes = 3 * widths.astype(np.int64) * heights.astype(np.int64)
        padded = (sizes + ALIGN - 1) // ALIGN * ALIGN
        offsets = np.zeros(n, np.int64)
        if n:
            offsets[1:] = np.cumsum(padded)[:-1]
        total = int(padded.sum()) if n else 0
        with torch.cuda.stream(self.stream):
            pixels = torch.empty(max(total, 1), dtype=torch.uint8,
                                 device=self.device)
        base = pixels.data_ptr()
        dst = (ctypes.c_void_p * n)(*[base + int(o) for o in offsets])
        pitch = (ctypes.c_size_t * n)(*[3 * int(w) for w in widths])
        ptrs, lens = self._bufs(bufs)
        route = np.ascontiguousarray(routes, np.int32)
        status = np.zeros(n, np.int32)
        calls = np.zeros(2, np.int32)
        self._lib.jpeg_decode(self._h, ptrs, lens, n, _ints(route), dst,
                              pitch, ctypes.c_void_p(self.stream.cuda_stream),
                              _ints(status), _ints(calls))
        with _COUNT_LOCK:
            for k, name in enumerate(ROUTES):
                LAUNCHES_BY_ROUTE[name] += int(calls[k])
                IMAGES_BY_ROUTE[name] += int(np.sum(route == k))
        return pixels, offsets, status


def acquire(device):
    """A :class:`Decoder` on ``device`` for the calling thread's next
    batch: a free one, else a new one."""
    device = torch.device(device)
    with _LOCK:
        for i, d in enumerate(_FREE):
            if d.device == device:
                return _FREE.pop(i)
    return Decoder(device)


def release(decoder):
    """Give ``decoder`` back for another batch."""
    with _LOCK:
        _FREE.append(decoder)


def hardware_status():
    """``{"status": nvjpegCreateEx's status for the hardware backend (0:
    it initialised; -1: not tried yet), "engines": n, "cores": n}``, from
    the decoders made so far in this process."""
    lib = _lib()
    eng, cores = ctypes.c_uint(), ctypes.c_uint()
    st = lib.jpeg_hardware_status(ctypes.byref(eng), ctypes.byref(cores))
    return {"status": int(st), "engines": int(eng.value),
            "cores": int(cores.value)}


def reset_launches():
    """Set :data:`LAUNCHES_BY_ROUTE` and :data:`IMAGES_BY_ROUTE` to 0."""
    with _COUNT_LOCK:
        for name in ROUTES:
            LAUNCHES_BY_ROUTE[name] = 0
            IMAGES_BY_ROUTE[name] = 0
