"""RecordIO: the packed record format and its readers (ref:
python/mxnet/recordio.py; the format of dmlc-core's recordio and
src/io/image_recordio.h's IRHeader).

Counterpart of ``mxnet_tpu/recordio.py``: the dmlc framing (magic
0xced7230a, the length-or-marker word, 4-byte alignment) and the image
IRHeader (flag, label, id, id2), so a ``.rec``/``.idx`` pair written by
either package reads in the other. :class:`NativeRecordIOReader` rides the
native reader library (``src/io/recordio_reader.cc`` alone, no libjpeg)
that :mod:`native_build` compiles at first use; a failed build raises with
the compiler's output.
``pack_img``/``unpack_img`` encode and decode with Pillow, as the
reference does.
"""
from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from .base import MXNetError
from . import native_build


def _load_native():
    """The native reader library (built at first use; raises
    :class:`MXNetError` with the compiler's output when it cannot be
    built)."""
    return native_build.load("reader")


class NativeRecordIOReader(object):
    """Sequential/indexed reader backed by the C++ library, with optional
    background prefetching."""

    def __init__(self, uri, prefetch=False, queue_size=64):
        lib = _load_native()
        self._lib = lib
        self._h = lib.mxtpu_rio_open(uri.encode())
        if not self._h:
            raise MXNetError("cannot open %s" % uri)
        self._prefetch = prefetch
        self._cap = 1 << 20
        self._buf = ctypes.create_string_buffer(self._cap)
        if prefetch:
            lib.mxtpu_rio_prefetch_start(self._h, queue_size)

    def read(self):
        if self._h is None:
            raise MXNetError("reader closed")
        if self._prefetch:
            while True:
                n = self._lib.mxtpu_rio_prefetch_next(self._h, self._buf,
                                                      self._cap)
                if n == -1:  # record larger than buffer: grow and retry
                    self._cap *= 4
                    self._buf = ctypes.create_string_buffer(self._cap)
                    continue
                if n == -2:  # end of stream
                    return None
                return self._buf.raw[:n]
        ln = ctypes.c_uint64()
        ptr = self._lib.mxtpu_rio_next(self._h, ctypes.byref(ln))
        if not ptr or ln.value == 0:
            return None if not ptr else b""
        return ctypes.string_at(ptr, ln.value)

    def build_index(self):
        return int(self._lib.mxtpu_rio_build_index(self._h))

    def read_at(self, i):
        ln = ctypes.c_uint64()
        ptr = self._lib.mxtpu_rio_read_at(self._h, i, ctypes.byref(ln))
        if not ptr:
            return None
        return ctypes.string_at(ptr, ln.value)

    def reset(self):
        self._lib.mxtpu_rio_rewind(self._h)

    def close(self):
        if self._h is not None:
            self._lib.mxtpu_rio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

_MAGIC = 0xced7230a
_KMAGIC_STRUCT = struct.Struct("<I")
_LREC_STRUCT = struct.Struct("<I")

# IRHeader (ref: src/io/image_recordio.h:25-60)
IRHeader_FMT = "<IfQQ"
IRHeader_SIZE = struct.calcsize(IRHeader_FMT)


class IRHeader(object):
    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag=0, label=0.0, id=0, id2=0):
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(rec):
    return (rec >> 29) & 7, rec & ((1 << 29) - 1)


class MXRecordIO(object):
    """Sequential RecordIO reader/writer (ref: recordio.py MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        """Current byte offset. In write mode the buffered handle is
        flushed first so the returned offset is DURABLE — an index entry
        recorded from it (``write_idx``) stays exact even if a reader
        opens the file while the writer is still live (the sharded
        reader's thread-local handles depend on exact offsets)."""
        if self.writable:
            self.handle.flush()
        return self.handle.tell()

    def write(self, buf):
        assert self.writable
        self.handle.write(_KMAGIC_STRUCT.pack(_MAGIC))
        self.handle.write(_LREC_STRUCT.pack(_encode_lrec(0, len(buf))))
        self.handle.write(buf)
        pad = (4 - (len(buf) % 4)) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        offset = self.handle.tell()
        try:
            return self._read_at(offset)
        except Exception:
            # partial-read consistency: a failed read (truncated record,
            # bad magic) must not leave the handle mid-record — seek back
            # to the record start so tell() stays meaningful, a subsequent
            # seek()/read_idx() of a GOOD key works, and re-reading this
            # offset fails the same way instead of parsing garbage
            try:
                self.handle.seek(offset)
            except Exception:
                pass
            raise

    def _read_at(self, offset):
        head = self.handle.read(4)
        if len(head) < 4:
            if head:
                raise MXNetError(
                    "truncated RecordIO file %r: %d stray byte(s) at "
                    "offset %d" % (self.uri, len(head), offset))
            return None
        (magic,) = _KMAGIC_STRUCT.unpack(head)
        if magic != _MAGIC:
            raise MXNetError("invalid RecordIO magic at offset %d in %r"
                             % (offset, self.uri))
        lrec_buf = self.handle.read(4)
        if len(lrec_buf) < 4:
            raise MXNetError("truncated RecordIO file %r: record header "
                             "cut short at offset %d" % (self.uri, offset))
        (lrec,) = _LREC_STRUCT.unpack(lrec_buf)
        _cflag, length = _decode_lrec(lrec)
        buf = self.handle.read(length)
        if len(buf) < length:
            # a short payload silently poisons everything downstream
            # (unpack reads garbage labels); fail loudly instead
            raise MXNetError(
                "truncated record in %r at offset %d: expected %d payload "
                "bytes, got %d" % (self.uri, offset, length, len(buf)))
        pad = (4 - (length % 4)) % 4
        if pad:
            self.handle.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Indexed RecordIO with .idx sidecar (ref: recordio.py MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if self.writable and self.is_open:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        if idx not in self.idx:
            raise MXNetError("key %r not present in index %r (of %r)"
                             % (idx, self.idx_path, self.uri))
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.keys.append(key)
        self.idx[key] = pos


def pack(header, s):
    """Pack a string with IRHeader (ref: recordio.py pack). An array label
    (the detection format) is stored after the header with flag carrying
    its length, mirroring unpack()."""
    if not isinstance(header, IRHeader):
        header = IRHeader(*header)
    label = header.label
    if isinstance(label, (list, tuple, np.ndarray)):
        arr = np.asarray(label, dtype=np.float32).reshape(-1)
        buf = struct.pack(IRHeader_FMT, len(arr), 0.0, header.id,
                          header.id2)
        return buf + arr.tobytes() + s
    buf = struct.pack(IRHeader_FMT, header.flag, float(label), header.id,
                      header.id2)
    return buf + s


def unpack(s):
    """Unpack to (IRHeader, payload) (ref: recordio.py unpack)."""
    h = IRHeader(*struct.unpack(IRHeader_FMT, s[:IRHeader_SIZE]))
    payload = s[IRHeader_SIZE:]
    if h.flag > 0:
        # multi-label stored after the header (ref: recordio.py)
        label = np.frombuffer(payload[:h.flag * 4], dtype=np.float32)
        h2 = IRHeader(h.flag, label, h.id, h.id2)
        return h2, payload[h.flag * 4:]
    return h, payload


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """JPEG/PNG-encode and pack (ref: recordio.py pack_img). Uses PIL if
    available; raises otherwise (OpenCV is not used)."""
    try:
        from PIL import Image
        import io as _io
    except ImportError:
        raise MXNetError("pack_img requires Pillow")
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG" if img_fmt in (".jpg", ".jpeg")
                              else "PNG", quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """Unpack to (IRHeader, image ndarray) (ref: recordio.py unpack_img)."""
    h, img_bytes = unpack(s)
    try:
        from PIL import Image
        import io as _io
    except ImportError:
        raise MXNetError("unpack_img requires Pillow")
    img = np.asarray(Image.open(_io.BytesIO(img_bytes)))
    return h, img
