"""Reference-compatible binary NDArray serialization (the ``.params`` format).

The port's own copy of ``mxnet_tpu/dmlc_serial.py``, numpy only. Byte
layout (ref: src/ndarray/ndarray.cc:605-693, include/mxnet/ndarray.h:360-373;
dmlc::Stream vector/string framing):

    uint64  magic = 0x112 (kMXAPINDArrayListMagic)
    uint64  reserved = 0
    uint64  ndarray count
    per NDArray:
        uint32  ndim, uint32 dims[ndim]      (mshadow TShape::Save)
        int32   dev_type, int32 dev_id       (Context::Save)
        int32   type_flag                    (mshadow type flags)
        raw little-endian tensor bytes
    uint64  name count (0 when saved as a bare list)
    per name: uint64 length, utf-8 bytes

mshadow type flags: 0=float32 1=float64 2=float16 3=uint8 4=int32, and the
extension flags >= 100 the JAX package writes (100 bfloat16, 101 int64,
102 uint64, 103 int8, 104 bool). numpy has no bfloat16, so bfloat16 arrays
travel as :data:`BF16`, a one-field uint16 record holding the raw bits.
"""
from __future__ import annotations

import io
import struct

import numpy as np

from .base import MXNetError

MAGIC = 0x112

#: raw bfloat16 bits as a numpy dtype (2 bytes an element)
BF16 = np.dtype([("bfloat16", "<u2")])

_FLAG2DTYPE = {
    0: np.dtype(np.float32),
    1: np.dtype(np.float64),
    2: np.dtype(np.float16),
    3: np.dtype(np.uint8),
    4: np.dtype(np.int32),
    100: BF16,
    101: np.dtype(np.int64),
    102: np.dtype(np.uint64),
    103: np.dtype(np.int8),
    104: np.dtype(np.bool_),
}
_DTYPE2FLAG = {v: k for k, v in _FLAG2DTYPE.items()}


def is_bf16(dt):
    # BF16 here, or a bfloat16 extension dtype of another numpy user
    return dt == BF16 or dt.name == "bfloat16"


def _dtype_flag(dt):
    dt = np.dtype(dt)
    if is_bf16(dt):
        return 100
    if dt in _DTYPE2FLAG:
        return _DTYPE2FLAG[dt]
    raise MXNetError("save: dtype %s has no .params type flag" % dt)


def dump(fo, arrays, names):
    """Stream numpy arrays (+ optional names) to a file object in the
    reference .params layout, one write per tensor."""
    fo.write(struct.pack("<QQ", MAGIC, 0))
    fo.write(struct.pack("<Q", len(arrays)))
    for arr in arrays:
        arr = np.ascontiguousarray(arr)
        flag = _dtype_flag(arr.dtype)
        fo.write(struct.pack("<I", arr.ndim))
        fo.write(struct.pack("<%dI" % arr.ndim, *arr.shape))
        fo.write(struct.pack("<ii", 1, 0))          # Context: kCPU, dev 0
        fo.write(struct.pack("<i", flag))
        if flag == 100:
            arr = arr.view(np.uint16)
        fo.write(arr.tobytes())
    fo.write(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode("utf-8")
        fo.write(struct.pack("<Q", len(b)))
        fo.write(b)


def dumps(arrays, names):
    """Serialize to bytes."""
    buf = io.BytesIO()
    dump(buf, arrays, names)
    return buf.getvalue()


class _Reader(object):
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise MXNetError("Invalid NDArray file format (truncated)")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]


def loads(buf):
    """Parse reference .params bytes -> (list of np arrays, list of names)."""
    r = _Reader(buf)
    if r.u64() != MAGIC:
        raise MXNetError("Invalid NDArray file format (bad magic)")
    r.u64()                                          # reserved
    arrays = []
    for _ in range(r.u64()):
        ndim = r.u32()
        if ndim == 0:                                # is_none() NDArray
            arrays.append(np.zeros((), np.float32))
            continue
        shape = struct.unpack("<%dI" % ndim, r.take(4 * ndim))
        r.i32(); r.i32()                             # Context (ignored: host load)
        flag = r.i32()
        if flag not in _FLAG2DTYPE:
            raise MXNetError("load: unknown type flag %d" % flag)
        dt = _FLAG2DTYPE[flag]
        n = int(np.prod(shape)) if shape else 1
        raw = r.take(n * dt.itemsize)
        arrays.append(np.frombuffer(raw, dt).reshape(shape).copy())
    names = []
    nname = r.u64()
    if nname not in (0, len(arrays)):
        raise MXNetError("Invalid NDArray file format (name count)")
    for _ in range(nname):
        names.append(r.take(r.u64()).decode("utf-8"))
    return arrays, names


def sniff(buf):
    """True when buf starts with the reference list magic."""
    return len(buf) >= 8 and struct.unpack("<Q", buf[:8])[0] == MAGIC
