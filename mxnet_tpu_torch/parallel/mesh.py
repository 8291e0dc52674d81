"""The mesh of replicas and its helpers.

Counterpart of ``mxnet_tpu/parallel/mesh.py``. The JAX package builds a
``jax.sharding.Mesh`` over devices and lets GSPMD place the collectives;
the port is single-controller too, but explicit: a :class:`Mesh` names
axes over a grid of ``torch.device``s, one replica per position, and
replicas may share a physical device (two replicas on ``cuda:0``, eight
on the host CPU). A logical array over the mesh is a :class:`MeshArray`:
one tensor per replica, split along its batch ``axis`` or whole on every
replica. Cross-replica sums (:func:`all_reduce`) and gathers
(:func:`all_gather`) are ``.to(device)`` copies and sums, one code path
whether two replicas share a card or not, and differentiable, so autograd
carries the gradient reductions.

Only the 'data' axis is ported. The model, seq and pipe axes
(``model_parallel_mesh``, ``parse_mesh_axes``, ``mesh_from_spec``,
``shard_map_compat``, ``axis_size``) raise, citing ROADMAP.md A.7b;
``global_data_mesh``, ``host_to_global``, ``host_broadcast0`` and
``local_view`` wait for multi-process training (A.11b), and
``is_multiprocess`` is always False.
"""
from __future__ import annotations

import collections
import os
import threading

import numpy as np
import torch

from ..base import MXNetError

_scope = threading.local()

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_PIPE = "pipe"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"

#: every axis name a multi-axis training mesh may carry, in canonical order
AXIS_NAMES = (AXIS_DATA, AXIS_MODEL, AXIS_PIPE, AXIS_SEQ, AXIS_EXPERT)

#: cross-replica collectives run since the last :func:`reset_counters`:
#: ``all_reduce`` (sums: BatchNorm statistics, gradients, metric sums),
#: ``all_gather`` (an op run on the whole batch, see ``executor``) and
#: ``broadcast`` (a value copied to every replica)
COUNTERS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
_COUNT_LOCK = threading.Lock()


def _count(kind):
    with _COUNT_LOCK:
        COUNTERS[kind] += 1


def reset_counters():
    with _COUNT_LOCK:
        for k in COUNTERS:
            COUNTERS[k] = 0


def _not_ported(what, item):
    raise MXNetError("%s is not ported yet (ROADMAP.md %s)" % (what, item))


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one mesh axis
    name (or None) per array dimension."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


class Mesh(object):
    """Named axes over a grid of ``torch.device``s, one replica per
    position (ref: ``jax.sharding.Mesh``). Positions may name the same
    device."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = arr.reshape(-1)
        for i, d in enumerate(np.asarray(devices, dtype=object).reshape(-1)):
            flat[i] = torch.device(d)
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim:
            raise MXNetError("Mesh: %d axis names for a %d-dimensional "
                             "device grid" % (len(self.axis_names), arr.ndim))

    @property
    def shape(self):
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    def replica_devices(self):
        """The device of each replica, in mesh order."""
        return list(self.devices.flat)

    def __repr__(self):
        return "Mesh(%s, %s)" % (dict(self.shape), self.replica_devices())


class NamedSharding(object):
    """A mesh and a partition spec (ref: ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)


def devices():
    """The devices a mesh is built over by default: every visible CUDA
    device, else the host CPU once per core (CPU replicas share the host
    device, as the JAX package's virtual CPU devices share the host)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * (os.cpu_count() or 1)


def make_mesh(axis_shapes, devices=None):
    """A Mesh from ``{'data': 4, ...}`` over the first ``prod(sizes)`` of
    ``devices`` (default :func:`devices`); axis order follows insertion
    order. Asking for more devices than given raises."""
    if devices is None:
        devices = globals()["devices"]()
    devices = list(devices)
    names = tuple(axis_shapes.keys())
    for name in names:
        if name not in AXIS_NAMES:
            raise MXNetError("make_mesh: unknown axis %r (valid: %s)"
                             % (name, ", ".join(AXIS_NAMES)))
    shape = tuple(int(axis_shapes[n]) for n in names)
    n = int(np.prod(shape))
    if n > len(devices):
        raise MXNetError("mesh needs %d devices, have %d"
                         % (n, len(devices)))
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(shape), names)


def data_parallel_mesh(num=None, devices=None):
    """A one-axis 'data' mesh over ``num`` of ``devices`` (all by
    default)."""
    if devices is None:
        devices = globals()["devices"]()
    devices = list(devices)
    if num is not None:
        if num > len(devices):
            raise MXNetError("data_parallel_mesh: %d devices requested, %d "
                             "visible" % (num, len(devices)))
        devices = devices[:num]
    return make_mesh({AXIS_DATA: len(devices)}, devices)


def model_parallel_mesh(num=None, devices=None):
    _not_ported("model_parallel_mesh (the 'model' axis)", "A.7b")


def parse_mesh_axes(spec):
    _not_ported("parse_mesh_axes (multi-axis meshes)", "A.7b")


def mesh_from_spec(spec, devices=None):
    _not_ported("mesh_from_spec (multi-axis meshes)", "A.7b")


def shard_map_compat(f, mesh=None, in_specs=None, out_specs=None,
                     check_vma=None, **kw):
    _not_ported("shard_map_compat (the seq and pipe axes)", "A.7b")


def axis_size(axis_name):
    _not_ported("axis_size (the seq and pipe axes)", "A.7b")


def check_data_only(mesh, who):
    """Raise unless every axis of ``mesh`` but 'data' has size 1: only the
    'data' axis is ported."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise MXNetError("%s: mesh=%r is not a parallel.mesh.Mesh"
                         % (who, mesh))
    other = [a for a, n in mesh.shape.items() if a != AXIS_DATA and n > 1]
    if other:
        raise MXNetError("%s: the %s mesh axes (model, seq and pipe "
                         "parallelism) are not ported yet (ROADMAP.md A.7b)"
                         % (who, "/".join(repr(a) for a in other)))


def check_axis_divides(mesh, axis, value, what):
    """Divisibility precheck for one mesh axis: ``value`` (the dimension
    the axis will shard) must divide evenly over the axis. Raises
    :class:`MXNetError` naming the failing axis and the dimension; a no-op
    when the mesh lacks the axis."""
    n = data_axis_size(mesh, axis)
    if n > 1 and int(value) % n:
        raise MXNetError(
            "%s %d does not divide the %d-way %r mesh axis — every shard "
            "must be equal (pad %s or pick a size divisible by %d)"
            % (what, int(value), n, axis, what, n))


class MeshScope(object):
    """``with MeshScope(mesh):`` sets the ambient mesh."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._old = getattr(_scope, "mesh", None)
        _scope.mesh = self.mesh
        return self.mesh

    def __exit__(self, *a):
        _scope.mesh = self._old


def current_mesh():
    return getattr(_scope, "mesh", None)


def data_axis_size(mesh, axis=AXIS_DATA):
    """Number of shards along the mesh's data axis (1 when absent)."""
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return int(mesh.shape[axis])


def superbatch_sharding(mesh, axis=AXIS_DATA, seq=False):
    """The sharding of stacked ``(k, batch, ...)`` superbatches: the step
    axis whole, the batch axis split along ``axis``. ``SuperBatchIter``
    lands its copies with it, so each replica receives only its shard.
    ``seq=True`` over a mesh with a 'seq' axis raises (A.7b)."""
    if mesh is None:
        return None
    if seq and AXIS_SEQ in mesh.axis_names:
        _not_ported("superbatch_sharding(seq=True) (the 'seq' axis)", "A.7b")
    if axis not in mesh.axis_names:
        return None
    return NamedSharding(mesh, P(None, axis))


def is_multiprocess(mesh):
    """Always False: the port's meshes live in one process."""
    return False


def global_data_mesh(axis_name=AXIS_DATA, local_devices=None):
    _not_ported("global_data_mesh (multi-process data parallelism)", "A.11b")


def host_to_global(mesh, spec, local_value):
    _not_ported("host_to_global (multi-process data parallelism)", "A.11b")


def host_broadcast0(mesh, value):
    _not_ported("host_broadcast0 (multi-process data parallelism)", "A.11b")


def local_view(arr):
    _not_ported("local_view (multi-process data parallelism)", "A.11b")


# ---------------------------------------------------------------------------
# arrays over a mesh and the collectives between replicas
# ---------------------------------------------------------------------------

class MeshArray(object):
    """One logical array over a mesh's replicas: ``parts[r]`` is replica
    ``r``'s tensor, on its device. With ``axis`` an int the array is split
    along that axis in replica order (each part a shard); with ``axis``
    None every part holds the whole array (replicated)."""

    __slots__ = ("mesh", "parts", "axis")

    def __init__(self, mesh, parts, axis):
        self.mesh = mesh
        self.parts = list(parts)
        self.axis = axis

    @property
    def shape(self):
        s = list(self.parts[0].shape)
        if self.axis is not None:
            s[self.axis] *= len(self.parts)
        return tuple(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def ndim(self):
        return self.parts[0].dim()

    @property
    def sharding(self):
        spec = []
        if self.axis is not None:
            spec = [None] * self.axis + [AXIS_DATA]
        return NamedSharding(self.mesh, P(*spec))

    def gather(self, device=None):
        """The whole array on ``device`` (replica 0's by default)."""
        device = self.parts[0].device if device is None else device
        if self.axis is None:
            return self.parts[0].to(device)
        return torch.cat([p.to(device) for p in self.parts], self.axis)


def batch_axis(shape, batch_size, axis=None):
    """The axis of ``shape`` that carries the batch: ``axis`` (the 'N' of
    the input's layout) where it has the batch's size, else dim 0 where it
    has, else the first that has (an RNN's begin state ``(layers, batch,
    hidden)`` in the default layout); None for an array without one (it is
    replicated)."""
    if axis is not None and axis < len(shape) and shape[axis] == batch_size:
        return axis
    if len(shape) and shape[0] == batch_size:
        return 0
    for i, d in enumerate(shape):
        if d == batch_size:
            return i
    return None


def layout_axes(descs):
    """``{name: axis}`` of data descriptors: the 'N' of each ``DataDesc``'s
    layout (``"TN"`` gives 1); None for a ``(name, shape)`` pair or a
    layout without 'N'."""
    out = {}
    for d in descs or ():
        if hasattr(d, "name"):
            layout = getattr(d, "layout", None)
            ax = 0 if layout is None else layout.find("N")
            out[d.name] = ax if ax >= 0 else None
        else:
            out[d[0]] = None
    return out


def batch_axes(shapes, axes=None):
    """``(batch size, {name: batch axis})`` of the batch inputs ``shapes``
    (ordered name -> shape): the first input's size along its axis (from
    ``axes``, :func:`layout_axes`; dim 0 where none is given) is the batch
    size, and each input's axis is :func:`batch_axis` of it."""
    axes = axes or {}
    if not shapes:
        return None, {}
    first = next(iter(shapes))
    a0 = axes.get(first)
    bs = tuple(shapes[first])[0 if a0 is None else a0]
    return bs, {n: batch_axis(tuple(s), bs, axes.get(n))
                for n, s in shapes.items()}


def shard_shape(shape, mesh, axis):
    """One replica's shape of a ``shape`` whose batch ``axis`` (None: no
    batch axis) the 'data' axis of ``mesh`` splits: what a per-replica
    computation, such as a metric's device sums, sees."""
    n = data_axis_size(mesh)
    if axis is None or n == 1:
        return tuple(shape)
    return tuple(d // n if i == axis else d for i, d in enumerate(shape))


def split(t, mesh, axis):
    """``t`` split along ``axis`` into a :class:`MeshArray`, each shard
    copied to its replica's device (a view where it is already there)."""
    devs = mesh.replica_devices()
    n = len(devs)
    size = t.shape[axis]
    if size % n:
        raise MXNetError("split: dimension %d of size %d does not divide "
                         "the %d-way 'data' mesh axis" % (axis, size, n))
    step = size // n
    return MeshArray(mesh, [t.narrow(axis, r * step, step).to(d)
                            for r, d in enumerate(devs)], axis)


def replicate(tree, mesh):
    """A tensor, or a dict of them, as replicated :class:`MeshArray`s:
    replica 0's part the tensor on its device, every other replica's a
    copy of its own."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    _count("broadcast")
    return MeshArray(mesh, [tree.to(d, copy=r > 0)
                            for r, d in enumerate(mesh.replica_devices())],
                     None)


def shard_batch(tree, mesh, axis=AXIS_DATA):
    """A tensor, or a dict of them, with dim 0 split along the mesh's
    ``axis`` (ref: the JAX package's ``shard_batch``)."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in tree.items()}
    if tree.dim() == 0:
        return replicate(tree, mesh)
    return split(tree, mesh, 0)


def all_reduce(parts, devices):
    """The sum of ``parts`` (one tensor per replica), summed in replica
    order and placed on each replica's device: bitwise the same on every
    replica. Replicas on one device share the one sum. Differentiable."""
    _count("all_reduce")
    out, done = [], {}
    for d in devices:
        if d not in done:
            acc = parts[0].to(d)
            for p in parts[1:]:
                acc = acc + p.to(d)
            done[d] = acc
        out.append(done[d])
    return out


def all_gather(parts, axis, devices):
    """The shards ``parts`` concatenated along ``axis`` on each replica's
    device (shared where replicas share a device). Differentiable."""
    _count("all_gather")
    out, done = [], {}
    for d in devices:
        if d not in done:
            done[d] = torch.cat([p.to(d) for p in parts], axis)
        out.append(done[d])
    return out


def grad_sync(grads, axis_name=AXIS_DATA):
    """Explicit gradient all-reduce: every :class:`MeshArray` of ``grads``
    (a dict) becomes the replicated sum of its parts."""
    out = {}
    for k, g in grads.items():
        devs = g.mesh.replica_devices()
        out[k] = MeshArray(g.mesh, all_reduce(g.parts, devs), None)
    return out
