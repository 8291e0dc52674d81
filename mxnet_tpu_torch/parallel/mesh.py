"""The mesh of positions and its helpers.

Counterpart of ``mxnet_tpu/parallel/mesh.py``. The JAX package builds a
``jax.sharding.Mesh`` over devices and lets GSPMD place the collectives;
the port is single-controller too, but explicit: a :class:`Mesh` names
axes ('data', 'model', 'pipe', 'seq') over a grid of ``torch.device``s,
one position per grid cell, and positions may share a physical device
(two on ``cuda:0``, eight on the host CPU). A logical array over the mesh
is a :class:`MeshArray`: one tensor per position, laid out by a partition
spec (one mesh axis, or None, per array dimension): a dimension that names
an axis is split along it in the axis' order, and the array is whole
(replicated) along every axis its spec does not name. The collectives
between positions (:func:`all_reduce`, :func:`all_gather`,
:func:`gather_axis`, :func:`ppermute`, :func:`all_to_all`) are
``.to(device)`` copies, sums and concatenations, one code path whether two
positions share a card or not, and differentiable, so autograd carries the
gradient reductions. :data:`COUNTERS` counts each kind.

``shard_map_compat`` and ``axis_size`` have no counterpart: they run a
per-device function whose collectives are implicit in the mesh axis
names, and the port's single controller holds every position's tensor
itself. The port's ``ring.ring_attention``, ``ring.ulysses_attention`` and
``pipeline.pipeline_apply`` take the mesh and the per-position tensors
explicitly instead. ``global_data_mesh``, ``host_to_global``,
``host_broadcast0`` and ``local_view`` wait for multi-process training
(ROADMAP.md A.11b), and ``is_multiprocess`` is always False.
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

#: collectives between positions run since the last :func:`reset_counters`:
#: ``all_reduce`` (sums: BatchNorm statistics, gradients, metric sums),
#: ``all_gather`` (an op run on the value gathered along an axis, see
#: ``executor``), ``broadcast`` (a value copied to every position),
#: ``ppermute`` (a rotation to the neighbour along an axis: ring
#: attention's K/V, the pipeline's activations) and ``all_to_all`` (the
#: sequence-to-head exchange of Ulysses attention)
COUNTERS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0,
            "ppermute": 0, "all_to_all": 0}
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
    """Named axes over a grid of ``torch.device``s, one position per grid
    cell (ref: ``jax.sharding.Mesh``). Positions may name the same
    device. Position ``r`` is the ``r``-th cell in row-major order, and
    ``coords(r)`` its index along each axis."""

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
        self._coords = [dict(zip(self.axis_names, c))
                        for c in np.ndindex(*arr.shape)]

    @property
    def shape(self):
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    def size(self, axis):
        """The number of positions along ``axis`` (1 when absent)."""
        return data_axis_size(self, axis)

    def coords(self, r):
        """Position ``r``'s index along each axis, ``{axis: index}``."""
        return self._coords[r]

    def replica_devices(self):
        """The device of each position, in mesh order."""
        return list(self.devices.flat)

    def split_axes(self):
        """The axes with more than one position."""
        return [a for a, n in self.shape.items() if n > 1]

    def is_data_only(self):
        """Whether every axis but 'data' has one position."""
        return all(a == AXIS_DATA for a in self.split_axes())

    def __repr__(self):
        return "Mesh(%s, %s)" % (dict(self.shape), self.replica_devices())


class NamedSharding(object):
    """A mesh and a partition spec (ref: ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)


def devices():
    """The devices a mesh is built over by default: every visible CUDA
    device, else the host CPU once per core (CPU positions share the host
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
    """A one-axis 'model' mesh over ``num`` of ``devices`` (all by
    default)."""
    if devices is None:
        devices = globals()["devices"]()
    devices = list(devices)
    if num is not None:
        if num > len(devices):
            raise MXNetError(
                "model_parallel_mesh: %d devices requested, %d visible "
                "(pass devices= to place several positions on one device)"
                % (num, len(devices)))
        devices = devices[:num]
    return make_mesh({AXIS_MODEL: len(devices)}, devices)


def parse_mesh_axes(spec):
    """Parse a mesh-axes spec, ``"data=2,seq=4"`` or ``{"data": 2, "seq":
    4}``, into an ordered ``{axis: size}`` dict (the order becomes the
    mesh's axis order). Axis names come from :data:`AXIS_NAMES`; sizes are
    positive integers. Raises :class:`MXNetError` naming the offending
    token."""
    if isinstance(spec, dict):
        items = list(spec.items())
    else:
        items = []
        for tok in str(spec).split(","):
            tok = tok.strip()
            if not tok:
                continue
            if "=" not in tok:
                raise MXNetError(
                    "mesh axes spec %r: token %r is not 'axis=N' "
                    "(e.g. 'data=2,seq=4')" % (spec, tok))
            name, _, num = tok.partition("=")
            items.append((name.strip(), num.strip()))
    axes = {}
    for name, num in items:
        if name not in AXIS_NAMES:
            raise MXNetError(
                "mesh axes spec %r: unknown axis %r (valid: %s)"
                % (spec, name, ", ".join(AXIS_NAMES)))
        try:
            n = int(num)
        except (TypeError, ValueError):
            raise MXNetError("mesh axes spec %r: axis %r size %r is not "
                             "an integer" % (spec, name, num))
        if n < 1:
            raise MXNetError("mesh axes spec %r: axis %r size must be "
                             ">= 1, got %d" % (spec, name, n))
        if name in axes:
            raise MXNetError("mesh axes spec %r: axis %r given twice"
                             % (spec, name))
        axes[name] = n
    if not axes:
        raise MXNetError("mesh axes spec %r names no axes" % (spec,))
    return axes


def mesh_from_spec(spec, devices=None):
    """A multi-axis Mesh from a spec (:func:`parse_mesh_axes`) over the
    first ``prod(sizes)`` of ``devices`` (default :func:`devices`). A
    shortfall names the devices seen and how to place several positions
    on one device."""
    axes = parse_mesh_axes(spec)
    if devices is None:
        devices = globals()["devices"]()
    devices = list(devices)
    need = int(np.prod(list(axes.values())))
    if need > len(devices):
        raise MXNetError(
            "mesh %s needs %d devices but only %d are visible (%s) — pass "
            "devices= with a device listed once per position (positions "
            "may share a device, e.g. [\"cuda:0\"] * %d)"
            % ("x".join("%s=%d" % kv for kv in axes.items()), need,
               len(devices), ", ".join(sorted({str(d) for d in devices})),
               need))
    return make_mesh(axes, devices[:need])


_NO_SHARD_MAP = (
    "%s has no counterpart in the port and never will: it runs a "
    "per-device function whose collectives are implicit in the mesh axis "
    "names, while the port's single controller holds every position's "
    "tensor itself. parallel.ring.ring_attention, ring.ulysses_attention "
    "and pipeline.pipeline_apply take the mesh and the per-position "
    "tensors explicitly (ROADMAP.md, 'Options that raise')")


def shard_map_compat(f, mesh=None, in_specs=None, out_specs=None,
                     check_vma=None, **kw):
    """Raises: see :data:`_NO_SHARD_MAP`."""
    raise MXNetError(_NO_SHARD_MAP % "shard_map_compat")


def axis_size(axis_name):
    """Raises: see :data:`_NO_SHARD_MAP`."""
    raise MXNetError(_NO_SHARD_MAP % "axis_size")


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
    """Number of shards along the mesh's ``axis`` (1 when absent)."""
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return int(mesh.shape[axis])


def superbatch_sharding(mesh, axis=AXIS_DATA, seq=False):
    """The sharding of stacked ``(k, batch, ...)`` superbatches: the step
    axis whole, the batch axis split along ``axis``. ``SuperBatchIter``
    lands its copies with it, so each position receives only its shard.
    ``seq=True`` over a mesh with a 'seq' axis also splits dim 2 (the
    token dim of a stacked ``(k, batch, seq)`` batch) along 'seq'."""
    if mesh is None:
        return None
    if seq and AXIS_SEQ in mesh.axis_names:
        bax = axis if axis in mesh.axis_names else None
        return NamedSharding(mesh, P(None, bax, AXIS_SEQ))
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
# arrays over a mesh and the collectives between positions
# ---------------------------------------------------------------------------

def _spec_from_axis(ndim, axis):
    spec = [None] * ndim
    if axis is not None:
        spec[axis] = AXIS_DATA
    return tuple(spec)


def shard_index(mesh, spec, r):
    """The index of position ``r``'s shard along each split dimension of
    ``spec``: positions with equal indices hold the same values."""
    c = mesh.coords(r)
    return tuple(c[a] for a in spec if a is not None)


def distinct_positions(mesh, spec):
    """The first position holding each distinct shard of an array laid out
    by ``spec``, in mesh order."""
    seen, out = set(), []
    for r in range(len(mesh.replica_devices())):
        k = shard_index(mesh, spec, r)
        if k not in seen:
            seen.add(k)
            out.append(r)
    return out


def local_shape(shape, mesh, spec):
    """One position's shape of a ``shape`` laid out by ``spec``."""
    return tuple(d // data_axis_size(mesh, a) if a is not None else d
                 for d, a in zip(shape, spec))


class MeshArray(object):
    """One logical array over a mesh's positions: ``parts[r]`` is position
    ``r``'s tensor, on its device, laid out by ``spec`` (one mesh axis or
    None per dimension; see the module's note). ``axis`` (an int, or None
    for a replicated array) is the 'data'-only spelling: ``spec`` with
    'data' at that dimension; :attr:`axis` reads the dimension 'data'
    splits back."""

    __slots__ = ("mesh", "parts", "spec")

    def __init__(self, mesh, parts, axis=None, spec=None):
        self.mesh = mesh
        self.parts = list(parts)
        if spec is None:
            spec = _spec_from_axis(self.parts[0].dim(), axis)
        names = mesh.axis_names
        self.spec = tuple(a if a in names else None for a in spec)

    @property
    def axis(self):
        return (self.spec.index(AXIS_DATA) if AXIS_DATA in self.spec
                else None)

    @property
    def shape(self):
        return tuple(d * data_axis_size(self.mesh, a) if a is not None
                     else d for d, a in zip(self.parts[0].shape, self.spec))

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def ndim(self):
        return self.parts[0].dim()

    @property
    def sharding(self):
        spec = list(self.spec)
        while spec and spec[-1] is None:
            spec.pop()
        return NamedSharding(self.mesh, P(*spec))

    def split_dims(self):
        """``[(dim, axis)]`` of the dimensions the spec splits."""
        return [(i, a) for i, a in enumerate(self.spec) if a is not None]

    def gather(self, device=None):
        """The whole array on ``device`` (position 0's by default)."""
        device = self.parts[0].device if device is None else device
        split = self.split_dims()
        if not split:
            return self.parts[0].to(device)
        if split == [(split[0][0], AXIS_DATA)] and self.mesh.is_data_only():
            return torch.cat([p.to(device) for p in self.parts], split[0][0])
        reps = {}
        for r, p in enumerate(self.parts):
            reps.setdefault(shard_index(self.mesh, self.spec, r), p)

        def build(prefix, k):
            if k == len(split):
                return reps[prefix].to(device)
            dim, a = split[k]
            return torch.cat([build(prefix + (j,), k + 1)
                              for j in range(self.mesh.size(a))], dim)
        return build((), 0)


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
    """One position's shape of a ``shape`` whose batch ``axis`` (None: no
    batch axis) the 'data' axis of ``mesh`` splits: what a per-position
    computation, such as a metric's device sums, sees."""
    n = data_axis_size(mesh)
    if axis is None or n == 1:
        return tuple(shape)
    return tuple(d // n if i == axis else d for i, d in enumerate(shape))


def split(t, mesh, axis):
    """``t`` split along ``axis`` over the mesh's 'data' axis into a
    :class:`MeshArray`, each shard copied to its position's device (a view
    where it is already there)."""
    if not mesh.is_data_only():
        return split_spec(t, mesh, _spec_from_axis(t.dim(), axis))
    devs = mesh.replica_devices()
    n = len(devs)
    size = t.shape[axis]
    if size % n:
        raise MXNetError("split: dimension %d of size %d does not divide "
                         "the %d-way 'data' mesh axis" % (axis, size, n))
    step = size // n
    return MeshArray(mesh, [t.narrow(axis, r * step, step).to(d)
                            for r, d in enumerate(devs)], axis)


def _narrow(t, mesh, spec, r):
    """Position ``r``'s shard of the whole tensor ``t`` laid out by
    ``spec``."""
    c = mesh.coords(r)
    for dim, a in enumerate(spec):
        if a is not None:
            n = mesh.size(a)
            step = t.shape[dim] // n
            t = t.narrow(dim, c[a] * step, step)
    return t


def split_spec(t, mesh, spec):
    """The whole tensor ``t`` laid out by ``spec`` over ``mesh``: each
    position's shard copied to its device (one copy for positions that
    share a device and a shard; a view where it is already there)."""
    spec = tuple(a if a in mesh.axis_names else None for a in spec)
    spec += (None,) * (t.dim() - len(spec))
    for dim, a in enumerate(spec):
        if a is not None and t.shape[dim] % mesh.size(a):
            raise MXNetError(
                "split: dimension %d of size %d does not divide the %d-way "
                "%r mesh axis" % (dim, t.shape[dim], mesh.size(a), a))
    done, parts = {}, []
    for r, d in enumerate(mesh.replica_devices()):
        key = (d, shard_index(mesh, spec, r))
        if key not in done:
            done[key] = _narrow(t, mesh, spec, r).to(d)
        parts.append(done[key])
    return MeshArray(mesh, parts, spec=spec)


def replicate(tree, mesh):
    """A tensor, or a dict of them, as replicated :class:`MeshArray`s:
    position 0's part the tensor on its device, every other position's a
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
    if axis == AXIS_DATA and mesh.is_data_only():
        return split(tree, mesh, 0)
    return split_spec(tree, mesh, (axis,))


def all_reduce(parts, devices):
    """The sum of ``parts`` (one tensor per position), summed in position
    order and placed on each position's device: bitwise the same
    everywhere. Positions on one device share the one sum.
    Differentiable."""
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
    """The shards ``parts`` concatenated along ``axis`` on each position's
    device (shared where positions share a device). Differentiable."""
    _count("all_gather")
    out, done = [], {}
    for d in devices:
        if d not in done:
            done[d] = torch.cat([p.to(d) for p in parts], axis)
        out.append(done[d])
    return out


def axis_groups(mesh, axis):
    """The positions of ``mesh`` grouped along ``axis``: one list per
    index of the other axes, each in ``axis`` order (one group of every
    position for a mesh without ``axis``)."""
    groups = collections.OrderedDict()
    for r in range(len(mesh.replica_devices())):
        c = mesh.coords(r)
        key = tuple(v for a, v in c.items() if a != axis)
        groups.setdefault(key, []).append(r)
    return list(groups.values())


def gather_axis(arr, axis):
    """``arr`` gathered along the mesh ``axis``: the dimension its spec
    splits along ``axis`` becomes whole on every position (the
    concatenation of the positions along ``axis``, shared where they sit
    on one device); an array not split along ``axis`` comes back as it
    is. Differentiable."""
    if axis not in arr.spec:
        return arr
    _count("all_gather")
    dim = arr.spec.index(axis)
    devs = arr.mesh.replica_devices()
    parts = list(arr.parts)
    for grp in axis_groups(arr.mesh, axis):
        done = {}
        for r in grp:
            d = devs[r]
            if d not in done:
                done[d] = torch.cat([arr.parts[q].to(d) for q in grp], dim)
            parts[r] = done[d]
    spec = tuple(None if a == axis else a for a in arr.spec)
    return MeshArray(arr.mesh, parts, spec=spec)


def narrow_axis(arr, axis, dim):
    """``arr``, whole along the mesh ``axis``, split along ``dim`` by it:
    each position keeps its slice (no copy)."""
    if axis in arr.spec or arr.mesh.size(axis) == 1:
        return arr
    n = arr.mesh.size(axis)
    parts = []
    for r, p in enumerate(arr.parts):
        step = p.shape[dim] // n
        parts.append(p.narrow(dim, arr.mesh.coords(r)[axis] * step, step))
    spec = list(arr.spec)
    spec[dim] = axis
    return MeshArray(arr.mesh, parts, spec=spec)


def reshard(arr, spec):
    """``arr`` laid out by ``spec``: gathered along the axes whose
    dimension changes, then split along the new ones."""
    spec = tuple(spec) + (None,) * (arr.ndim - len(spec))
    for dim, a in enumerate(arr.spec):
        if a is not None and spec[dim] != a:
            arr = gather_axis(arr, a)
    for dim, a in enumerate(spec):
        if a is not None and arr.spec[dim] != a:
            arr = narrow_axis(arr, a, dim)
    return arr


def ppermute(parts, devices, shift=1):
    """A rotation along one mesh axis: ``parts`` (one tensor per position
    of the axis, in order) moved ``shift`` positions on, so position ``j``
    receives position ``j - shift``'s tensor on its device (the JAX
    package's ``ppermute`` with ``perm=[(j, j + shift)]``).
    Differentiable."""
    _count("ppermute")
    n = len(parts)
    return [parts[(j - shift) % n].to(devices[j]) for j in range(n)]


def all_to_all(parts, devices, split_dim, concat_dim):
    """The tiled all-to-all along one mesh axis: position ``j`` receives
    chunk ``j`` (along ``split_dim``) of every position's tensor,
    concatenated along ``concat_dim`` in position order (the JAX package's
    ``lax.all_to_all(..., tiled=True)``). Differentiable."""
    _count("all_to_all")
    n = len(parts)
    chunks = [torch.chunk(p, n, dim=split_dim) for p in parts]
    return [torch.cat([chunks[i][j].to(devices[j]) for i in range(n)],
                      concat_dim) for j in range(n)]


def grad_sync(grads, axis_name=AXIS_DATA):
    """Explicit gradient all-reduce: every :class:`MeshArray` of ``grads``
    (a dict) becomes the replicated sum of its parts."""
    out = {}
    for k, g in grads.items():
        devs = g.mesh.replica_devices()
        out[k] = MeshArray(g.mesh, all_reduce(g.parts, devs), None)
    return out
