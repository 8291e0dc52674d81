"""group2ctx model parallelism lowered to partition specs over a mesh.

Counterpart of ``mxnet_tpu/parallel/placement.py``. The reference places
each ``ctx_group`` on a device and inserts ``_CrossDeviceCopy`` nodes at
group boundaries (ref: src/executor/graph_executor.cc:244-334); the JAX
package maps each group to a sharding spec over the mesh and lets XLA
insert the boundary collectives. The port resolves the same specs and
applies them itself: a grouped parameter is held as one shard per mesh
position (the first dimension the axis divides, so a weight's output
dimension splits and its contraction dimension never does), the graph
runner (``executor``) runs ``FullyConnected`` and ``Convolution`` per
position on their weight's shard, and each grouped node's outputs are
re-laid to the group's spec (the last dimension the axis divides) through
``parallel.mesh.reshard``. Sharding never changes values: a group2ctx run
equals the one-device run.

``group2ctx`` values accepted, with the JAX package's errors:

- a mesh axis name (str), e.g. ``{'decode': 'model'}``;
- a :class:`~mxnet_tpu_torch.parallel.mesh.P`, fitted to each output whose
  shape admits it;
- a :class:`~mxnet_tpu_torch.parallel.mesh.NamedSharding`, spec and mesh;
- a ``Context`` (legacy, e.g. ``mt.gpu(1)``): recorded, and the group
  computes on the bind device, as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..context import Context
from .mesh import AXIS_MODEL, NamedSharding, P


def _axis_size(mesh, names):
    """Total number of shards for one spec entry (str or tuple)."""
    if isinstance(names, str):
        names = (names,)
    shape = dict(mesh.shape)
    return int(np.prod([shape[n] for n in names]))


def _fit_spec(spec, shape, mesh):
    """Clip a spec to a concrete shape: entries that do not divide their
    dimension (or exceed the rank) become None. None if no dimension ends
    up split."""
    out = []
    any_sharded = False
    for d in range(len(shape)):
        e = spec[d] if d < len(spec) else None
        if e is None:
            out.append(None)
            continue
        if shape[d] % _axis_size(mesh, e) == 0:
            out.append(e)
            any_sharded = True
        else:
            out.append(None)
    return P(*out) if any_sharded else None


def _auto_spec(axis, shape, mesh, prefer_first=False):
    """One dimension split over ``axis``: the last (or first, for
    parameters) dimension the axis size divides."""
    n = _axis_size(mesh, axis)
    dims = range(len(shape)) if prefer_first else reversed(range(len(shape)))
    for d in dims:
        if shape[d] > 1 and shape[d] % n == 0:
            return P(*([None] * d + [axis]))
    return None


def auto_spec(axis, shape, mesh, prefer_first=False):
    """The group2ctx auto-sharding rule: one dimension split over ``axis``;
    ``prefer_first=True`` is the parameter rule (the first divisible
    dimension, the output dimension of an (out, in) weight, so contraction
    dimensions never split). None when no dimension divides."""
    return _auto_spec(axis, shape, mesh, prefer_first=prefer_first)


def model_spec(shape, mesh):
    """The serving tier's layout of a parameter over a 'model' mesh: the
    parameter rule of :func:`auto_spec` (the output dimension of an
    ``(out, in)`` weight), replicated (``P()``) where no dimension
    divides."""
    return auto_spec(AXIS_MODEL, tuple(shape), mesh, prefer_first=True) \
        or P()


def _spec_axes(rule):
    """Every mesh axis name a rule refers to."""
    if isinstance(rule, str):
        return [rule]
    out = []
    for e in rule:
        if e is None:
            continue
        out.extend([e] if isinstance(e, str) else list(e))
    return out


def _same_mesh(a, b):
    return (tuple(a.axis_names) == tuple(b.axis_names)
            and a.devices.shape == b.devices.shape)


class GroupPlacement(object):
    """Resolved group2ctx: a spec rule per group, and the spec of each
    grouped parameter and node output."""

    def __init__(self, group2ctx, mesh):
        self.mesh = mesh
        self.raw = dict(group2ctx or {})   # as the user wrote it
        self.groups = {}        # name -> (rule, mesh); rule None = legacy
        for g, v in (group2ctx or {}).items():
            if isinstance(v, Context):
                # legacy device placement: recorded, computed on the bind
                # device
                self.groups[g] = (None, None)
                continue
            if isinstance(v, NamedSharding):
                rule, gmesh = v.spec, v.mesh
            elif isinstance(v, (P, str)):
                rule, gmesh = v, mesh
            else:
                # the JAX package raises TypeError with this message
                raise MXNetError(
                    "group2ctx[%r]: expected Context, mesh axis name, "
                    "PartitionSpec or NamedSharding, got %r" % (g, v))
            if gmesh is None:
                raise MXNetError(
                    "group2ctx[%r] = %r needs a device mesh: pass mesh= or "
                    "bind inside `with MeshScope(mesh):`" % (g, v))
            bad = [a for a in _spec_axes(rule) if a not in gmesh.axis_names]
            if bad:
                raise MXNetError(
                    "group2ctx[%r]: axis %r not in mesh axes %r"
                    % (g, bad[0], tuple(gmesh.axis_names)))
            if self.mesh is None:
                self.mesh = gmesh
            elif gmesh is not self.mesh and not _same_mesh(gmesh, self.mesh):
                raise MXNetError(
                    "group2ctx[%r]: NamedSharding mesh %r conflicts with the "
                    "binding mesh %r — all groups must share one mesh"
                    % (g, tuple(gmesh.axis_names),
                       tuple(self.mesh.axis_names)))
            self.groups[g] = (rule, gmesh)

    def _resolve_spec(self, group, shape, prefer_first=False):
        if group not in self.groups:
            return None
        rule, mesh = self.groups[group]
        if rule is None or mesh is None or len(shape) == 0:
            return None
        if isinstance(rule, str):
            return _auto_spec(rule, shape, mesh, prefer_first)
        if prefer_first:
            # parameters: the rule's first named axis, first divisible dim
            for e in rule:
                if e is not None:
                    ax = e if isinstance(e, str) else e[0]
                    return _auto_spec(ax, shape, mesh, True)
            return None
        return _fit_spec(rule, shape, mesh)

    def output_spec(self, group, shape):
        """The spec of a node output of ``group`` (None: left as the op
        laid it)."""
        return self._resolve_spec(group, tuple(shape))

    def param_spec(self, group, shape):
        """The spec of a parameter consumed by ``group`` (first divisible
        dimension: the (4H, D) LSTM i2h weight splits its gate dimension
        across the axis)."""
        return self._resolve_spec(group, tuple(shape), prefer_first=True)


def node_group(node):
    """The ctx_group annotation of a graph node (AttrScope(ctx_group=...))."""
    return node._user_attr.get("ctx_group")


def param_groups(nodes):
    """Variable name -> ctx_group, from the variable's own annotation or
    the single group of its consumers (as PlaceDevice propagates colours
    to inputs, ref: graph_executor.cc:244-334)."""
    out = {}
    consumers = {}
    for node in nodes:
        if node.is_variable:
            g = node_group(node)
            if g is not None:
                out[node.name] = g
            continue
        g = node_group(node)
        if g is None:
            continue
        for inp, _ in node.inputs:
            if inp.is_variable:
                consumers.setdefault(inp.name, set()).add(g)
    for name, gs in consumers.items():
        if name not in out and len(gs) == 1:
            out[name] = next(iter(gs))
    return out


def resolve(group2ctx, mesh=None):
    """A GroupPlacement, or None if there is nothing to place."""
    if isinstance(group2ctx, GroupPlacement):
        return group2ctx
    if not group2ctx:
        return None
    if mesh is None:
        from .mesh import current_mesh
        mesh = current_mesh()
    gp = GroupPlacement(group2ctx, mesh)
    if gp.mesh is None:
        return None
    return gp
