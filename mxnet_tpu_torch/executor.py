"""Graph execution: lowers a Symbol DAG to a function on tensors, and the
``Executor`` that binds it to arrays.

Counterpart of ``mxnet_tpu/executor.py`` (ref: src/executor/
graph_executor.cc, python/mxnet/executor.py). The JAX package traces the
walk into one XLA program and differentiates it with ``jax.vjp``; here
each op runs eagerly on the tensors' device and torch's autograd records
the training forward. Over a mesh (``mesh=``) one walk runs every
position's shard in lock step: over a 'data' mesh each replica's shard of
the batch, over a mesh with a 'model', 'seq' or 'pipe' axis each value by
its partition spec (``spec_plan``). Placement (``ctx_group`` and
``group2ctx``, ``parallel.placement``) shards the grouped parameters over
the mesh and re-lays the grouped nodes' outputs. The serving tier's
sharding hook (``node_constraint``) and ``shared_exec`` across devices are
not ported (ROADMAP.md A.7c); the arguments that select them raise.

The Conv1x1->BatchNorm fusion pass is the JAX package's, under the same
knob: ``MXTPU_FUSE_CONV_BN`` ``"0"`` (the default) leaves the graph as it
is; ``"1"`` or ``"interpret"`` route every pure NHWC 1x1 Convolution that
feeds a channel-last batch-statistics BatchNorm onto
``ops/matmul_stats.py``, which emits the convolution's output and the
BatchNorm's sum and sum of squares in one pass. Fusion happens only in
training, as in the JAX package. On CUDA tensors the pair runs the CUDA
kernel; on CPU tensors its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, env_str, torch_dtype
from .context import Context, resolve_device
from .ndarray import NDArray, _as_tensor
from .ops import matmul_stats as _ms
from .ops.nn import conv_precision
from .ops.registry import OpContext
from .symbol import _topo
from . import random as _random

#: MXTPU_FUSE_CONV_BN spellings: "0" off; "1" and "interpret" both fuse
FUSE_MODES = ("0", "1", "interpret")


def fuse_mode():
    """The ``MXTPU_FUSE_CONV_BN`` setting (default ``"0"``)."""
    mode = env_str("MXTPU_FUSE_CONV_BN", "0")
    if mode not in FUSE_MODES:
        raise MXNetError("MXTPU_FUSE_CONV_BN must be one of %s, got %r"
                         % (", ".join(FUSE_MODES), mode))
    return mode


def fusion_pairs(nodes):
    """The fusion pass over topologically ordered ``nodes``: returns
    ``(fused_convs, bn_stats_src)``, the Convolution nodes to run on the
    kernel by id, and for each consuming BatchNorm's id its producer's."""
    fused_convs, bn_stats_src = {}, {}
    for node in nodes:
        if node.is_variable or node.op.name != "BatchNorm":
            continue
        if not node.inputs or not _ms.bn_fusable(node.attrs):
            continue
        src, src_idx = node.inputs[0]
        if (src_idx == 0 and not src.is_variable
                and src.op.name == "Convolution"
                and _ms.conv1x1_fusable(src.attrs)):
            fused_convs[id(src)] = src
            bn_stats_src[id(node)] = id(src)
    return fused_convs, bn_stats_src


def node_generator(key, index, device):
    """The random stream of node ``index`` in a run keyed by ``key``: a
    ``torch.Generator`` on ``device`` seeded from both, so each node of
    each step draws its own numbers and a run replays from its key."""
    seed = np.random.SeedSequence([int(key), int(index)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    return gen


#: ``TrainStep(remat=...)`` settings: none, the whole forward recomputed,
#: or only the Convolution and FullyConnected outputs kept
REMAT_MODES = (False, True, "conv")

#: the ops whose outputs ``remat="conv"`` keeps
REMAT_ANCHORS = ("Convolution", "FullyConnected")


def remat_segments(nodes):
    """The op nodes of topologically ordered ``nodes`` (by index) cut into
    runs that each end at a Convolution or FullyConnected node; the last
    run ends at the graph's outputs."""
    segs, cur = [], []
    for k, node in enumerate(nodes):
        if node.is_variable:
            continue
        cur.append(k)
        if node.op.name in REMAT_ANCHORS:
            segs.append(cur)
            cur = []
    if cur:
        segs.append(cur)
    return segs


def _split_axis(gshape, lshape, n):
    """The axis along which ``lshape`` is one of ``n`` equal shards of
    ``gshape``, or None."""
    if len(gshape) != len(lshape):
        return None
    diff = [i for i, (g, l) in enumerate(zip(gshape, lshape)) if g != l]
    if len(diff) == 1 and gshape[diff[0]] == n * lshape[diff[0]]:
        return diff[0]
    return None


def _local_shapes(ins, mesh, axis, keep=None):
    """Each input's shape at one shard of ``axis`` (the dimension its spec
    splits along ``axis`` divided); ``keep`` (indices) are taken whole
    along it."""
    out = []
    for i, v in enumerate(ins):
        sh = list(v.shape)
        if (keep is None or i not in keep) and axis in v.spec:
            d = v.spec.index(axis)
            sh[d] //= mesh.size(axis)
        out.append(tuple(sh))
    return out


def _axis_ok(node, ins, axis):
    """The rules of an op along one mesh axis, beyond shape inference
    (the ``OpDef`` mesh fields)."""
    op, attrs = node.op, node.attrs
    if op.needs_rng or op.mesh_whole:
        return False
    first = ins[0] if ins else None
    split0 = [d for d, a in enumerate(first.spec) if a == axis] \
        if first is not None else []
    if axis != "data":
        if not op.mesh_split:
            return False
        if op.mesh_weight is not None:
            # the weight (and bias) split along its output dimension only
            split = [axis in v.spec for v in ins[1:]]
            if any(split) and not all(
                    s_ and v.spec.index(axis) == 0
                    for s_, v in zip(split, ins[1:])):
                return False
        if any(axis in ins[i].spec for i in op.mesh_whole_inputs
               if i < len(ins)):
            return False
    if op.mesh_axis is not None and first is not None:
        attr, default = op.mesh_axis
        a = attrs.get(attr, default)
        if a is None or str(a) == "None":
            return False
        if int(a) % first.ndim in split0:
            return False
    if op.mesh_reshape and split0 and int(
            np.prod(first.shape[:split0[0]])) > 1:
        return False
    return True


def _splits_contraction(node, x, axis):
    """Whether the data ``x`` of a weight op is split along ``axis`` in a
    dimension the op contracts (or, for a convolution, slides over)."""
    bad = range(1, x.ndim)
    if node.op.name == "FullyConnected" and str(node.attrs.get(
            "flatten", True)) in ("False", "0", "false"):
        bad = [x.ndim - 1]
    return any(a == axis and d in bad for d, a in enumerate(x.spec))


def _infer_local(node, lin, ins, mesh, axis):
    """Output shapes at one shard's input shapes ``lin``; a weight op
    infers them with its output size at its weight's shard. None where
    inference fails."""
    attrs = node.attrs
    if node.op.mesh_weight is not None and len(lin) > 1:
        attrs = dict(attrs)
        attrs[node.op.mesh_weight] = str(lin[1][0])
    try:
        return node.op.infer_shape(attrs, lin)[1]
    except (MXNetError, ValueError, IndexError, TypeError):
        return None


def spec_plan(node, ins, mesh):
    """How node ``node`` runs over a mesh, given its inputs (:class:`~mxnet_tpu_torch.parallel.mesh.
    MeshArray`s). Each mesh axis an input splits is decided on its own,
    from the op's output shapes at one shard of that axis and its rules
    (:func:`_axis_ok`): ``"split"`` runs the op per position on the shards
    and its outputs split along the dimension the shapes show;
    ``"gather0"`` (a weight op whose weight splits along its output
    dimension, on data split along the axis) gathers the data along the
    axis first and keeps the weight's shard; otherwise every input is
    gathered along the axis and the op's output, whole along it, is split
    again where the shapes show a dimension (else left whole). Returns
    ``(gathers, out_specs, narrows)``: the axes to gather each input
    along, each output's spec after the per-position run, and the
    ``(output, axis, dim)`` splits to take after it."""
    gin = [v.shape for v in ins]
    try:
        _, gout, _ = node.op.infer_shape(node.attrs, gin)
    except MXNetError as e:
        raise MXNetError("mesh: node %r (op %s) infers no shapes at the "
                         "whole array's %s: %s" % (node.name, node.op.name,
                                                   gin, e))
    gathers = [[] for _ in ins]
    out_specs = [[None] * len(g) for g in gout]
    narrows = []
    used = [a for a in mesh.axis_names
            if any(a in v.spec for v in ins) and mesh.size(a) > 1]
    for axis in used:
        n = mesh.size(axis)

        def dims_at(keep=None):
            lout = _infer_local(node, _local_shapes(ins, mesh, axis, keep),
                                ins, mesh, axis)
            if lout is None or len(lout) != len(gout):
                return None
            return [_split_axis(tuple(g), tuple(l), n)
                    for g, l in zip(gout, lout)]

        def free(dims):
            return all(d is not None and out_specs[j][d] is None
                       for j, d in enumerate(dims))
        ok = _axis_ok(node, ins, axis)
        weight_op = node.op.mesh_weight is not None and axis != "data"
        dims = dims_at() if ok and not (
            weight_op and _splits_contraction(node, ins[0], axis)) else None
        if dims is not None and free(dims):
            for j, d in enumerate(dims):
                out_specs[j][d] = axis
            continue
        if (ok and weight_op and axis in ins[0].spec
                and any(axis in v.spec for v in ins[1:])):
            dims = dims_at(keep={0})
            if dims is not None and free(dims):
                gathers[0].append(axis)
                for j, d in enumerate(dims):
                    out_specs[j][d] = axis
                continue
        for i, v in enumerate(ins):
            if axis in v.spec:
                gathers[i].append(axis)
        dims = dims_at()
        for j, d in enumerate(dims or [None] * len(gout)):
            if d is not None and out_specs[j][d] is None:
                narrows.append((j, axis, d))
                out_specs[j][d] = axis
    run_specs = [tuple(None if (j, a, d) in narrows else a
                       for d, a in enumerate(sp))
                 for j, sp in enumerate(out_specs)]
    return gathers, run_specs, narrows


def mesh_plan(node, ins, n):
    """:func:`spec_plan` over a 'data' mesh of ``n`` replicas, in the
    replica terms: ``("replica", axes)`` runs the op on each replica's own
    parts, its outputs split along ``axes`` (None: replicated, for an op
    without a split input); ``("whole", axes)`` runs it on the whole batch,
    gathered on every replica, and keeps each output's shard where it
    splits along an axis (else the whole output on every replica)."""
    if all(v.axis is None for v in ins):
        return "replica", None
    gathers, run_specs, narrows = spec_plan(node, ins, ins[0].mesh)
    specs = [list(sp) for sp in run_specs]
    for j, a, d in narrows:
        specs[j][d] = a
    axes = [sp.index("data") if "data" in sp else None for sp in specs]
    return ("whole" if any(gathers) else "replica"), axes


def _first_device(arg_vals):
    if not arg_vals:
        return None
    v = next(iter(arg_vals.values()))
    return v.parts[0].device if hasattr(v, "parts") else v.device


def _build_graph_runner(symbol, placement=None, node_constraint=None,
                        remat=False, mesh=None):
    """Lower the symbol DAG to ``run(arg_vals, aux_vals, rng=None,
    is_train=False, monitor=None) -> (outputs, aux_updates)``. Nodes run in
    topological order over an environment keyed by (node, output index);
    aux state is looked up as ``"<node>_<aux>"`` and its updates come back
    under the same names. ``rng`` is an integer key: ops that declared
    ``needs_rng`` get :func:`node_generator` of it and their node index.
    ``monitor(name, tensor)`` sees every op output. Ops without array
    inputs create theirs on the device of the first argument. Returns
    ``(run, nodes)``.

    ``remat`` (one of :data:`REMAT_MODES`) recomputes activations in the
    backward instead of keeping them (ref: MXNET_BACKWARD_DO_MIRROR), through
    ``torch.utils.checkpoint``: ``True`` checkpoints the whole forward;
    ``"conv"`` checkpoints each segment of :func:`remat_segments`, so the
    values that cross segments (the Convolution and FullyConnected
    outputs, and the inputs a later segment reads, such as a residual
    block's input) are kept and the elementwise chain in each segment, with
    its convolution, runs again in the backward. The recompute draws the
    same random numbers (a node's generator is made from the key and its
    index) and returns aux updates that are dropped, so the moving
    statistics move once a step.

    ``mesh`` (a :class:`~mxnet_tpu_torch.parallel.mesh.Mesh`) runs every
    position in one walk: the values are
    :class:`~mxnet_tpu_torch.parallel.mesh.MeshArray`s (the arguments and
    aux states too), each laid out by its spec, and each node runs for
    every position before the next node starts, so an op that needs the
    whole batch (``OpDef.mesh_fn``: BatchNorm's statistics, Dropout's
    mask, the losses' normalisation) sees every position's shard. Its
    inputs are gathered along the axes the function does not handle
    (``OpDef.mesh_axes``) and it runs once for each index of those axes.
    The other ops follow :func:`spec_plan`. ``placement`` (a resolved
    :class:`~mxnet_tpu_torch.parallel.placement.GroupPlacement`) re-lays
    each grouped node's outputs to its group's spec.

    The fused Conv1x1 runs its kernel on each position's shard where its
    weight is whole and its data splits along 'data' only, and its
    statistics reach BatchNorm's ``mesh_fn`` per position; a pair whose
    weight or data splits along another axis runs unfused, and so does
    every pair under placement, as in the JAX package: the kernel never
    runs on a weight's shard."""
    if node_constraint is not None:
        raise MXNetError("_build_graph_runner: node_constraint (the "
                         "serving tier's sharding hook) is not ported yet "
                         "(ROADMAP.md A.7c)")
    if remat not in REMAT_MODES:
        raise MXNetError("remat must be one of %s, got %r"
                         % (REMAT_MODES, remat))
    nodes = _topo(symbol._out_nodes())
    fused_convs, bn_stats_src = ({}, {}) if (
        fuse_mode() == "0" or placement is not None) \
        else fusion_pairs(nodes)
    node_groups = {}
    if placement is not None:
        from .parallel.placement import node_group
        node_groups = {id(n): node_group(n) for n in nodes
                       if not n.is_variable}
    if mesh is not None:
        from .parallel import mesh as _mesh
        replica_devs = mesh.replica_devices()
        plans = {}

    def call_mesh_fn(k, node, ins, aux_in, rng, is_train, fused):
        """``node``'s mesh_fn over the mesh: its inputs gathered along the
        axes it does not handle, once for each index of those axes (each
        call over the sub-mesh of the handled axes, with those positions'
        ``fused`` statistics). Returns ``(result, the gathered inputs)``;
        the result None where it gives way to the plan."""
        other = [a for a in mesh.split_axes() if a not in node.op.mesh_axes]
        for a in other:
            ins = [_mesh.gather_axis(v, a) for v in ins]
        gen = (node_generator(rng, k, replica_devs[0])
               if node.op.needs_rng and rng is not None else None)
        if not other:
            op_ctx = OpContext(is_train=is_train, rng=gen,
                               fused_stats=fused, device=replica_devs[0])
            return node.op.mesh_fn(op_ctx, node.attrs, ins, aux_in,
                                   replica_devs), ins
        keep = [a for a in mesh.axis_names if a not in other]
        groups = {}
        for r in range(len(replica_devs)):
            c = mesh.coords(r)
            groups.setdefault(tuple(c[a] for a in other), []).append(r)
        outs = aux_up = None
        for grp in groups.values():
            sub = _mesh.Mesh(np.array([replica_devs[r] for r in grp],
                                      dtype=object).reshape(
                                          [mesh.size(a) for a in keep]),
                             keep)

            def view(v, grp=grp, sub=sub):
                return _mesh.MeshArray(sub, [v.parts[r] for r in grp],
                                       spec=v.spec)
            op_ctx = OpContext(
                is_train=is_train, rng=gen, device=replica_devs[grp[0]],
                fused_stats=None if fused is None else [fused[r]
                                                        for r in grp])
            res = node.op.mesh_fn(op_ctx, node.attrs, [view(v) for v in ins],
                                  [view(v) for v in aux_in],
                                  [replica_devs[r] for r in grp])
            if res is None:
                return None, ins
            if outs is None:
                outs = [[None] * len(replica_devs) for _ in res[0]]
                specs = [o.spec for o in res[0]]
                aux_up = (None if res[1] is None else
                          [[None] * len(replica_devs) for _ in res[1]])
            for j, o in enumerate(res[0]):
                for i, r in enumerate(grp):
                    outs[j][r] = o.parts[i]
            for j, o in enumerate(res[1] or ()):
                for i, r in enumerate(grp):
                    aux_up[j][r] = o.parts[i]
        return ([_mesh.MeshArray(mesh, p, spec=sp)
                 for p, sp in zip(outs, specs)],
                None if aux_up is None else
                [_mesh.MeshArray(mesh, p, None) for p in aux_up]), ins

    def fuses_here(ins):
        # the kernel runs on each position's shard where the weight is
        # whole and the data splits along 'data' only: each position's
        # statistics are then its shard of the batch's, which BatchNorm's
        # mesh function sums over 'data'
        x, w = ins[0], ins[1]
        return (all(a is None for a in w.spec)
                and all(a in (None, _mesh.AXIS_DATA) for a in x.spec))

    def apply_mesh(k, env, stats_env, aux_updates, aux_vals, rng, is_train,
                   use_fusion, monitor):
        node = nodes[k]
        MeshArray = _mesh.MeshArray
        ins = [env[(id(n), i)] for n, i in node.inputs]
        aux_names = node.op.list_aux(node.attrs)
        aux_in = [aux_vals["%s_%s" % (node.name, a)] for a in aux_names]
        result = None
        if use_fusion and id(node) in fused_convs and fuses_here(ins):
            x, w = ins[0], ins[1]
            res = [_ms.apply_conv1x1_stats(x.parts[r], w.parts[r])
                   for r in range(len(replica_devs))]
            stats_env[id(node)] = [st for _, st in res]
            result = [MeshArray(mesh, [y for y, _ in res], spec=x.spec)], None
        elif node.op.mesh_fn is not None:
            # where it gives way, the plan takes the inputs it gathered
            fused = (stats_env.get(bn_stats_src.get(id(node)))
                     if use_fusion else None)
            result, ins = call_mesh_fn(k, node, ins, aux_in, rng, is_train,
                                       fused)
        if result is not None:
            outs, aux_up = result
        else:
            key = (k, is_train, tuple((v.shape, v.spec) for v in ins))
            if key not in plans:
                plans[key] = spec_plan(node, ins, mesh)
            gathers, run_specs, narrows = plans[key]
            cols = []
            for v, axes in zip(ins, gathers):
                for a in axes:
                    v = _mesh.gather_axis(v, a)
                cols.append(v)
            per, aux_per = [], []
            for r in range(len(replica_devs)):
                gen = None
                if node.op.needs_rng and rng is not None:
                    gen = node_generator(rng, k, replica_devs[r])
                op_ctx = OpContext(is_train=is_train, rng=gen,
                                   device=replica_devs[r])
                o, a = node.op.apply(op_ctx, node.attrs,
                                     [c.parts[r] for c in cols],
                                     [v.parts[r] for v in aux_in])
                per.append(o)
                aux_per.append(a)
            outs = [MeshArray(mesh, [o[j] for o in per], spec=sp)
                    for j, sp in enumerate(run_specs)]
            if not node.op.loss_head:
                for j, a, d in narrows:
                    outs[j] = _mesh.narrow_axis(outs[j], a, d)
            aux_up = (None if aux_per[0] is None else
                      [MeshArray(mesh, [a[j] for a in aux_per], None)
                       for j in range(len(aux_per[0]))])
        g = node_groups.get(id(node))
        if node.op.loss_head:
            # a loss head's backward ignores its output's cotangent: only
            # the first position of each distinct shard may send it back
            # (a copy's would add the gradient once more), and it keeps
            # its layout
            g = None
            outs = [MeshArray(mesh, [p if r in keep else p.detach()
                                     for r, p in enumerate(o.parts)],
                              spec=o.spec)
                    for o in outs
                    for keep in [set(_mesh.distinct_positions(mesh,
                                                              o.spec))]]
        if g is not None:
            outs = list(outs)
            for j, o in enumerate(outs):
                spec = placement.output_spec(g, o.shape)
                if spec is not None:
                    outs[j] = _mesh.reshard(o, spec)
        for i, o in enumerate(outs):
            env[(id(node), i)] = o
        if monitor is not None:
            for oname, o in zip(node.output_names(), outs):
                monitor(oname, o.gather())
        if aux_up is not None:
            for a, u in zip(aux_names, aux_up):
                aux_updates["%s_%s" % (node.name, a)] = u

    def apply(k, env, stats_env, aux_updates, aux_vals, rng, is_train,
              use_fusion, device, monitor):
        if mesh is not None:
            return apply_mesh(k, env, stats_env, aux_updates, aux_vals, rng,
                              is_train, use_fusion, monitor)
        node = nodes[k]
        ins = [env[(id(n), i)] for n, i in node.inputs]
        aux_names = node.op.list_aux(node.attrs)
        aux_in = [aux_vals["%s_%s" % (node.name, a)] for a in aux_names]
        if use_fusion and id(node) in fused_convs:
            y, stats_env[id(node)] = _ms.apply_conv1x1_stats(ins[0], ins[1])
            outs, aux_up = (y,), None
        else:
            gen = None
            if node.op.needs_rng and rng is not None:
                gen = node_generator(rng, k, ins[0].device if ins else device)
            fused_stats = (stats_env.get(bn_stats_src.get(id(node)))
                           if use_fusion else None)
            op_ctx = OpContext(is_train=is_train, rng=gen,
                               fused_stats=fused_stats, device=device)
            outs, aux_up = node.op.apply(op_ctx, node.attrs, ins, aux_in)
        for i, o in enumerate(outs):
            env[(id(node), i)] = o
        if monitor is not None:
            for oname, o in zip(node.output_names(), outs):
                monitor(oname, o)
        if aux_up is not None:
            for a, u in zip(aux_names, aux_up):
                aux_updates["%s_%s" % (node.name, a)] = u

    def bind_variables(arg_vals):
        env = {}
        for node in nodes:
            if node.is_variable:
                if node.name not in arg_vals:
                    raise MXNetError("graph runner: no value for %r"
                                     % node.name)
                env[(id(node), 0)] = arg_vals[node.name]
        return env

    def run(arg_vals, aux_vals, rng=None, is_train=False, monitor=None):
        use_fusion = bool(fused_convs) and is_train
        device = _first_device(arg_vals)
        env = bind_variables(arg_vals)
        stats_env = {}
        aux_updates = {}
        for k, node in enumerate(nodes):
            if not node.is_variable:
                apply(k, env, stats_env, aux_updates, aux_vals, rng,
                      is_train, use_fusion, device, monitor)
        outputs = [env[(id(n), i)] for n, i in symbol._outputs]
        return outputs, aux_updates

    if not remat:
        return run, nodes
    from torch.utils.checkpoint import checkpoint

    if remat is True:
        def run_remat(arg_vals, aux_vals, rng=None, is_train=False,
                      monitor=None):
            return checkpoint(run, arg_vals, aux_vals, rng, is_train,
                              monitor, use_reentrant=False)
        return run_remat, nodes

    segs = remat_segments(nodes)
    seg_of = {id(nodes[k]): i for i, seg in enumerate(segs) for k in seg}
    out_keys = {(id(n), i) for n, i in symbol._outputs}
    # per segment: the environment entries it reads from outside itself,
    # and those it writes that a later segment or the outputs read
    reads = [[] for _ in segs]
    needed = set(out_keys)
    for i, seg in enumerate(segs):
        for k in seg:
            for src, idx in nodes[k].inputs:
                key = (id(src), idx)
                if seg_of.get(id(src)) != i and key not in reads[i]:
                    reads[i].append(key)
                    needed.add(key)
    writes = [[(id(nodes[k]), o) for k in seg
               for o in range(len(nodes[k].output_names()))
               if (id(nodes[k]), o) in needed] for seg in segs]
    # the fused producers whose statistics a later segment's BatchNorm reads
    stats_out = [[id(nodes[k]) for k in seg if id(nodes[k]) in fused_convs]
                 for seg in segs]

    def run_segments(arg_vals, aux_vals, rng=None, is_train=False,
                     monitor=None):
        use_fusion = bool(fused_convs) and is_train
        device = _first_device(arg_vals)
        env = bind_variables(arg_vals)
        stats_env = {}
        aux_updates = {}
        for i, seg in enumerate(segs):
            def segment(vals, stats_in, i=i, seg=seg):
                local = dict(zip(reads[i], vals))
                local_stats = dict(stats_in)
                local_aux = {}
                for k in seg:
                    apply(k, local, local_stats, local_aux, aux_vals, rng,
                          is_train, use_fusion, device, monitor)
                return ([local[key] for key in writes[i]],
                        {c: local_stats[c] for c in stats_out[i]
                         if c in local_stats}, local_aux)
            outs, stats, aux_up = checkpoint(
                segment, [env[key] for key in reads[i]], dict(stats_env),
                use_reentrant=False)
            env.update(zip(writes[i], outs))
            stats_env.update(stats)
            aux_updates.update(aux_up)
        outputs = [env[(id(n), i)] for n, i in symbol._outputs]
        return outputs, aux_updates

    return run_segments, nodes


def head_pairs(outs, cots=None):
    """The (tensor, cotangent) pairs of the graph outputs ``outs`` that
    carry a gradient (``cots``: one whole tensor per output, None for
    ones). An output is a tensor, or a MeshArray over a mesh: the first
    position holding each distinct shard, with its slice of the cotangent
    (a replicated output's position 0 only, as it is one value: each
    copy would add it once more)."""
    from .parallel import mesh as _mesh
    pairs = []
    for j, o in enumerate(outs):
        if isinstance(o, torch.Tensor):
            parts = [(o, None)]
        else:
            parts = [(o.parts[r], r)
                     for r in _mesh.distinct_positions(o.mesh, o.spec)]
        for t, r in parts:
            if not t.requires_grad:
                continue
            if cots is None:
                c = torch.ones_like(t)
            elif r is None:
                c = cots[j].to(t.device)
            else:
                c = _mesh._narrow(cots[j], o.mesh, o.spec, r).to(t.device)
            pairs.append((t, c))
    return pairs


def shard_grad_sums(grads, mesh, spec, devices=None):
    """A parameter's gradient over the mesh: each position's part
    (``grads``) summed with the parts of every position holding the same
    shard (in position order), on each position's device (or on
    ``devices[r]``): the sum over every axis the parameter is whole
    along."""
    from .parallel import mesh as _mesh
    devs = mesh.replica_devices() if devices is None else list(devices)
    groups = {}
    for r in range(len(devs)):
        groups.setdefault(_mesh.shard_index(mesh, spec, r), []).append(r)
    out = [None] * len(devs)
    for grp in groups.values():
        parts = [grads[r] for r in grp]
        if len(grp) == 1:
            out[grp[0]] = parts[0]
            continue
        summed = _mesh.all_reduce(parts, [devs[r] for r in grp])
        for r, g in zip(grp, summed):
            out[r] = g
    return out


class Executor(object):
    """A symbol bound to arrays on one device (ref:
    python/mxnet/executor.py).

    ``arg_dict``/``grad_dict``/``aux_dict`` are the bound NDArrays:
    ``forward`` reads the arguments and aux states and writes the new aux
    states (training only), ``backward`` writes the gradients into the
    arrays given as ``args_grad``, by ``grad_req`` (``write``, ``add``,
    ``null``). Arguments that share one gradient array receive the sum of
    their gradients.

    ``forward(is_train=True)`` keeps the autograd graph for the next
    ``backward``, which frees it; a second ``backward`` after one forward
    recomputes the graph from the values that forward read (without
    updating the aux states again), so it gives the same gradients, as the
    JAX package's re-running ``backward`` does. The next ``forward`` drops
    an unused graph.
    """

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None, shared_exec=None,
                 mesh=None, batch_names=(), batch_axes=None):
        # ctx_group model parallelism: the groups' specs over the mesh
        # (parallel.placement); simple_bind passes a resolved placement
        from .parallel import placement as _placement
        self._placement = _placement.resolve(group2ctx, mesh)
        self._group2ctx = (dict(self._placement.raw) if self._placement
                           is not None else dict(group2ctx or {}))
        if self._placement is not None:
            if mesh is None:
                mesh = self._placement.mesh
            elif mesh is not self._placement.mesh:
                raise MXNetError("Executor: group2ctx's mesh is not the "
                                 "executor's mesh")
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self._device = resolve_device(self._ctx, "Executor")
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()

        self.arg_dict = self._normalize(args, self.arg_names, "args")
        self.arg_arrays = [self.arg_dict[n] for n in self.arg_names]
        self.grad_dict = ({} if args_grad is None else self._normalize(
            args_grad, self.arg_names, "args_grad", allow_missing=True))
        self.grad_arrays = [self.grad_dict.get(n) for n in self.arg_names]
        self.aux_dict = (self._normalize(aux_states, self.aux_names, "aux")
                         if self.aux_names else {})
        self.aux_arrays = [self.aux_dict[n] for n in self.aux_names]
        for what, arrays in (("args", self.arg_dict),
                             ("args_grad", self.grad_dict),
                             ("aux_states", self.aux_dict)):
            for n, a in arrays.items():
                if a.data.device != self._device:
                    raise MXNetError(
                        "bind: %s[%r] is on %s, the executor on %s"
                        % (what, n, a.data.device, self._device))

        if isinstance(grad_req, str):
            self._grad_req = {n: (grad_req if n in self.grad_dict else "null")
                              for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self.arg_names}
        for n in self.arg_names:
            if (self._grad_req.get(n, "null") != "null"
                    and n not in self.grad_dict):
                if not self.arg_dict[n].data.is_floating_point():
                    # integer inputs have no gradient (reference kNullOp)
                    self._grad_req[n] = "null"
                    continue
                raise MXNetError("grad_req %r for %s but no grad array bound"
                                 % (self._grad_req[n], n))

        # over a 'data' mesh (an executor group of several contexts): the
        # bound arrays hold the whole batch and one copy of the parameters;
        # each forward splits ``batch_names`` across the replicas along
        # their batch axes (``batch_axes``: name -> the 'N' of its layout,
        # parallel.mesh.batch_axes), copies the rest to every replica, and
        # merges the outputs and gradients
        self._mesh = mesh
        self._batch_names = list(batch_names)
        self._batch_axes = dict(batch_axes or {})
        self._run, self._nodes = _build_graph_runner(
            symbol, placement=self._placement, mesh=mesh)
        # the grouped parameters' specs (the inputs stay unsharded)
        self._param_specs = {}
        if self._placement is not None:
            for n, g in _placement.param_groups(self._nodes).items():
                if n in self.arg_dict and n not in self._batch_names:
                    spec = self._placement.param_spec(
                        g, self.arg_dict[n].shape)
                    if spec is not None:
                        self._param_specs[n] = spec
        self._diff_args = [n for n in self.arg_names
                           if self._grad_req.get(n, "null") != "null"]
        # one entry per gradient buffer: the arguments writing into it
        self._grad_groups = []
        by_buf = {}
        for n in self._diff_args:
            buf = self.grad_dict[n]
            if id(buf) in by_buf:
                self._grad_groups[by_buf[id(buf)]][1].append(n)
            else:
                by_buf[id(buf)] = len(self._grad_groups)
                self._grad_groups.append((buf, [n]))
        self._needs_rng = any((not n.is_variable) and n.op.needs_rng
                              for n in self._nodes)
        self._base_key = None
        self._step = 0
        self._monitor_callback = None
        self._pending = None    # (arg_vals, aux_vals, key, is_train)
        self._graph = None      # (outputs, leaves) of forward(is_train=True)
        self.outputs = []

    def _normalize(self, arrays, names, what, allow_missing=False):
        if arrays is None:
            arrays = {}
        if isinstance(arrays, (list, tuple)):
            if len(arrays) != len(names):
                raise MXNetError("%s: expected %d arrays, got %d"
                                 % (what, len(names), len(arrays)))
            return {n: a for n, a in zip(names, arrays) if a is not None}
        out = {}
        for n in names:
            if n in arrays:
                out[n] = arrays[n]
            elif not allow_missing:
                raise MXNetError("%s: missing array for %r" % (what, n))
        return out

    # ------------------------------------------------------------------
    def _monitor(self):
        cb = self._monitor_callback
        if cb is None:
            return None
        return lambda name, t: cb(name, NDArray(t.detach()))

    def _to_mesh(self, arg_vals, aux_vals):
        """The bound values as MeshArrays: the batch inputs split along
        their batch axis, the rest replicated."""
        from .parallel import mesh as _mesh
        m = self._mesh
        _, axes = _mesh.batch_axes(
            {n: tuple(arg_vals[n].shape) for n in self._batch_names},
            self._batch_axes)
        out = {}
        for n, t in arg_vals.items():
            ax = axes.get(n)
            if n in self._param_specs:
                out[n] = _mesh.split_spec(t, m, self._param_specs[n])
            else:
                out[n] = (_mesh.split(t, m, ax) if ax is not None
                          else _mesh.replicate(t, m))
        return out, {n: _mesh.replicate(t, m) for n, t in aux_vals.items()}

    def _run_graph(self, vals, aux_vals, key, is_train):
        outs, aux_up = self._run(vals, aux_vals, key, is_train,
                                 self._monitor())
        if self._mesh is None:
            return outs, aux_up
        # merged: the outputs in batch order and replica 0's aux updates
        # (every replica's are the same)
        return ([o.gather(self._device) for o in outs],
                {n: u.parts[0] for n, u in aux_up.items()})

    def _forward_graph(self, arg_vals, aux_vals, key):
        """The training forward with the differentiated arguments as
        leaves: ``(outputs, aux updates, leaves)``; over a mesh the outputs
        are MeshArrays and each leaf a list, one tensor per replica."""
        vals = dict(arg_vals)
        if self._mesh is None:
            leaves = {n: arg_vals[n].detach().requires_grad_()
                      for n in self._diff_args}
            vals.update(leaves)
        else:
            from .parallel.mesh import MeshArray
            vals, aux_vals = self._to_mesh(vals, aux_vals)
            leaves = {}
            for n in self._diff_args:
                v = vals[n]
                leaves[n] = [p.detach().requires_grad_() for p in v.parts]
                vals[n] = MeshArray(self._mesh, leaves[n], spec=v.spec)
        with torch.enable_grad(), conv_precision(self._device):
            outs, aux_up = self._run(vals, aux_vals, key, True,
                                     self._monitor())
        if self._mesh is not None:
            aux_up = {n: u.parts[0] for n, u in aux_up.items()}
        return outs, aux_up, leaves

    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays (after copying ``kwargs`` into
        the named arguments); returns :attr:`outputs`."""
        # a deferred MXNET_PROFILER_AUTOSTART starts at the first dispatch
        from . import profiler as _profiler
        _profiler.maybe_autostart()
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("forward: unknown argument %r" % k)
            dst = self.arg_dict[k]
            if tuple(getattr(v, "shape", ())) != dst.shape:
                raise MXNetError("forward: %r has shape %s, bound as %s"
                                 % (k, tuple(getattr(v, "shape", ())),
                                    dst.shape))
            dst[:] = v
        key = None
        if self._needs_rng:
            if self._base_key is None:
                self._base_key = _random.randint63()
            key = self._base_key + self._step
            self._step += 1
        arg_vals = {n: self.arg_dict[n].data for n in self.arg_names}
        aux_vals = {n: self.aux_dict[n].data for n in self.aux_names}
        self._pending = (arg_vals, aux_vals, key, bool(is_train))
        self._graph = None
        if is_train and self._diff_args:
            outs, aux_up, leaves = self._forward_graph(arg_vals, aux_vals,
                                                       key)
            self._graph = (outs, leaves)
            if self._mesh is not None:
                outs = [o.gather(self._device) for o in outs]
        else:
            with torch.no_grad(), conv_precision(self._device):
                vals, avals = ((arg_vals, aux_vals) if self._mesh is None
                               else self._to_mesh(arg_vals, aux_vals))
                outs, aux_up = self._run_graph(vals, avals, key,
                                               bool(is_train))
        self.outputs = [NDArray(o.detach()) for o in outs]
        if is_train:
            for n, u in aux_up.items():
                self.aux_dict[n]._set_data(u)
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the outputs (with head gradients ``out_grads``,
        default ones) into the bound gradient arrays by ``grad_req``."""
        if self._pending is None:
            raise MXNetError("call forward(is_train=True) before backward()")
        arg_vals, aux_vals, key, is_train = self._pending
        if not is_train:
            raise MXNetError("backward called on forward(is_train=False)")
        if not self._diff_args:
            return
        if self._graph is None:
            outs, _aux_up, leaves = self._forward_graph(arg_vals, aux_vals,
                                                        key)
        else:
            (outs, leaves), self._graph = self._graph, None
        if out_grads is None:
            cots = [torch.ones(o.shape, dtype=o.dtype, device=self._device)
                    for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cots = [_as_tensor(g, self._device).to(device=self._device,
                                                   dtype=o.dtype)
                    for g, o in zip(out_grads, outs)]
        pairs = head_pairs(outs, cots)
        names = list(leaves)
        flat = [t for n in names for t in (leaves[n] if self._mesh is not None
                                           else [leaves[n]])]
        grads = [None] * len(flat)
        if pairs:
            with conv_precision(self._device):
                grads = torch.autograd.grad(
                    [o for o, _ in pairs], flat,
                    [c for _, c in pairs], allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(flat, grads)]
        if self._mesh is None:
            by_name = dict(zip(names, grads))
        else:
            by_name, i = {}, 0
            for n in names:
                parts = grads[i:i + len(leaves[n])]
                i += len(leaves[n])
                by_name[n] = self._merge_grads(n, parts)
        for buf, group in self._grad_groups:
            g = by_name[group[0]]
            for n in group[1:]:
                g = g + by_name[n]
            if self._grad_req[group[0]] == "add":
                g = buf.data + g
            buf._set_data(g)

    def _merge_grads(self, name, parts):
        """One argument's whole gradient on the executor's device from its
        positions' parts: each shard's parts summed (in position order)
        over the positions that hold it, the shards assembled. A batch
        input's shards lie side by side; a replicated argument's parts
        add up."""
        from .parallel import mesh as _mesh
        m = self._mesh
        shape = self.arg_dict[name].shape
        if name in self._param_specs:
            spec = tuple(self._param_specs[name])
            spec += (None,) * (len(shape) - len(spec))
        else:
            ax = (_split_axis(tuple(shape), tuple(parts[0].shape),
                              m.size(_mesh.AXIS_DATA))
                  if name in self._batch_names else None)
            spec = _mesh._spec_from_axis(len(shape), ax)
        summed = shard_grad_sums(parts, m, spec,
                                 [self._device] * len(parts))
        return _mesh.MeshArray(m, summed, spec=spec).gather(self._device)

    # ------------------------------------------------------------------
    def set_monitor_callback(self, callback):
        """``callback(name, NDArray)`` on every op output of each forward
        (ref: GraphExecutor::SetMonitorCallback)."""
        self._monitor_callback = callback

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arguments and aux states."""
        for params, dst, what in ((arg_params, self.arg_dict, "an argument"),
                                  (aux_params or {}, self.aux_dict,
                                   "an aux state")):
            for name, array in params.items():
                if name in dst:
                    dst[name]._set_data(_as_tensor(array).clone())
                elif not allow_extra_params:
                    raise MXNetError("copy_params_from: %r is not %s"
                                     % (name, what))

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor bound to new input shapes, sharing the arrays
        whose shapes stay (ref: executor.py reshape). Without
        ``partial_shaping`` only the given inputs may change shape; without
        ``allow_up_sizing`` no array may grow."""
        new_shapes = {n: tuple(kwargs[n]) for n in self.arg_names
                      if n in kwargs}

        def zeros(sh, like):
            return NDArray(torch.zeros(sh, dtype=like.data.dtype,
                                       device=self._device))

        def resize(name, cur, sh, explicit):
            if not (explicit or partial_shaping):
                raise MXNetError(
                    "reshape: %r changes shape %s -> %s; pass "
                    "partial_shaping=True to allow reshaping arguments "
                    "beyond the given inputs" % (name, cur.shape, tuple(sh)))
            new_size = int(np.prod(sh)) if sh else 1
            if new_size > cur.size and not allow_up_sizing:
                raise MXNetError(
                    "reshape: %r grows %d -> %d elements; pass "
                    "allow_up_sizing=True to allocate larger arrays"
                    % (name, cur.size, new_size))
            return zeros(sh, cur)

        arg_shapes, _, aux_shapes = self._symbol.infer_shape_partial(
            **new_shapes)
        args, grads = {}, {}
        for n, sh in zip(self.arg_names, arg_shapes):
            cur = self.arg_dict[n]
            if sh is None or cur.shape == tuple(sh):
                args[n] = cur
                if n in self.grad_dict:
                    grads[n] = self.grad_dict[n]
            else:
                args[n] = resize(n, cur, sh, n in kwargs)
                if n in self.grad_dict:
                    grads[n] = zeros(sh, cur)
        aux = {}
        for n, sh in zip(self.aux_names, aux_shapes):
            cur = self.aux_dict[n]
            aux[n] = (cur if sh is None or cur.shape == tuple(sh)
                      else resize(n, cur, sh, False))
        return Executor(self._symbol, self._ctx, args, grads or None,
                        self._grad_req, aux, mesh=self._mesh,
                        batch_names=self._batch_names,
                        batch_axes=self._batch_axes,
                        group2ctx=self._placement)

    @property
    def symbol(self):
        return self._symbol

    def debug_str(self):
        lines = ["Symbol outputs: %s" % ", ".join(self.output_names)]
        for node in self._nodes:
            if node.is_variable:
                lines.append("Variable:%s" % node.name)
            else:
                lines.append("Op:%s, Name=%s" % (node.op.name, node.name))
        return "\n".join(lines)


def simple_bind(symbol, ctx, grad_req="write", type_dict=None, group2ctx=None,
                shared_exec=None, mesh=None, batch_names=(), batch_axes=None,
                **kwargs):
    """Allocate every array (zeros) on ``ctx`` from the shapes and dtypes
    inferred from ``kwargs`` and ``type_dict``, then bind (ref:
    python/mxnet/symbol.py simple_bind). With ``shared_exec``, arrays of
    the same name, shape and dtype are that executor's. ``mesh``,
    ``batch_names`` and ``batch_axes``: see :class:`Executor`."""
    from .parallel import placement as _placement
    gp = _placement.resolve(group2ctx, mesh)
    if gp is not None and not batch_names:
        # the inputs whose shapes are given stay unsharded
        batch_names = list(kwargs)
    ctx = ctx if isinstance(ctx, Context) else Context(ctx)
    if shared_exec is not None and shared_exec._ctx != ctx:
        raise MXNetError("simple_bind: shared_exec on %s cannot share "
                         "arrays with an executor on %s (not ported)"
                         % (shared_exec._ctx, ctx))
    device = resolve_device(ctx, "simple_bind")
    arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    # one typed input (bf16 data, int32 label) types the parameters, as
    # the reference's InferType pass does
    type_dict = dict(type_dict or {})
    arg_types, _out_t, aux_types = symbol.infer_type_partial(**type_dict)
    for n, t in zip(arg_names, arg_types):
        if n not in type_dict and t is not None:
            type_dict[n] = t
    aux_type_of = dict(zip(aux_names, aux_types))

    def alloc(pool, n, sh, dt):
        shared = pool.get(n) if shared_exec is not None else None
        if (shared is not None and shared.shape == tuple(sh)
                and shared.dtype == dt):
            return shared
        return NDArray(torch.zeros(tuple(sh), dtype=torch_dtype(dt),
                                   device=device))

    args, grads = {}, {}
    for n, sh in zip(arg_names, arg_shapes):
        dt = np.dtype(type_dict.get(n, np.float32))
        args[n] = alloc(shared_exec.arg_dict if shared_exec else {}, n, sh,
                        dt)
        req = grad_req if isinstance(grad_req, str) else (
            grad_req[arg_names.index(n)] if isinstance(grad_req, (list, tuple))
            else grad_req.get(n, "null"))
        # integer inputs (labels, lookup ids) carry no gradient
        if req != "null" and np.issubdtype(dt, np.floating):
            grads[n] = alloc(shared_exec.grad_dict if shared_exec else {},
                             n, sh, dt)
    aux = {n: alloc(shared_exec.aux_dict if shared_exec else {}, n, sh,
                    np.dtype(aux_type_of.get(n) or np.float32))
           for n, sh in zip(aux_names, aux_shapes)}
    return Executor(symbol, ctx, args, grads or None, grad_req, aux,
                    group2ctx=gp if gp is not None else group2ctx,
                    mesh=mesh, batch_names=batch_names, batch_axes=batch_axes)
