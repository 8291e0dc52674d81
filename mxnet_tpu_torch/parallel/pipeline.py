"""Pipeline parallelism over a mesh's 'pipe' axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``. The JAX package stacks
the per-stage parameters along a leading stage dimension sharded over
'pipe' and runs the GPipe schedule as one ``lax.scan`` inside
``shard_map``: every tick each stage computes on its in-flight
microbatch and the activations hop to the next stage by ``ppermute``.
The port runs the same schedule over explicit per-stage tensors: stage
``s``'s parameters live on the device of 'pipe' position ``s``, each
activation hops to the next stage's device (counted as a ``ppermute`` in
``parallel.mesh.COUNTERS``, one a tick), and the last stage's outputs
come back to the caller. The JAX schedule also computes its bubble ticks
on data it never reads; the port skips them, which changes no value. The
schedule is plain PyTorch and differentiable through autograd.
"""
from __future__ import annotations

from ..base import MXNetError
from . import mesh as _mesh


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def pipeline_spmd(stage_fn, stage_params, microbatches, devices):
    """The GPipe schedule over explicit stages.

    ``stage_fn(params, x) -> y`` is one stage (``y.shape == x.shape``);
    ``stage_params`` a list of S pytrees, stage ``s``'s on ``devices[s]``;
    ``microbatches`` a sequence of M tensors (or an (M, ...) tensor).
    Returns the M outputs of the last stage, on ``devices[-1]``, in
    order."""
    S = len(stage_params)
    M = len(microbatches)
    held = [None] * S       # the activation each stage computes on next
    outs = [None] * M
    for t in range(S + M - 1):
        ys = [None] * S
        for s in range(S):
            mb = t - s
            if 0 <= mb < M:
                x = (microbatches[mb].to(devices[0]) if s == 0
                     else held[s])
                ys[s] = stage_fn(stage_params[s], x)
        if t >= S - 1:
            outs[t - (S - 1)] = ys[S - 1]
        if S > 1 and t < S + M - 2:
            _mesh._count("ppermute")
            held = [None] + [None if y is None else y.to(devices[s + 1])
                             for s, y in enumerate(ys[:-1])]
    return outs


def _stage_devices(mesh, axis_name, batch_axis):
    """``{batch shard index: [device of each stage]}``: the 'pipe'
    positions of each group along ``axis_name`` whose other coordinates
    are 0, but for ``batch_axis``."""
    out = {}
    devs = mesh.replica_devices()
    for grp in _mesh.axis_groups(mesh, axis_name):
        c = mesh.coords(grp[0])
        if any(v for a, v in c.items() if a not in (axis_name, batch_axis)):
            continue
        out[c.get(batch_axis, 0) if batch_axis else 0] = [devs[r]
                                                         for r in grp]
    return out


def check_pipeline(B, M, S, axis_name, dp=1, batch_axis=None):
    """The schedule's divisibility checks, with the JAX package's
    messages: the batch into ``M`` microbatches, and each microbatch over
    the ``dp``-way ``batch_axis``."""
    if B % M:
        raise MXNetError(
            "pipeline_apply: batch dim %d does not divide into %d "
            "microbatches over the %d-way %r mesh axis — pad the batch "
            "or pass a num_microbatches that divides it" % (B, M, S,
                                                            axis_name))
    if batch_axis is not None and (B // M) % dp:
        raise MXNetError(
            "pipeline_apply: microbatch dim %d does not divide the "
            "%d-way %r mesh axis — every shard must be equal"
            % (B // M, dp, batch_axis))


def pipeline_apply(stage_fn, stacked_params, batch, mesh, axis_name="pipe",
                   num_microbatches=None, batch_axis=None):
    """Split ``batch`` (B, ...) into microbatches, run the GPipe schedule
    over the ``axis_name`` positions of ``mesh`` with stage ``s`` taking
    slice ``s`` of every leaf of ``stacked_params`` (leading dim S, the
    axis' size), and re-assemble the (B, ...) output on ``batch``'s
    device. ``num_microbatches`` defaults to S. ``batch_axis`` (normally
    'data') composes with data parallelism: each microbatch's batch
    dimension splits along that axis, and each of its shards runs its own
    pipeline on its own positions."""
    import torch
    S = dict(mesh.shape)[axis_name]
    M = num_microbatches or S
    B = batch.shape[0]
    check_pipeline(B, M, S, axis_name)
    for leaf in _leaves(stacked_params):
        if leaf.shape[0] != S:
            raise MXNetError(
                "pipeline_apply: stacked-parameter stage dim %d does not "
                "match the %d-way %r mesh axis — stack one stage per "
                "device (or reshape a layer stack to (stages, "
                "layers_per_stage, ...) before the call)"
                % (leaf.shape[0], S, axis_name))
    mb = B // M
    dp = 1
    if batch_axis is not None:
        dp = _mesh.data_axis_size(mesh, batch_axis)
        check_pipeline(B, M, S, axis_name, dp, batch_axis)
    data_axis = batch_axis if dp > 1 else None
    stages = _stage_devices(mesh, axis_name, data_axis)
    micro = batch.reshape((M, mb) + tuple(batch.shape[1:]))
    step = mb // dp
    shards = []
    for i in range(dp):
        devs = stages[i]
        params = [_tree_map(lambda p, s=s, d=d: p[s].to(d), stacked_params)
                  for s, d in enumerate(devs)]
        mbs = [micro[j, i * step:(i + 1) * step] for j in range(M)]
        outs = pipeline_spmd(stage_fn, params, mbs, devs)
        shards.append(torch.stack([o.to(batch.device) for o in outs]))
    out = shards[0] if dp == 1 else torch.cat(shards, 1)
    return out.reshape((B,) + tuple(out.shape[2:]))
