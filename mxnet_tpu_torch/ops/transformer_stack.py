"""TransformerStack: the whole pre-LN layer stack as ONE op over stacked
parameters.

Counterpart of ``mxnet_tpu/ops/transformer_stack.py``. Each weight arrives
as an (L, ...) stack; the JAX package runs the L layers as one
``lax.scan`` on one device, or as a GPipe schedule under a mesh with a
'pipe' axis. The port runs them in a Python loop over the L stacked
slices, each through :func:`_one_layer`, the same math as the per-layer
symbol composition (LayerNorm + MultiHeadAttention + FullyConnected), so
stacked and per-layer builds agree for equal weights. Autograd flows back
through the indexing into each stack.

Under a mesh with a 'pipe' axis the stack runs the GPipe schedule of
``parallel/pipeline.py``, as the JAX package's does: the (L, ...) stacks
fold to (S, L/S, ...), one stage of L/S layers per 'pipe' position, and
the batch splits into ``num_microbatches`` microbatches (0: one per
stage). A graph walk over the mesh (``executor``) takes each stage's
layers from its own position (the stage's shard where the stack is split
along 'pipe' at dim 0, e.g. by ``param_shardings={...: P('pipe')}``, else
its slice of the whole stack there), and each 'data' shard runs its own
pipeline; a whole tensor under an ambient 'pipe' mesh runs
``pipeline_apply``. On one device ``num_microbatches`` is unused.
"""
from __future__ import annotations

import torch

from ..base import attr_bool, attr_int, MXNetError
from ..parallel.ring import blockwise_attention
from .attention import layer_norm
from .registry import OpDef, register_def

#: stacked-parameter input order (leading dim L on every non-data input)
STACK_INPUTS = ("data", "ln1_gamma", "ln1_beta", "qkv_weight", "qkv_bias",
                "out_weight", "out_bias", "ln2_gamma", "ln2_beta",
                "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias")


def _stack_attrs(attrs):
    num_layers = attr_int(attrs["num_layers"])
    num_heads = attr_int(attrs["num_heads"])
    ffn_hidden = attr_int(attrs["ffn_hidden"])
    causal = attr_bool(attrs.get("causal", True), True)
    block = attr_int(attrs.get("block_size", 0), 0)
    micro = attr_int(attrs.get("num_microbatches", 0), 0)
    return num_layers, num_heads, ffn_hidden, causal, block, micro


def _stack_infer(attrs, in_shapes):
    L, num_heads, H, _, _, _ = _stack_attrs(attrs)
    data = in_shapes[0]
    if data is None:
        raise MXNetError("TransformerStack: data shape required")
    if len(data) != 3:
        raise MXNetError("TransformerStack: data must be "
                         "(batch, seq, embed), got %s" % (data,))
    e = data[2]
    if e % num_heads:
        raise MXNetError("TransformerStack: embed %d %% num_heads %d != 0"
                         % (e, num_heads))
    shapes = [tuple(data),
              (L, e), (L, e),               # ln1 gamma/beta
              (L, 3 * e, e), (L, 3 * e),    # qkv
              (L, e, e), (L, e),            # out proj
              (L, e), (L, e),               # ln2 gamma/beta
              (L, H, e), (L, H),            # ffn fc1
              (L, e, H), (L, e)]            # ffn fc2
    return shapes, [tuple(data)], []


def _one_layer(p, x, num_heads, causal, block):
    """One pre-LN block: x + MHA(LN(x)); x + FFN(LN(x))."""
    (ln1_g, ln1_b, wqkv, bqkv, wout, bout,
     ln2_g, ln2_b, w1, b1, w2, b2) = p
    b, s, e = x.shape
    d = e // num_heads
    a = layer_norm(x, ln1_g, ln1_b)
    qkv = torch.einsum("bse,fe->bsf", a, wqkv) + bqkv
    qkv = qkv.reshape(b, s, 3, num_heads, d)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    o = blockwise_attention(q, k, v, block_size=block or None,
                            causal=causal)
    o = o.permute(0, 2, 1, 3).reshape(b, s, e)
    x = x + torch.einsum("bse,fe->bsf", o, wout) + bout
    f = layer_norm(x, ln2_g, ln2_b)
    f = torch.relu(torch.einsum("bse,he->bsh", f, w1) + b1)
    f = torch.einsum("bsh,eh->bse", f, w2) + b2
    return x + f


def _layers(num_heads, causal, block):
    """A stage body: the layers of a (layers, ...) stack in turn."""
    def run(stack, x):
        for i in range(stack[0].shape[0]):
            x = _one_layer(tuple(p[i] for p in stack), x, num_heads, causal,
                           block)
        return x
    return run


def _pipe_checks(mesh, L, b):
    from ..parallel.mesh import (AXIS_DATA, AXIS_PIPE, check_axis_divides)
    check_axis_divides(mesh, AXIS_PIPE, L, "TransformerStack: num_layers")
    check_axis_divides(mesh, AXIS_DATA, b, "TransformerStack: batch dim")


def _transformer_stack(op_ctx, attrs, inputs, aux):
    L, num_heads, _, causal, block, micro = _stack_attrs(attrs)
    x, params = inputs[0], tuple(inputs[1:])
    run = _layers(num_heads, causal, block)
    from ..parallel import mesh as _mesh
    mesh = _mesh.current_mesh()
    if mesh is None or _mesh.AXIS_PIPE not in mesh.axis_names:
        return (run(params, x),)
    from ..parallel.pipeline import pipeline_apply
    S = _mesh.data_axis_size(mesh, _mesh.AXIS_PIPE)
    _pipe_checks(mesh, L, x.shape[0])
    # fold the (L, ...) stacks onto stages: (S, L/S, ...)
    staged = tuple(p.reshape((S, L // S) + tuple(p.shape[1:]))
                   for p in params)
    bax = _mesh.AXIS_DATA if _mesh.AXIS_DATA in mesh.axis_names else None
    return (pipeline_apply(run, staged, x, mesh, axis_name=_mesh.AXIS_PIPE,
                           num_microbatches=micro or None, batch_axis=bax),)


def _transformer_stack_mesh(op_ctx, attrs, ins, aux, devices):
    """The stack over a mesh with a 'pipe' axis: per group of 'pipe'
    positions (one a 'data' shard), the GPipe schedule with stage ``s``'s
    layers from position ``s`` and the shard's microbatches; the last
    stage's output is copied to every position of the group. None (the
    plan's walk) without a 'pipe' axis."""
    from ..parallel import mesh as _mesh
    from ..parallel.pipeline import check_pipeline, pipeline_spmd
    L, num_heads, _, causal, block, micro = _stack_attrs(attrs)
    x = ins[0]
    mesh = x.mesh
    S = mesh.size(_mesh.AXIS_PIPE)
    if S == 1:
        return None
    _pipe_checks(mesh, L, x.shape[0])
    M = micro or S
    x = _mesh.reshard(x, (x.spec[0] if x.spec[0] == _mesh.AXIS_DATA
                          else None, None, None))
    dp = mesh.size(_mesh.AXIS_DATA) if x.spec[0] else 1
    check_pipeline(x.shape[0], M, S, _mesh.AXIS_PIPE, dp,
                   _mesh.AXIS_DATA if dp > 1 else None)
    per = L // S
    run = _layers(num_heads, causal, block)

    def stage(p, r, s):
        t = p.parts[r]
        if p.spec[0] == _mesh.AXIS_PIPE:
            return t
        return t[s * per:(s + 1) * per]
    parts = list(x.parts)
    for grp in _mesh.axis_groups(mesh, _mesh.AXIS_PIPE):
        devs = [devices[r] for r in grp]
        stages = [tuple(stage(p, r, s) for p in ins[1:])
                  for s, r in enumerate(grp)]
        xb = x.parts[grp[0]]
        bl = xb.shape[0]
        mbs = xb.reshape((M, bl // M) + tuple(xb.shape[1:]))
        y = torch.cat(pipeline_spmd(run, stages, mbs, devs,
                                    _mesh.AXIS_PIPE), 0)
        done = {}
        for r in grp:
            if devices[r] not in done:
                done[devices[r]] = y.to(devices[r])
            parts[r] = done[devices[r]]
        # the last stage's output copied to every position of the group
        # (the inventory's; not counted in COUNTERS)
        _mesh._note("collective-broadcast", _mesh._nbytes(y), len(grp),
                    (_mesh.AXIS_PIPE,), (y,), [parts[r] for r in grp])
    return [_mesh.MeshArray(mesh, parts, spec=x.spec)], None


_STACK = register_def(OpDef("TransformerStack", _transformer_stack,
                            inputs=STACK_INPUTS, infer_shape=_stack_infer))
_STACK.mesh_fn = _transformer_stack_mesh
_STACK.mesh_axes = ("data", "pipe")
