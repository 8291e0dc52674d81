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

The port cannot form a 'pipe' mesh: ``Module(mesh_axes=...)``,
``MXTPU_LM_MESH`` and ``TrainStep(mesh=...)`` raise :class:`MXNetError`
(ROADMAP.md A.7b), and ``num_microbatches`` is accepted and unused, as on
one device in the JAX package.
"""
from __future__ import annotations

import torch

from ..base import attr_bool, attr_int, MXNetError
from .attention import blockwise_attention, layer_norm
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


def _transformer_stack(op_ctx, attrs, inputs, aux):
    L, num_heads, _, causal, block, _ = _stack_attrs(attrs)
    x, params = inputs[0], tuple(inputs[1:])
    for i in range(L):
        x = _one_layer(tuple(p[i] for p in params), x, num_heads, causal,
                       block)
    return (x,)


register_def(OpDef("TransformerStack", _transformer_stack,
                   inputs=STACK_INPUTS, infer_shape=_stack_infer))
