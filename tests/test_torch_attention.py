"""The port's attention ops (``LayerNorm``, ``MultiHeadAttention``, the
blockwise attention core and ``TransformerStack``) against the JAX
package's, on the CPU.

The same numpy inputs (from a seed) go through both packages' op
functions; gradients are taken under the same random head gradients
(``jax.vjp`` against ``torch.autograd.grad``). Tolerances: forward and
gradients ``rtol=1e-5``, with ``atol`` 1e-5 of the array's largest
magnitude (float32; both packages round once per operation, but the two
backends sum the products of an einsum in other orders, and a weight's
gradient sums batch x seq such products, whose cancellation leaves small
elements with a larger relative error: measured at most 1e-6 of the
largest). Shapes, errors and the symbol-level checks are exact.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import transformer_stack as jstack
from mxnet_tpu.ops.registry import OpContext as JOpContext
from mxnet_tpu.parallel import ring as jring
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import transformer_stack as tstack
from mxnet_tpu_torch.ops.registry import OpContext as TOpContext

RTOL = 1e-5
B, S, E, H = 2, 16, 32, 4


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _both(jfn, tfn, ins, rng):
    """Forward both functions on ``ins`` and backpropagate the same random
    head gradients; returns ((jax outs, jax grads), (port outs, port
    grads)) as numpy."""
    jouts, vjp = jax.vjp(lambda *a: tuple(jfn(list(a))),
                         *[jnp.asarray(i) for i in ins])
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = [torch.from_numpy(i.copy()).requires_grad_() for i in ins]
    touts = tfn(leaves)
    tgrads = torch.autograd.grad(touts, leaves,
                                 [torch.from_numpy(c) for c in cots])
    return (([np.asarray(o) for o in jouts], [np.asarray(g) for g in jgrads]),
            ([o.detach().numpy() for o in touts],
             [g.numpy() for g in tgrads]))


def _assert_close(j, t):
    (jo, jg), (to, tg) = j, t
    for a, b in zip(jo + jg, to + tg):
        assert a.shape == b.shape
        _close(b, a)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _mha_inputs(rng, no_bias, s=S):
    x = rng.standard_normal((B, s, E)).astype(np.float32)
    wqkv = (0.3 * rng.standard_normal((3 * E, E))).astype(np.float32)
    bqkv = (0.1 * rng.standard_normal(3 * E)).astype(np.float32)
    wout = (0.3 * rng.standard_normal((E, E))).astype(np.float32)
    bout = (0.1 * rng.standard_normal(E)).astype(np.float32)
    return [x, wqkv, wout] if no_bias else [x, wqkv, bqkv, wout, bout]


@pytest.mark.parametrize("block", [0, 4])
@pytest.mark.parametrize("no_bias", [False, True], ids=["bias", "no_bias"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_mha_matches_jax(causal, no_bias, block):
    """Output and the gradients of the data and every weight."""
    rng = _rng("mha-%s-%s-%d" % (causal, no_bias, block))
    attrs = dict(num_heads=H, causal=causal, no_bias=no_bias,
                 block_size=block)
    ins = _mha_inputs(rng, no_bias)
    j, t = _both(
        lambda a: jatt._mha(JOpContext(True, None), attrs, a, []),
        lambda a: tatt._mha(TOpContext(is_train=True), attrs, a, []),
        ins, rng)
    _assert_close(j, t)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches_jax(axis):
    rng = _rng("ln-%d" % axis)
    x = (2.0 * rng.standard_normal((B, 6, 8)) + 0.5).astype(np.float32)
    c = x.shape[axis]
    ins = [x, rng.standard_normal(c).astype(np.float32),
           rng.standard_normal(c).astype(np.float32)]
    attrs = dict(axis=axis, eps=1e-5)
    j, t = _both(
        lambda a: jatt._layer_norm(JOpContext(True, None), attrs, a, []),
        lambda a: tatt._layer_norm(TOpContext(is_train=True), attrs, a, []),
        ins, rng)
    _assert_close(j, t)


@pytest.mark.parametrize("sq,sk,block,causal", [
    (16, 16, None, True), (16, 16, 5, True), (7, 13, 4, False),
    (13, 13, 4, True), (3, 600, None, False)])
def test_blockwise_core_matches_jax(sq, sk, block, causal):
    """The streaming-softmax core on its own: ragged last blocks (padding
    masked), several blocks, the default block of min(512, sk)."""
    rng = _rng("core-%d-%d-%s-%s" % (sq, sk, block, causal))
    ins = [rng.standard_normal((2, 3, n, 8)).astype(np.float32)
           for n in (sq, sk, sk)]
    j, t = _both(
        lambda a: [jring.blockwise_attention(*a, block_size=block,
                                             causal=causal)],
        lambda a: [tatt.blockwise_attention(*a, block_size=block,
                                            causal=causal)],
        ins, rng)
    _assert_close(j, t)


def test_block_attn_step_matches_jax():
    rng = _rng("block-step")
    q, k, v = (rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
               for _ in range(3))
    m = rng.standard_normal((2, 3, 5)).astype(np.float32)
    l = np.abs(rng.standard_normal((2, 3, 5))).astype(np.float32)
    acc = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    want = jring._block_attn(*[jnp.asarray(a) for a in (q, k, v, m, l, acc)],
                             0.125)
    got = tatt._block_attn(*[torch.from_numpy(a) for a in (q, k, v, m, l,
                                                            acc)], 0.125)
    for a, b in zip(want, got):
        _close(b.numpy(), np.asarray(a))


def _stack_inputs(rng, L, hidden):
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    shapes, _, _ = tstack._stack_infer(
        dict(num_layers=L, num_heads=H, ffn_hidden=hidden), [x.shape])
    ws = []
    for name, shp in zip(tstack.STACK_INPUTS[1:], shapes[1:]):
        scale = 0.1 if "bias" in name or "beta" in name else 0.3
        base = 1.0 if "gamma" in name else 0.0
        ws.append((base + scale * rng.standard_normal(shp))
                  .astype(np.float32))
    return [x] + ws


@pytest.mark.parametrize("block", [0, 4])
def test_transformer_stack_matches_jax(block):
    rng = _rng("stack-%d" % block)
    attrs = dict(num_layers=2, num_heads=H, ffn_hidden=48, causal=True,
                 block_size=block)
    j, t = _both(
        lambda a: jstack._transformer_stack(JOpContext(True, None), attrs,
                                            a, []),
        lambda a: tstack._transformer_stack(TOpContext(is_train=True),
                                            attrs, a, []),
        _stack_inputs(rng, 2, 48), rng)
    _assert_close(j, t)


# ---------------------------------------------------------------------------
# shapes, arity and errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,attrs,shapes", [
    ("MultiHeadAttention", dict(num_heads=4), [(2, 5, 32)]),
    ("MultiHeadAttention", dict(num_heads=2, no_bias=True), [(1, 3, 8)]),
    ("LayerNorm", dict(), [(2, 5, 32)]),
    ("LayerNorm", dict(axis=1), [(2, 5, 32)]),
    ("TransformerStack", dict(num_layers=3, num_heads=4, ffn_hidden=16),
     [(2, 5, 32)]),
])
def test_infer_shape_and_inputs_match_jax(op, attrs, shapes):
    from mxnet_tpu.ops import registry as jreg
    jop, top = jreg.get(op), treg.get(op)
    assert top.list_inputs(attrs) == jop.list_inputs(attrs)
    n = len(top.list_inputs(attrs))
    ins = shapes + [None] * (n - len(shapes))
    assert top.infer_shape(attrs, ins) == jop.infer_shape(attrs, ins)


@pytest.mark.parametrize("op,attrs,shapes", [
    ("MultiHeadAttention", dict(num_heads=4), [None]),
    ("MultiHeadAttention", dict(num_heads=4), [(2, 32)]),
    ("MultiHeadAttention", dict(num_heads=5), [(2, 3, 32)]),
    ("MultiHeadAttention", dict(num_heads=4, seq_parallel="rings"),
     [(2, 3, 32)]),
    ("LayerNorm", dict(), [None]),
    ("TransformerStack", dict(num_layers=2, num_heads=4, ffn_hidden=8),
     [None]),
    ("TransformerStack", dict(num_layers=2, num_heads=4, ffn_hidden=8),
     [(2, 32)]),
    ("TransformerStack", dict(num_layers=2, num_heads=3, ffn_hidden=8),
     [(2, 3, 32)]),
])
def test_infer_shape_errors_match_jax(op, attrs, shapes):
    from mxnet_tpu.ops import registry as jreg
    n = len(treg.get(op).list_inputs(attrs))
    ins = shapes + [None] * (n - 1)
    with pytest.raises(JMXNetError) as jerr:
        jreg.get(op).infer_shape(attrs, ins)
    with pytest.raises(MXNetError) as terr:
        treg.get(op).infer_shape(attrs, ins)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_seq_parallel_builds_and_raises_at_forward(mode):
    """A sequence-parallel attention needs a mesh with a 'seq' axis: the
    symbol builds and infers shapes as in the JAX package, a forward
    outside one raises as the JAX package's does, and inside a
    ``MeshScope`` with a 4-way 'seq' axis it equals the plain attention
    (``rtol=1e-5``)."""
    data = mt.sym.Variable("data")
    net = mt.sym.MultiHeadAttention(data=data, num_heads=H,
                                    seq_parallel=mode, name="attn")
    arg_shapes, out_shapes, _ = net.infer_shape(data=(B, S, E))
    assert out_shapes == [(B, S, E)]
    ex = net.simple_bind(mt.cpu(), data=(B, S, E))
    with pytest.raises(MXNetError, match="seq_parallel='%s'.*needs an "
                       "ambient mesh with a 'seq' axis" % mode):
        ex.forward(is_train=False)
    rng = _rng("seqpar-%s" % mode)
    vals = _mha_inputs(rng, False)
    plain = net.simple_bind(mt.cpu(), data=(B, S, E))
    for e in (ex, plain):
        for n, v in zip(net.list_arguments(), vals):
            e.arg_dict[n][:] = v
    plain_net = mt.sym.MultiHeadAttention(data=data, num_heads=H,
                                          name="attn")
    ref = plain_net.simple_bind(mt.cpu(), data=(B, S, E))
    for n, v in zip(plain_net.list_arguments(), vals):
        ref.arg_dict[n][:] = v
    want = ref.forward(is_train=False)[0].asnumpy()
    from mxnet_tpu_torch.parallel import mesh as tmesh
    with tmesh.MeshScope(tmesh.make_mesh({"seq": 4}, ["cpu"] * 4)):
        got = ex.forward(is_train=False)[0].asnumpy()
    _close(got, want)
    lm = mt.models.transformer(vocab_size=64, embed=E, num_heads=H,
                               num_layers=1, seq_len=S, seq_parallel=mode)
    ex = lm.simple_bind(mt.cpu(), data=(B, S), softmax_label=(B, S))
    with pytest.raises(MXNetError, match="needs an ambient mesh"):
        ex.forward(is_train=True)


def test_ops_registered_in_both_namespaces():
    for op in ("MultiHeadAttention", "LayerNorm", "TransformerStack"):
        assert treg.exists(op)
        assert hasattr(mt.sym, op) and hasattr(mt.nd, op)
    # the imperative op equals the JAX package's on the same inputs
    rng = _rng("nd-layernorm")
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 8), (8,), (8,)))
    with mt.cpu():
        got = mt.nd.LayerNorm(mt.nd.array(x), mt.nd.array(g),
                              mt.nd.array(b)).asnumpy()
    want = mx.nd.LayerNorm(mx.nd.array(x), mx.nd.array(g),
                           mx.nd.array(b)).asnumpy()
    _close(got, want)
