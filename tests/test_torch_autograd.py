"""``autograd`` of the PyTorch port against the JAX package's on the CPU:
``grad_req`` write/add/null, head gradients, ``grad``/``grad_and_loss``,
a two-layer network written with ``nd`` ops, and arrays changed after
recording.

The same numpy inputs go through both packages. Tolerance for gradients
``rtol=1e-5, atol=1e-6``: the two replay the same float32 ops, summed in
other orders by XLA:CPU and PyTorch.
"""
import zlib

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-6)


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _arrs(pkg, ctx, *arrays):
    return [pkg.nd.array(a, ctx=ctx) for a in arrays]


def _grads_reqs(pkg, ctx, x, w, b, g0, reqs):
    xv, wv, bv = _arrs(pkg, ctx, x, w, b)
    gs = _arrs(pkg, ctx, g0, np.ones_like(w), np.full_like(b, 2.0))
    pkg.autograd.mark_variables([xv, wv, bv], gs, grad_reqs=reqs)
    with pkg.autograd.train_section():
        y = pkg.nd.FullyConnected(xv, wv, bv, num_hidden=4)
        loss = pkg.nd.sum(pkg.nd.tanh(y) * y)
    head = pkg.autograd.compute_gradient([loss])
    return [g.asnumpy() for g in gs] + [head[0].asnumpy()]


def test_grad_reqs_write_add_null_against_jax():
    r = _rng("reqs")
    x = r.standard_normal((3, 5)).astype(np.float32)
    w = r.standard_normal((4, 5)).astype(np.float32)
    b = r.standard_normal((4,)).astype(np.float32)
    g0 = r.standard_normal((3, 5)).astype(np.float32)
    reqs = ["add", "write", "null"]
    j = _grads_reqs(mx, mx.cpu(), x, w, b, g0, reqs)
    t = _grads_reqs(mt, mt.cpu(), x, w, b, g0, reqs)
    for a, b_ in zip(t, j):
        np.testing.assert_allclose(a, b_, **TOL)
    np.testing.assert_array_equal(t[2], 2.0)   # null: untouched


def _mlp_grads(pkg, ctx, arrays, out_grad=None):
    x, w1, b1, w2, b2 = _arrs(pkg, ctx, *arrays)
    params = [w1, b1, w2, b2]
    grads = [pkg.nd.zeros(p.shape, ctx=ctx) for p in params]
    pkg.autograd.mark_variables(params, grads)
    with pkg.autograd.train_section():
        h = pkg.nd.Activation(pkg.nd.FullyConnected(x, w1, b1, num_hidden=6),
                              act_type="relu")
        out = pkg.nd.FullyConnected(h, w2, b2, num_hidden=3)
    heads = pkg.autograd.compute_gradient(
        [out], None if out_grad is None
        else [pkg.nd.array(out_grad, ctx=ctx)])
    return [g.asnumpy() for g in grads] + [heads[0].asnumpy()]


@pytest.mark.parametrize("head", ["ones", "given"])
def test_two_layer_network_against_jax(head):
    r = _rng("mlp" + head)
    arrays = [r.standard_normal(s).astype(np.float32)
              for s in ((4, 5), (6, 5), (6,), (3, 6), (3,))]
    og = (r.standard_normal((4, 3)).astype(np.float32)
          if head == "given" else None)
    j = _mlp_grads(mx, mx.cpu(), arrays, og)
    t = _mlp_grads(mt, mt.cpu(), arrays, og)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, **TOL)


def _f(pkg):
    def f(x, y):
        return pkg.nd.sum(pkg.nd.exp(x) * y + x * x)
    return f


@pytest.mark.parametrize("which", ["grad", "grad_and_loss", "argnum"])
def test_grad_and_grad_and_loss_against_jax(which):
    r = _rng(which)
    x = r.standard_normal((2, 3)).astype(np.float32)
    y = r.standard_normal((2, 3)).astype(np.float32)
    out = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        xs = _arrs(pkg, ctx, x, y)
        if which == "grad":
            got = pkg.autograd.grad(_f(pkg))(*xs)
        elif which == "grad_and_loss":
            grads, loss = pkg.autograd.grad_and_loss(_f(pkg))(*xs)
            got = grads + [loss]
        else:
            got = pkg.autograd.grad(_f(pkg), argnum=1)(*xs)
        out.append([g.asnumpy() for g in got])
    assert len(out[0]) == len(out[1])
    for a, b in zip(out[1], out[0]):
        np.testing.assert_allclose(a, b, **TOL)


def _mutated(pkg, ctx, x, w, how):
    xv, wv = _arrs(pkg, ctx, x, w)
    gx = pkg.nd.zeros(x.shape, ctx=ctx)
    pkg.autograd.mark_variables([xv], [gx])
    with pkg.autograd.train_section():
        y = pkg.nd.sum(xv * wv * xv)
    if how == "unmarked_iadd":
        wv += 1.0
    elif how == "unmarked_setitem":
        wv[:] = 5.0
    elif how == "marked_iadd":
        xv += 1.0
    elif how == "slice_of_unmarked":
        part = wv[0:1]
        part[:] = -3.0
    head = pkg.autograd.compute_gradient([y])
    return gx.asnumpy(), head[0].asnumpy()


@pytest.mark.parametrize("how", ["unmarked_iadd", "unmarked_setitem",
                                 "marked_iadd", "slice_of_unmarked"])
def test_mutation_after_recording_matches_jax(how):
    r = _rng(how)
    x = r.standard_normal((2, 3)).astype(np.float32)
    w = r.standard_normal((2, 3)).astype(np.float32)
    gj, hj = _mutated(mx, mx.cpu(), x, w, how)
    gt, ht = _mutated(mt, mt.cpu(), x, w, how)
    np.testing.assert_allclose(gt, gj, **TOL)
    np.testing.assert_allclose(ht, hj, **TOL)
    if how.startswith("unmarked") or how == "slice_of_unmarked":
        # the recorded value of w, not the new one
        np.testing.assert_allclose(gt, 2 * w * x, **TOL)


def test_scopes_and_flags():
    ag = mt.autograd
    assert not ag.is_recording() and not ag.is_training()
    with ag.train_section():
        assert ag.is_recording() and ag.is_training()
        with ag.test_section():
            assert ag.is_recording() and not ag.is_training()
    assert not ag.is_recording()
    prev = ag.set_is_training(True)
    assert prev is False and ag.is_training()
    ag.set_is_training(prev)
    assert ag.record is ag.train_section and ag.pause is ag.test_section


def test_tape_is_cleared_and_unrecorded_heads_raise():
    x = mt.nd.array([1.0, 2.0], ctx=mt.cpu())
    gx = mt.nd.zeros((2,), ctx=mt.cpu())
    mt.autograd.mark_variables([x], [gx])
    with mt.autograd.train_section():
        y = x * x
    mt.autograd.compute_gradient([y])
    np.testing.assert_allclose(gx.asnumpy(), [2.0, 4.0])
    with pytest.raises(MXNetError, match="not recorded"):
        mt.autograd.compute_gradient([y])
    z = x * 3      # outside recording: no torch graph either
    assert not z.data.requires_grad and z.data.grad_fn is None


def test_no_marked_variables_raises():
    mt.autograd._st().marked.clear()
    with pytest.raises(MXNetError, match="no variables marked"):
        mt.autograd.compute_gradient([mt.nd.ones((1,), ctx=mt.cpu())])
