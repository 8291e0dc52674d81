"""``operator.CustomOp`` of the PyTorch port against the JAX package's on the
CPU: a custom op inside a bound symbol (forward and backward), the
imperative ``nd.Custom``, a loss op with ``need_top_grad() == False``, the
legacy ``NumpyOp``, and what the port adds: NDArrays on the op's device in
the user's ``forward``/``backward`` (so ``nd`` ops work there),
``declare_backward_dependency`` honoured, and ``autograd`` through a
custom op.

The same op classes (written against numpy through ``asnumpy``, which
both packages hand over) are registered in both packages. Tolerance
``rtol=1e-5, atol=1e-6`` (float32 sums in other orders around the op).
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


def _register(pkg):
    op_mod = pkg.operator

    class Cube(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], x * x * x)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = in_data[0].asnumpy()
            self.assign(in_grad[0], req[0],
                        3.0 * x * x * out_grad[0].asnumpy())

    @op_mod.register("test_cube")
    class CubeProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Cube()

    class Softmax(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        y / y.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().astype(int)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], y)
            self.assign(in_grad[1], req[1], np.zeros_like(lab, np.float32))

    @op_mod.register("test_softmax")
    class SoftmaxProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


_register(mx)
_register(mt)


def _net(pkg, loss):
    with pkg.symbol.NameManager():
        x = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(x, num_hidden=4, name="fc")
        c = pkg.sym.Custom(h, op_type="test_cube", name="cube")
        if not loss:
            return c
        return pkg.sym.Custom(c, pkg.sym.Variable("label"),
                              op_type="test_softmax", name="sm")


@pytest.mark.parametrize("loss", [False, True])
def test_custom_op_in_bound_symbol_against_jax(loss):
    r = _rng("bound%s" % loss)
    vals = {"data": r.standard_normal((3, 5)).astype(np.float32),
            "fc_weight": r.standard_normal((4, 5)).astype(np.float32) * 0.3,
            "fc_bias": r.standard_normal((4,)).astype(np.float32) * 0.1}
    if loss:
        vals["label"] = np.array([0, 3, 1], np.float32)
    og = r.standard_normal((3, 4)).astype(np.float32)
    res = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        sym = _net(pkg, loss)
        args = {n: pkg.nd.array(v, ctx=ctx) for n, v in vals.items()}
        grads = {n: pkg.nd.zeros(v.shape, ctx=ctx) for n, v in vals.items()
                 if n != "label"}
        ex = sym.bind(ctx, args, args_grad=grads)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(None if loss else [pkg.nd.array(og, ctx=ctx)])
        res.append([out] + [grads[n].asnumpy() for n in sorted(grads)])
    for t, j in zip(res[1], res[0]):
        np.testing.assert_allclose(t, j, **TOL)


def test_nd_custom_against_jax():
    x = _rng("nd").standard_normal((2, 3)).astype(np.float32)
    j = mx.nd.Custom(mx.nd.array(x), op_type="test_cube")
    t = mt.nd.Custom(mt.nd.array(x, ctx=mt.cpu()), op_type="test_cube")
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)
    assert t.context == mt.cpu()


def test_shapes_and_listing_against_jax():
    for loss in (False, True):
        j, t = _net(mx, loss), _net(mt, loss)
        assert t.list_arguments() == j.list_arguments()
        assert t.list_outputs() == j.list_outputs()
        shapes = dict(data=(3, 5), label=(3,)) if loss else dict(data=(3, 5))
        assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
        assert t.tojson() == j.tojson()


def _legacy(pkg):
    class Twice(pkg.operator.NumpyOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = 2.0 * in_data[0] + 1.0

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = 2.0 * out_grad[0]
    return Twice()


def test_legacy_numpy_op_against_jax():
    x = _rng("legacy").standard_normal((2, 3)).astype(np.float32)
    og = _rng("legacy_og").standard_normal((2, 3)).astype(np.float32)
    res = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        sym = _legacy(pkg).get_symbol(pkg.sym.Variable("data"))
        g = pkg.nd.zeros((2, 3), ctx=ctx)
        ex = sym.bind(ctx, {"data": pkg.nd.array(x, ctx=ctx)},
                      args_grad={"data": g})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([pkg.nd.array(og, ctx=ctx)])
        res.append((out, g.asnumpy()))
    for t, j in zip(res[1], res[0]):
        np.testing.assert_allclose(t, j, **TOL)
    assert mt.operator.NDArrayOp is mt.operator.PythonOp


# -- what the port adds ----------------------------------------------------

class _NdScale(mt.operator.CustomOp):
    """Written with nd ops on the NDArrays the port hands over."""
    seen = []

    def forward(self, is_train, req, in_data, out_data, aux):
        _NdScale.seen.append(type(in_data[0]))
        self.assign(out_data[0], req[0], in_data[0] * 3.0 + in_data[1])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        _NdScale.seen.append((in_data[0], in_data[1], out_data[0]))
        self.assign(in_grad[0], req[0], out_grad[0] * 3.0)
        self.assign(in_grad[1], req[1], out_grad[0])


@mt.operator.register("test_nd_scale")
class _NdScaleProp(mt.operator.CustomOpProp):
    def list_arguments(self):
        return ["a", "b"]

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        return list(out_grad)      # needs neither inputs nor outputs

    def create_operator(self, ctx, shapes, dtypes):
        return _NdScale()


def test_port_hands_ndarrays_and_honours_dependencies():
    r = _rng("ndscale")
    a = r.standard_normal((2, 3)).astype(np.float32)
    b = r.standard_normal((2, 3)).astype(np.float32)
    og = r.standard_normal((2, 3)).astype(np.float32)
    with mt.cpu():
        sym = mt.sym.Custom(mt.sym.Variable("a"), mt.sym.Variable("b"),
                            op_type="test_nd_scale")
        ga, gb = mt.nd.zeros((2, 3)), mt.nd.zeros((2, 3))
        ex = sym.bind(mt.cpu(), {"a": mt.nd.array(a), "b": mt.nd.array(b)},
                      args_grad={"a": ga, "b": gb})
        _NdScale.seen.clear()
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([mt.nd.array(og)])
    assert _NdScale.seen[0] is mt.nd.NDArray
    assert _NdScale.seen[1] == (None, None, None)
    np.testing.assert_allclose(out, 3 * a + b, **TOL)
    np.testing.assert_allclose(ga.asnumpy(), 3 * og, **TOL)
    np.testing.assert_allclose(gb.asnumpy(), og, **TOL)


def test_autograd_through_a_custom_op():
    x = _rng("agcustom").standard_normal((2, 3)).astype(np.float32)
    res = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        v = pkg.nd.array(x, ctx=ctx)
        g = pkg.nd.zeros((2, 3), ctx=ctx)
        pkg.autograd.mark_variables([v], [g])
        with pkg.autograd.train_section():
            y = pkg.nd.sum(pkg.nd.Custom(v, op_type="test_cube"))
        pkg.autograd.compute_gradient([y])
        res.append(g.asnumpy())
    np.testing.assert_allclose(res[1], res[0], **TOL)
    np.testing.assert_allclose(res[1], 3 * x * x, **TOL)


def test_unknown_op_type_raises():
    with pytest.raises(MXNetError, match="not registered"):
        mt.sym.Custom(mt.sym.Variable("x"), op_type="no_such_op")
    with pytest.raises(mx.MXNetError, match="not registered"):
        mx.sym.Custom(mx.sym.Variable("x"), op_type="no_such_op")
