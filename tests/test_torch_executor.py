"""``Symbol.bind``/``simple_bind`` and the ``Executor`` of the PyTorch port
against the JAX package's on the CPU: an MLP and a ResNet-18 (NCHW, 16x16
images, batch 2), outputs, gradients and BatchNorm statistics after
``forward``/``backward``, head gradients, shared gradient buffers,
``grad_req="add"``, ``backward`` twice, ``reshape``,
``copy_params_from``, the monitor callback, dtype inference, composition
and the errors.

The same numpy inputs and weights go through both packages. Tolerances,
each with its reason:
- the MLP, float32: ``rtol=1e-5, atol=1e-6`` (XLA:CPU and PyTorch sum the
  products in other orders);
- ResNet-18 outputs, gradients and moving statistics: within 1e-4 of
  each array's largest magnitude: convolution sums in other orders,
  carried through 18 layers and BatchNorm at batch 2, which amplifies a
  last-bit difference in one element into its whole channel, so the error
  scales with the array and not with each element (measured: at most
  1.1e-5 of the largest gradient, over four seeds);
- a second ``backward`` and ``grad_req="add"`` within the port: exactly
  (the same ops on the same tensors, on the CPU).
"""
import zlib

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError

F32 = dict(rtol=1e-5, atol=1e-6)
NET = "scaled 1e-4"


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _mlp(pkg, head=True):
    with pkg.symbol.NameManager():
        s = pkg.sym.Variable("data")
        s = pkg.sym.FullyConnected(s, num_hidden=8, name="fc1")
        s = pkg.sym.Activation(s, act_type="relu", name="relu1")
        s = pkg.sym.FullyConnected(s, num_hidden=3, name="fc2")
        if head:
            s = pkg.sym.SoftmaxOutput(s, name="softmax")
    return s


def _values(sym, shapes, seed, ints=()):
    """numpy values for every argument (and aux state) of ``sym``."""
    r = _rng(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ints:
            args[n] = r.integers(0, ints[n], s).astype(np.float32)
        else:
            args[n] = (r.standard_normal(s) * 0.5).astype(np.float32)
    aux = {}
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = (np.ones(s, np.float32) if n.endswith("var")
                  else np.zeros(s, np.float32)) + \
            np.abs(r.standard_normal(s)).astype(np.float32) * 0.1
    return args, aux


def _bind(pkg, ctx, sym, args, aux, grad_req="write", no_grad=()):
    a = {n: pkg.nd.array(v, ctx=ctx) for n, v in args.items()}
    g = {n: pkg.nd.zeros(v.shape, ctx=ctx) for n, v in args.items()
         if n not in no_grad}
    x = {n: pkg.nd.array(v, ctx=ctx) for n, v in aux.items()}
    return sym.bind(ctx, a, args_grad=g, grad_req=grad_req, aux_states=x)


def _step(ex, out_grads=None):
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward(out_grads)
    grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()}
    aux = {n: a.asnumpy() for n, a in ex.aux_dict.items()}
    return outs, grads, aux


def _allclose(got, want, tol, name=""):
    if tol == NET:
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * scale, (name, err, scale)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


def _close(t, j, tol):
    to, tg, ta = t
    jo, jg, ja = j
    for a, b in zip(to, jo):
        _allclose(a, b, tol)
    assert set(tg) == set(jg)
    for n in jg:
        _allclose(tg[n], jg[n], tol, n)
    for n in ja:
        _allclose(ta[n], ja[n], tol, n)


MLP_SHAPES = dict(data=(4, 5), softmax_label=(4,))


def test_mlp_bind_forward_backward_against_jax():
    args, aux = _values(_mlp(mx), MLP_SHAPES, "mlp",
                        ints={"softmax_label": 3})
    j = _step(_bind(mx, mx.cpu(), _mlp(mx), args, aux,
                    no_grad=("softmax_label",)))
    t = _step(_bind(mt, mt.cpu(), _mlp(mt), args, aux,
                    no_grad=("softmax_label",)))
    _close(t, j, F32)


def test_mlp_simple_bind_against_jax():
    jex = _mlp(mx).simple_bind(mx.cpu(), **MLP_SHAPES)
    tex = _mlp(mt).simple_bind(mt.cpu(), **MLP_SHAPES)
    assert tex.arg_names == jex.arg_names
    assert tex.output_names == jex.output_names
    assert sorted(tex.grad_dict) == sorted(jex.grad_dict)
    for n in jex.arg_names:
        assert tex.arg_dict[n].shape == jex.arg_dict[n].shape
        assert tex.arg_dict[n].dtype == jex.arg_dict[n].dtype
        assert tex.arg_dict[n].context == mt.cpu()
    args, _ = _values(_mlp(mx), MLP_SHAPES, "sb", ints={"softmax_label": 3})
    jex.copy_params_from({n: mx.nd.array(v) for n, v in args.items()})
    tex.copy_params_from({n: mt.nd.array(v, ctx=mt.cpu())
                          for n, v in args.items()})
    _close(_step(tex), _step(jex), F32)


def _resnet(pkg, models):
    with pkg.symbol.NameManager():
        return models.resnet(num_classes=4, num_layers=18,
                             image_shape="3,16,16", layout="NCHW")


RES_SHAPES = dict(data=(2, 3, 16, 16), softmax_label=(2,))


@pytest.mark.parametrize("binder", ["bind", "simple_bind"])
def test_resnet18_step_against_jax(binder):
    jsym, tsym = _resnet(mx, jmodels), _resnet(mt, tmodels)
    args, aux = _values(jsym, RES_SHAPES, "resnet",
                        ints={"softmax_label": 4})
    j = _step(_bind(mx, mx.cpu(), jsym, args, aux,
                    no_grad=("softmax_label",)))
    if binder == "bind":
        tex = _bind(mt, mt.cpu(), tsym, args, aux,
                    no_grad=("softmax_label",))
    else:
        tex = tsym.simple_bind(mt.cpu(), grad_req={
            n: "null" if n == "softmax_label" else "write"
            for n in tsym.list_arguments()}, **RES_SHAPES)
        tex.copy_params_from({n: mt.nd.array(v, ctx=mt.cpu())
                              for n, v in args.items()},
                             {n: mt.nd.array(v, ctx=mt.cpu())
                              for n, v in aux.items()})
    _close(_step(tex), j, NET)
    assert len(tex.aux_names) == len(aux) and tex.aux_names


def test_head_gradients_against_jax():
    shapes = dict(data=(4, 5))
    args, _ = _values(_mlp(mx, head=False), shapes, "heads")
    og = _rng("og").standard_normal((4, 3)).astype(np.float32)
    j = _step(_bind(mx, mx.cpu(), _mlp(mx, False), args, {}),
              [mx.nd.array(og)])
    t = _step(_bind(mt, mt.cpu(), _mlp(mt, False), args, {}),
              [mt.nd.array(og, ctx=mt.cpu())])
    _close(t, j, F32)
    # the default head gradient is ones
    j1 = _step(_bind(mx, mx.cpu(), _mlp(mx, False), args, {}))
    t1 = _step(_bind(mt, mt.cpu(), _mlp(mt, False), args, {}))
    _close(t1, j1, F32)


def _tied(pkg):
    with pkg.symbol.NameManager():
        x = pkg.sym.Variable("data")
        a = pkg.sym.FullyConnected(x, num_hidden=5, name="a", no_bias=True)
        b = pkg.sym.FullyConnected(a, num_hidden=5, name="b", no_bias=True)
        return pkg.sym.sum(b * b)


def _shared_grads(pkg, ctx, args, req):
    sym = _tied(pkg)
    a = {n: pkg.nd.array(v, ctx=ctx) for n, v in args.items()}
    buf = pkg.nd.ones((5, 5), ctx=ctx)
    gd = pkg.nd.zeros((3, 5), ctx=ctx)
    ex = sym.bind(ctx, a, args_grad={"data": gd, "a_weight": buf,
                                     "b_weight": buf}, grad_req=req)
    ex.forward(is_train=True)
    ex.backward()
    return buf.asnumpy(), gd.asnumpy()


@pytest.mark.parametrize("req", ["write", "add"])
def test_shared_gradient_buffer_sums_against_jax(req):
    r = _rng("tied" + req)
    args = {"data": r.standard_normal((3, 5)).astype(np.float32),
            "a_weight": r.standard_normal((5, 5)).astype(np.float32) * 0.5,
            "b_weight": r.standard_normal((5, 5)).astype(np.float32) * 0.5}
    j = _shared_grads(mx, mx.cpu(), args, req)
    t = _shared_grads(mt, mt.cpu(), args, req)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, **F32)


def test_grad_req_add_and_backward_twice():
    args, aux = _values(_resnet(mx, jmodels), RES_SHAPES, "twice",
                        ints={"softmax_label": 4})
    res = {}
    for req in ("write", "add"):
        for pkg, ctx, models in ((mx, mx.cpu(), jmodels),
                                 (mt, mt.cpu(), tmodels)):
            ex = _bind(pkg, ctx, _resnet(pkg, models), args, aux,
                       grad_req=req, no_grad=("softmax_label",))
            ex.forward(is_train=True)
            ex.backward()
            first = {n: g.asnumpy() for n, g in ex.grad_dict.items()}
            ex.backward()
            res[(req, pkg.__name__)] = (first, {
                n: g.asnumpy() for n, g in ex.grad_dict.items()},
                {n: a.asnumpy() for n, a in ex.aux_dict.items()})
    tw, ta = res[("write", "mxnet_tpu_torch")], res[("add", "mxnet_tpu_torch")]
    for n, g in tw[0].items():
        np.testing.assert_array_equal(tw[1][n], g)     # write twice: same
        np.testing.assert_array_equal(ta[1][n], 2 * g)  # add twice: double
    # the aux states were updated once, by the forward
    for n, a in tw[2].items():
        np.testing.assert_array_equal(ta[2][n], a)
    for key in (("write", "mxnet_tpu"), ("add", "mxnet_tpu")):
        port = res[(key[0], "mxnet_tpu_torch")]
        for got, want in zip(port, res[key]):
            for n in want:
                _allclose(got[n], want[n], NET, n)


def test_reshape_shares_parameters_against_jax():
    args, _ = _values(_mlp(mx), MLP_SHAPES, "reshape",
                      ints={"softmax_label": 3})
    outs = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        ex = _bind(pkg, ctx, _mlp(pkg), args, {}, no_grad=("softmax_label",))
        small = ex.reshape(data=(2, 5), softmax_label=(2,))
        assert small.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
        assert small.arg_dict["data"].shape == (2, 5)
        small.forward(data=pkg.nd.array(args["data"][:2], ctx=ctx),
                      softmax_label=pkg.nd.array(args["softmax_label"][:2],
                                                 ctx=ctx))
        outs.append(small.outputs[0].asnumpy())
        with pytest.raises(pkg.MXNetError, match="allow_up_sizing"):
            ex.reshape(data=(8, 5), softmax_label=(8,))
        with pytest.raises(pkg.MXNetError, match="partial_shaping"):
            ex.reshape(allow_up_sizing=True, data=(4, 7))
    np.testing.assert_allclose(outs[1], outs[0], **F32)


def test_monitor_callback_against_jax():
    args, _ = _values(_mlp(mx), MLP_SHAPES, "monitor",
                      ints={"softmax_label": 3})
    seen = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        got = []
        ex = _bind(pkg, ctx, _mlp(pkg), args, {}, no_grad=("softmax_label",))
        ex.set_monitor_callback(lambda n, a: got.append((n, a.asnumpy())))
        ex.forward(is_train=False)
        seen.append(got)
    assert [n for n, _ in seen[1]] == [n for n, _ in seen[0]]
    for (_, t), (_, j) in zip(seen[1], seen[0]):
        np.testing.assert_allclose(t, j, **F32)


def test_copy_params_from_copies():
    ex = _mlp(mt).simple_bind(mt.cpu(), **MLP_SHAPES)
    src = mt.nd.array(np.ones((8, 5), np.float32), ctx=mt.cpu())
    ex.copy_params_from({"fc1_weight": src})
    assert ex.arg_dict["fc1_weight"].data.data_ptr() != src.data.data_ptr()
    np.testing.assert_array_equal(ex.arg_dict["fc1_weight"].asnumpy(), 1.0)
    with pytest.raises(MXNetError, match="not an argument"):
        ex.copy_params_from({"nope": src})
    ex.copy_params_from({"nope": src}, allow_extra_params=True)


def test_errors_match_jax():
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        ex = _mlp(pkg).simple_bind(ctx, **MLP_SHAPES)
        with pytest.raises(pkg.MXNetError, match="unknown argument"):
            ex.forward(bogus=pkg.nd.zeros((1,), ctx=ctx))
        with pytest.raises(pkg.MXNetError, match="shape"):
            _mlp(pkg).simple_bind(ctx)
        with pytest.raises(pkg.MXNetError, match="before backward"):
            _mlp(pkg).simple_bind(ctx, **MLP_SHAPES).backward()
        ex.forward(is_train=False)
        with pytest.raises(pkg.MXNetError, match="is_train=False"):
            ex.backward()
        with pytest.raises(pkg.MXNetError, match="missing array"):
            _mlp(pkg).bind(ctx, {"data": pkg.nd.zeros((4, 5), ctx=ctx)})


def test_options_not_ported_raise():
    sym = _mlp(mt)
    # a legacy Context group2ctx binds (recorded, computed on the bind
    # device, as in the JAX package); misuse still raises
    lex = sym.simple_bind(mt.cpu(), group2ctx={"g": mt.cpu(1)},
                          **MLP_SHAPES)
    assert lex._placement is None and lex._group2ctx == {"g": mt.cpu(1)}
    with pytest.raises(MXNetError, match="group2ctx"):
        sym.simple_bind(mt.cpu(), group2ctx={"g": 1}, **MLP_SHAPES)
    ex = sym.simple_bind(mt.cpu(), **MLP_SHAPES)
    with pytest.raises(MXNetError, match="shape"):
        ex.forward(data=np.zeros((2, 5), np.float32))
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA is not available"):
            sym.simple_bind(mt.gpu(0), **MLP_SHAPES)
        with pytest.raises(MXNetError, match="shared_exec"):
            sym.simple_bind(mt.gpu(0), shared_exec=ex, **MLP_SHAPES)


def _typed(pkg):
    with pkg.symbol.NameManager():
        d = pkg.sym.Variable("data")
        ids = pkg.sym.Variable("ids")
        e = pkg.sym.Embedding(ids, input_dim=10, output_dim=4, name="emb")
        f = pkg.sym.FullyConnected(d, num_hidden=4, name="fc")
        c = pkg.sym.Cast(f, dtype="float16", name="cast")
        return pkg.sym.Group([pkg.sym.SoftmaxOutput(f + pkg.sym.sum(e, axis=1),
                                                    name="sm"), c])


@pytest.mark.parametrize("kw", [dict(data="float32", ids="int32"),
                                dict(data="float16"), dict(ids="int32")])
def test_infer_type_against_jax(kw):
    j, t = _typed(mx), _typed(mt)
    assert t.infer_type(**kw) == j.infer_type(**kw)
    assert t.infer_type_partial(**kw) == j.infer_type_partial(**kw)


def test_simple_bind_types_the_parameters_against_jax():
    shapes = dict(data=(2, 3), ids=(2, 5), sm_label=(2,))
    types = dict(data="float16", ids="int32", sm_label="int32")
    j = _typed(mx).simple_bind(mx.cpu(), type_dict=types, **shapes)
    t = _typed(mt).simple_bind(mt.cpu(), type_dict=types, **shapes)
    for n in j.arg_names:
        assert t.arg_dict[n].dtype == j.arg_dict[n].dtype, n
    assert sorted(t.grad_dict) == sorted(j.grad_dict)


def test_infer_shape_partial_against_jax():
    j, t = _mlp(mx), _mlp(mt)
    assert t.infer_shape_partial(data=(4, 5)) == j.infer_shape_partial(
        data=(4, 5))
    assert t.infer_shape_partial() == j.infer_shape_partial()


def test_compose_children_and_attrs_against_jax():
    out = []
    for pkg in (mx, mt):
        with pkg.symbol.NameManager():
            net = pkg.sym.FullyConnected(pkg.sym.Variable("x"), num_hidden=3,
                                         name="fc")
            pre = pkg.sym.Activation(pkg.sym.Variable("data"),
                                     act_type="tanh", name="pre")
            composed = net(x=pre, name="fc2")
            positional = net(pre)
            kids = composed.get_children()
            v = pkg.sym.Variable("v", attr={"mood": "calm"}, lr_mult=2.0)
        out.append((composed.tojson(), positional.list_arguments(),
                    kids.list_outputs(), net.list_arguments(),
                    v.attr("mood"), v.list_attr()))
        with pytest.raises(pkg.MXNetError, match="not an argument"):
            net(nope=pre)
    assert out[1] == out[0]


def test_eval_against_jax():
    r = _rng("eval")
    a = r.standard_normal((2, 3)).astype(np.float32)
    b = r.standard_normal((2, 3)).astype(np.float32)
    res = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        x, y = pkg.sym.Variable("x"), pkg.sym.Variable("y")
        outs = (x * y + 1).eval(ctx=ctx, x=pkg.nd.array(a, ctx=ctx),
                                y=pkg.nd.array(b, ctx=ctx))
        res.append(outs[0].asnumpy())
    np.testing.assert_allclose(res[1], res[0], **F32)


def test_sampler_nodes_in_a_bound_symbol():
    """Ops without array inputs land on the executor's device and draw a
    new sample each forward (the numbers differ from the JAX package's,
    the shapes and ranges do not)."""
    outs = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        x = pkg.sym.Variable("x")
        s = x + pkg.sym._random_uniform(shape=(2, 3), low=1.0, high=2.0)
        ex = s.bind(ctx, {"x": pkg.nd.zeros((2, 3), ctx=ctx)})
        a = ex.forward()[0].asnumpy()
        b = ex.forward()[0].asnumpy()
        assert a.shape == (2, 3) and ((a >= 1) & (a < 2)).all()
        assert not np.array_equal(a, b)
        outs.append(a)
    assert outs[0].dtype == outs[1].dtype
