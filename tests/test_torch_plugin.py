"""``plugin.torch_module`` of the PyTorch port against the JAX package's:
``TorchModule`` and ``TorchCriterion`` wrapping copies of one torch module
(same weights), on the same numpy inputs, imperative, symbolic (bind,
forward, backward with head gradients) and inside a ``Module`` training
step. The JAX package's op runs the module on host copies; the port's on
the op's own tensors (here CPU tensors, so the same torch kernels run in
both).

Tolerance: forward outputs and input gradients within ``rtol=1e-6``
(the same torch module on the same CPU values; the JAX side passes them
through numpy and back); the Module step's parameters and outputs within
``rtol=1e-6, atol=1e-7`` (XLA:CPU and torch sum the FullyConnected layer's
products in their own orders).
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn as tnn

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.plugin import torch_module as jplug
from mxnet_tpu_torch.plugin import torch_module as tplug

RTOL = 1e-6
STEP = dict(rtol=1e-6, atol=1e-7)


def _linear(seed=0):
    torch.manual_seed(seed)
    return tnn.Sequential(tnn.Linear(4, 6), tnn.Tanh(), tnn.Linear(6, 3))


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def pair():
    m = _linear()
    return jplug.TorchModule(copy.deepcopy(m)), tplug.TorchModule(
        copy.deepcopy(m))


def test_torch_module_imperative_against_jax(pair):
    jop, top = pair
    x = _x(1, (5, 4))
    want = jop(mx.nd.array(x)).asnumpy()
    got = top(mt.nd.array(x, ctx=mt.cpu()))
    assert got.context == mt.cpu()
    np.testing.assert_allclose(got.asnumpy(), want, rtol=RTOL)


def test_torch_module_symbolic_gradient_against_jax(pair):
    jop, top = pair
    x, head = _x(2, (5, 4)), _x(3, (5, 3))
    outs = {}
    for pkg, op in ((mx, jop), (mt, top)):
        ctx = pkg.cpu()
        s = op.get_symbol(pkg.sym.Variable("data"), name="torch")
        g = pkg.nd.zeros((5, 4), ctx=ctx)
        ex = s.bind(ctx, {"data": pkg.nd.array(x, ctx=ctx)},
                    args_grad={"data": g})
        y = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=pkg.nd.array(head, ctx=ctx))
        outs[pkg.__name__] = (y, g.asnumpy())
    (jy, jg), (ty, tg) = outs["mxnet_tpu"], outs["mxnet_tpu_torch"]
    np.testing.assert_allclose(ty, jy, rtol=RTOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL)
    # the input gradient is head @ J, J from torch's autograd
    xt = torch.from_numpy(x).requires_grad_(True)
    _linear()(xt).backward(torch.from_numpy(head))
    np.testing.assert_allclose(tg, xt.grad.numpy(), rtol=RTOL)


def test_torch_criterion_against_jax():
    x, t = _x(4, (6, 3)), _x(5, (6, 3))
    crits = {"jax": jplug.TorchCriterion(tnn.MSELoss()),
             "torch": tplug.TorchCriterion(tnn.MSELoss())}
    want = crits["jax"](mx.nd.array(x), mx.nd.array(t)).asnumpy()
    got = crits["torch"](mt.nd.array(x, ctx=mt.cpu()),
                         mt.nd.array(t, ctx=mt.cpu())).asnumpy()
    assert got.shape == want.shape == (1,)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    grads = {}
    for name, pkg in (("jax", mx), ("torch", mt)):
        ctx = pkg.cpu()
        s = pkg.sym.Custom(pkg.sym.Variable("data"),
                           pkg.sym.Variable("label"),
                           op_type=crits[name]._reg_name, name="crit")
        gx, gt = pkg.nd.zeros(x.shape, ctx=ctx), pkg.nd.zeros(t.shape,
                                                              ctx=ctx)
        ex = s.bind(ctx, {"data": pkg.nd.array(x, ctx=ctx),
                          "label": pkg.nd.array(t, ctx=ctx)},
                    args_grad={"data": gx, "label": gt})
        ex.forward(is_train=True)
        ex.backward()
        grads[name] = (gx.asnumpy(), gt.asnumpy())
    np.testing.assert_allclose(grads["torch"][0], grads["jax"][0],
                               rtol=RTOL)
    np.testing.assert_allclose(grads["torch"][0], 2 * (x - t) / x.size,
                               rtol=RTOL)
    # the label's gradient stays zero (TorchCriterion's contract)
    assert not grads["torch"][1].any() and not grads["jax"][1].any()


def test_torch_module_inside_a_module_step_against_jax():
    m = _linear(7)
    x = _x(8, (8, 4))
    y = (np.arange(8) % 3).astype(np.float32)
    fc_w, fc_b = _x(9, (3, 3)) * 0.5, np.zeros(3, np.float32)
    got = {}
    for pkg, plug in ((mx, jplug), (mt, tplug)):
        op = plug.TorchModule(copy.deepcopy(m))
        net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            op.get_symbol(pkg.sym.Variable("data"), name="torch"),
            num_hidden=3, name="fc"), name="softmax")
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (8, 4))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(arg_params={
            "fc_weight": pkg.nd.array(fc_w, ctx=pkg.cpu()),
            "fc_bias": pkg.nd.array(fc_b, ctx=pkg.cpu())})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                 [pkg.nd.array(y, ctx=pkg.cpu())])
        mod.forward(batch, is_train=True)
        out = mod.get_outputs()[0].asnumpy()
        mod.backward()
        mod.update()
        args, _ = mod.get_params()
        got[pkg.__name__] = (out, {n: v.asnumpy() for n, v in args.items()})
    (jo, jp), (to, tp) = got["mxnet_tpu"], got["mxnet_tpu_torch"]
    np.testing.assert_allclose(to, jo, **STEP)
    assert sorted(tp) == sorted(jp) == ["fc_bias", "fc_weight"]
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **STEP)
    assert not np.allclose(tp["fc_weight"], fc_w)     # the step moved it


def test_module_parameters_follow_the_op_to_its_device():
    """The wrapped module's parameters move to the op's device at first
    use there; the op runs on that device's tensors (no host copy)."""
    lin = tnn.Linear(4, 3)
    op = tplug.TorchModule(lin)
    seen = []
    lin.register_forward_hook(lambda mod, ins, out: seen.append(
        (ins[0].device, out.device)))
    y = op(mt.nd.array(_x(10, (2, 4)), ctx=mt.cpu()))
    assert y.context == mt.cpu()
    # infer_shape's probe and the forward, both on the op's device
    assert set(seen) == {(torch.device("cpu"), torch.device("cpu"))}
    assert next(lin.parameters()).device == torch.device("cpu")
    # a device other than the parameters' moves them (the card test moves
    # them to cuda:0)
    assert tplug._on(lin, torch.device("meta")).weight.device.type == "meta"
