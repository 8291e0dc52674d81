"""The rest of ``ops/nn.py`` in the port against the JAX package on the CPU:
log_softmax, LeakyReLU (leaky, elu, prelu, rrelu), InstanceNorm,
Deconvolution, Pad, UpSampling, Crop, the three regression outputs,
SVMOutput and IdentityAttachKLSparseReg.

Each case runs the op through both packages' ``nd`` and ``autograd`` on the
same numpy inputs (from a seed): the outputs, and the gradient of every
float input under a seeded cotangent (a loss head ignores it). Each case's
symbol is saved by the JAX package and loaded by the port, and both bound
executors compute the same outputs; the port's shape inference gives the
shapes the JAX package's does. ``convert`` carries the new parameters
(Deconvolution's weight, InstanceNorm's gamma and beta, prelu's gamma)
across.

Tolerance: float32 ``rtol=1e-5, atol=1e-6``, as ``tests/test_torch_ops.py``.
Deconvolution sums up to 72 products an output and InstanceNorm's gradient
sums over each plane, in other orders than XLA:CPU: those cases take
``rtol=1e-4, atol=1e-5``.

``LeakyReLU(rrelu)`` draws its slopes from the port's generator, not from
a JAX key, so in training the two packages' slopes differ (a kept
divergence). Its inference forward, with the slope ``(lower + upper) / 2``,
is held exactly; in training each slope must lie in ``[lower, upper)`` and
the gradient must equal the drawn slope.
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6
SUM_TOL = dict(rtol=1e-4, atol=1e-5)


def seeded(case_id):
    return np.random.default_rng(zlib.crc32(case_id.encode()))


def run_op(pkg, op, xs, attrs, wrt=(), cots=None, train=True):
    """``op`` through ``pkg``'s ``nd`` on the CPU: its outputs, and the
    gradients of inputs ``wrt`` under the cotangents ``cots`` (ones where
    None), as numpy."""
    ctx = pkg.cpu()
    arrs = [pkg.nd.array(x, ctx=ctx, dtype=x.dtype) for x in xs]
    grads = [pkg.nd.zeros(xs[i].shape, ctx=ctx) for i in wrt]
    if wrt:
        pkg.autograd.mark_variables([arrs[i] for i in wrt], grads)
    if train:
        with pkg.autograd.train_section():
            out = getattr(pkg.nd, op)(*arrs, **attrs)
    else:
        out = getattr(pkg.nd, op)(*arrs, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    if wrt:
        heads = outs[:1]
        cot = [pkg.nd.array(c, ctx=ctx) for c in (cots or [])] or None
        pkg.autograd.compute_gradient(heads, out_grads=cot)
    return [o.asnumpy() for o in outs], [g.asnumpy() for g in grads]


def check_case(op, xs, attrs, wrt, tol=None, train=True):
    """The op's outputs and gradients in both packages, and the port's
    shape inference against the JAX package's."""
    tol = tol or dict(rtol=RTOL, atol=ATOL)
    rng = np.random.default_rng(zlib.crc32(op.encode()))
    shapes = [x.shape for x in xs]
    _, tout, _ = treg.get(op).infer_shape(attrs, shapes)
    cots = [rng.standard_normal(tout[0]).astype(np.float32)]
    want, wgrads = run_op(mx, op, xs, attrs, wrt, cots, train=train)
    got, tgrads = run_op(mt, op, xs, attrs, wrt, cots, train=train)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, **tol)
    for i, g, w in zip(wrt, tgrads, wgrads):
        np.testing.assert_allclose(g, w, err_msg="gradient of input %d" % i,
                                   **tol)
    _, jout, _ = mx.ops.registry.get(op).infer_shape(attrs, shapes)
    assert [tuple(s) for s in tout] == [tuple(s) for s in jout] \
        == [w.shape for w in want]
    return got, tgrads


def json_round_trip(op, names, xs, attrs, tol=None):
    """The JAX package's symbol of ``op`` loaded by the port: the same
    arguments and outputs, bound on the same inputs."""
    tol = tol or dict(rtol=RTOL, atol=ATOL)
    jsym = getattr(mx.sym, op)(*[mx.sym.Variable(n) for n in names],
                               name="node", **attrs)
    tsym = mt.sym.load_json(jsym.tojson())
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    shapes = {n: x.shape for n, x in zip(names, xs)}
    assert tsym.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    jexe = jsym.bind(mx.cpu(), {n: mx.nd.array(x, dtype=x.dtype)
                                for n, x in zip(names, xs)})
    texe = tsym.bind(mt.cpu(), {n: mt.nd.array(x, ctx=mt.cpu(),
                                               dtype=x.dtype)
                                for n, x in zip(names, xs)})
    jexe.forward()
    texe.forward()
    eager, _ = run_op(mx, op, xs, attrs, train=False)
    for t, j, e in zip(texe.outputs, jexe.outputs, eager):
        t, j = t.asnumpy(), j.asnumpy()
        # where the JAX package's compiled executor disagrees with its own
        # nd (XLA contracts ROIPooling's ``i * bin + start`` into a fused
        # multiply-add, which moves a bin edge that lands on an integer),
        # the port, which contracts nothing, gives the nd result
        own = ~np.isclose(j, e, **tol)
        np.testing.assert_allclose(t[own], e[own], **tol)
        np.testing.assert_allclose(t[~own], j[~own], **tol)


def _n(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cases():
    """(id, op, input names, inputs, attrs, gradient inputs, tolerance)."""
    r = seeded("nn_extra")
    img = _n(r, 2, 3, 5, 6)
    lab = r.integers(0, 4, 6).astype(np.float32)
    return [
        ("log_softmax_last", "log_softmax", ["data"], [_n(r, 4, 7)], {},
         [0], None),
        ("log_softmax_axis1", "log_softmax", ["data"], [_n(r, 2, 5, 3)],
         dict(axis=1), [0], None),
        ("leaky", "LeakyReLU", ["data"], [img], dict(act_type="leaky",
                                                     slope=0.1), [0], None),
        ("leaky_default", "LeakyReLU", ["data"], [img], {}, [0], None),
        ("elu", "LeakyReLU", ["data"], [img], dict(act_type="elu",
                                                   slope=0.7), [0], None),
        ("prelu", "LeakyReLU", ["data", "gamma"],
         [img, np.array([0.1, -0.2, 0.3], np.float32)],
         dict(act_type="prelu"), [0, 1], None),
        ("instance_norm", "InstanceNorm", ["data", "gamma", "beta"],
         [img * 3 + 1, _n(r, 3), _n(r, 3)], {}, [0, 1, 2], SUM_TOL),
        ("instance_norm_1d_eps", "InstanceNorm", ["data", "gamma", "beta"],
         [_n(r, 2, 4, 9), _n(r, 4), _n(r, 4)], dict(eps=1e-5), [0, 1, 2],
         SUM_TOL),
        ("deconv_bias", "Deconvolution", ["data", "weight", "bias"],
         [_n(r, 2, 3, 4, 5), _n(r, 3, 4, 3, 3), _n(r, 4)],
         dict(kernel=(3, 3), num_filter=4), [0, 1, 2], SUM_TOL),
        ("deconv_stride_pad_adj", "Deconvolution", ["data", "weight",
                                                    "bias"],
         [_n(r, 1, 2, 5, 4), _n(r, 2, 3, 4, 4), _n(r, 3)],
         dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), adj=(1, 1),
              num_filter=3), [0, 1, 2], SUM_TOL),
        ("deconv_group_dilate_nobias", "Deconvolution", ["data", "weight"],
         [_n(r, 2, 4, 4, 4), _n(r, 4, 3, 3, 3)],
         dict(kernel=(3, 3), dilate=(2, 2), num_group=2, num_filter=6,
              no_bias=True, stride=(2, 1)), [0, 1], SUM_TOL),
        ("deconv_1d", "Deconvolution", ["data", "weight", "bias"],
         [_n(r, 2, 3, 7), _n(r, 3, 2, 5), _n(r, 2)],
         dict(kernel=(5,), stride=(3,), pad=(2,), num_filter=2),
         [0, 1, 2], SUM_TOL),
        ("deconv_fcn_head", "Deconvolution", ["data", "weight"],
         [_n(r, 1, 3, 3, 3), _n(r, 3, 3, 16, 16)],
         dict(kernel=(16, 16), stride=(8, 8), num_filter=3, no_bias=True),
         [0, 1], SUM_TOL),
        ("pad_constant", "Pad", ["data"], [img],
         dict(mode="constant", pad_width=(0, 0, 0, 0, 1, 2, 3, 0),
              constant_value=1.5), [0], None),
        ("pad_edge", "Pad", ["data"], [img],
         dict(mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 0, 3)), [0], None),
        ("pad_reflect", "Pad", ["data"], [img],
         dict(mode="reflect", pad_width=(0, 0, 1, 1, 2, 4, 5, 3)), [0],
         None),
        ("upsampling_one", "UpSampling", ["arg0"], [img],
         dict(scale=2, num_args=1), [0], None),
        ("upsampling_two", "UpSampling", ["arg0", "arg1"],
         [img, _n(r, 2, 2, 6, 7)], dict(scale=3, num_args=2), [0, 1], None),
        ("crop_hw_offset", "Crop", ["data"], [_n(r, 2, 3, 9, 8)],
         dict(h_w=(4, 5), offset=(2, 1)), [0], None),
        ("crop_like_center", "Crop", ["data", "crop_like"],
         [_n(r, 2, 3, 9, 8), _n(r, 2, 1, 4, 3)],
         dict(num_args=2, center_crop=True), [0], None),
        ("crop_like_offset", "Crop", ["data", "crop_like"],
         [_n(r, 1, 2, 10, 10), _n(r, 1, 5, 6, 4)],
         dict(num_args=2, offset=(3, 4)), [0], None),
        ("linear_regression", "LinearRegressionOutput", ["data", "label"],
         [_n(r, 6, 3), _n(r, 6, 3)], dict(grad_scale=0.5), [0], None),
        ("logistic_regression", "LogisticRegressionOutput",
         ["data", "label"], [_n(r, 6, 3), (r.random((6, 3)) > 0.5).astype(
             np.float32)], {}, [0], None),
        ("mae_regression", "MAERegressionOutput", ["data", "label"],
         [_n(r, 6), _n(r, 6)], dict(grad_scale=2.0), [0], None),
        ("svm_l2", "SVMOutput", ["data", "label"], [_n(r, 6, 4), lab],
         dict(margin=1.5, regularization_coefficient=0.5), [0], None),
        ("svm_l1", "SVMOutput", ["data", "label"], [_n(r, 6, 4), lab],
         dict(use_linear=True), [0], None),
        ("identity_kl", "IdentityAttachKLSparseReg", ["data"], [img],
         dict(sparseness_target=0.1, penalty=0.01), [0], None),
    ]


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_and_gradient_match_jax(case):
    _, op, _, xs, attrs, wrt, tol = case
    check_case(op, xs, attrs, wrt, tol)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_symbol_json_round_trip(case):
    _, op, names, xs, attrs, _, tol = case
    json_round_trip(op, names, xs, attrs, tol)


def test_rrelu_inference_is_exact_and_training_draws_in_range():
    x = seeded("rrelu").standard_normal((64, 8, 5, 5)).astype(np.float32)
    attrs = dict(act_type="rrelu", lower_bound=0.1, upper_bound=0.4)
    want, _ = run_op(mx, "LeakyReLU", [x], attrs, train=False)
    got, _ = run_op(mt, "LeakyReLU", [x], attrs, train=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], np.where(x > 0, x, 0.25 * x))
    out, (grad,) = run_op(mt, "LeakyReLU", [x], attrs, wrt=[0])
    neg = x < 0
    slope = out[0][neg] / x[neg]
    assert slope.min() >= 0.1 - 1e-6 and slope.max() < 0.4 + 1e-6
    assert slope.std() > 0.05                      # one slope an element
    np.testing.assert_array_equal(grad[~neg], 1.0)
    np.testing.assert_allclose(grad[neg], slope, rtol=1e-5)
    # the same draw comes back in the gradient's replay, and a second
    # forward draws again
    again, _ = run_op(mt, "LeakyReLU", [x], attrs)
    assert not np.array_equal(again[0], out[0])


def test_upsampling_bilinear_raises_in_both():
    x = np.ones((1, 1, 2, 2), np.float32)
    for pkg in (mx, mt):
        with pytest.raises(pkg.MXNetError, match="not yet supported"):
            pkg.nd.UpSampling(pkg.nd.array(x, ctx=pkg.cpu()), scale=2,
                              num_args=1, sample_type="bilinear")


def test_identity_kl_attaches_no_penalty():
    """The JAX package's IdentityAttachKLSparseReg is the identity in the
    backward too: the gradient is the cotangent."""
    x = seeded("kl").standard_normal((3, 4)).astype(np.float32)
    cot = seeded("kl_cot").standard_normal((3, 4)).astype(np.float32)
    _, (g,) = run_op(mt, "IdentityAttachKLSparseReg", [x],
                     dict(penalty=1.0), [0], [cot])
    np.testing.assert_array_equal(g, cot)


def test_regression_heads_ignore_the_cotangent():
    r = seeded("heads")
    x, y = _n(r, 5, 3), _n(r, 5, 3)
    for cot in (None, [np.full((5, 3), 7.0, np.float32)]):
        _, (g,) = run_op(mt, "LinearRegressionOutput", [x, y], {}, [0], cot)
        np.testing.assert_allclose(g, x - y, rtol=1e-6)


def test_new_parameters_convert_across():
    """The JAX package's Deconvolution weight, InstanceNorm gamma and beta
    and prelu gamma, through ``convert``, give the port's executor the JAX
    executor's outputs, and come back unchanged."""
    def net(pkg):
        s = pkg.sym
        x = s.Deconvolution(s.Variable("data"), kernel=(4, 4), stride=(2, 2),
                            pad=(1, 1), num_filter=4, name="up")
        x = s.InstanceNorm(x, name="inorm")
        return s.LeakyReLU(x, act_type="prelu", name="act")

    r = seeded("convert")
    # InstanceNorm infers no gamma shape in either package: given here
    shapes = dict(data=(2, 3, 5, 5), inorm_gamma=(4,), inorm_beta=(4,))
    jexe = net(mx).simple_bind(mx.cpu(), grad_req="null", **shapes)
    for k, v in jexe.arg_dict.items():
        v[:] = r.standard_normal(v.shape).astype(np.float32)
    arg = {k: v for k, v in jexe.arg_dict.items() if k != "data"}
    assert set(arg) == {"up_weight", "up_bias", "inorm_gamma", "inorm_beta",
                        "act_gamma"}
    targ, _ = convert.from_reference_params(arg, {})
    targ["data"] = torch.tensor(jexe.arg_dict["data"].asnumpy())
    texe = net(mt).bind(mt.cpu(), {k: mt.nd.NDArray(v)
                                   for k, v in targ.items()})
    jexe.forward()
    texe.forward()
    np.testing.assert_allclose(texe.outputs[0].asnumpy(),
                               jexe.outputs[0].asnumpy(), **SUM_TOL)
    back, _ = convert.to_reference_params(targ, {})
    for k in arg:
        np.testing.assert_array_equal(back[k], arg[k].asnumpy())


def test_cuda_tensor_never_runs_on_the_cpu():
    """Each new op computes on its inputs' device: a meta tensor stands in
    for a CUDA one here, and the output stays on it."""
    x = torch.empty((2, 3, 8, 8), device="meta")
    for op, attrs in (("LeakyReLU", {}), ("log_softmax", {}),
                      ("Pad", dict(mode="reflect",
                                   pad_width=(0, 0, 0, 0, 2, 2, 2, 2))),
                      ("UpSampling", dict(scale=2, num_args=1)),
                      ("Crop", dict(h_w=(4, 4)))):
        outs, _ = treg.get(op).apply(treg.OpContext(), attrs, [x], [])
        assert all(o.device.type == "meta" for o in outs), op
