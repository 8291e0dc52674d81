"""The port's small modules against the JAX package's on the CPU:
``visualization`` (``mt.viz``), ``test_utils``, ``initialize`` and
``metric.Torch``/``metric.Caffe``.

- ``viz.print_summary`` prints the JAX package's table, character for
  character, for the same symbol and shapes; ``plot_network`` draws the
  same graph source where the graphviz package is installed and raises in
  both where it is not.
- ``test_utils``: every public function on the port's ``nd`` and
  ``Executor`` against the JAX package's on the same numpy values (float32
  ``rtol=1e-5, atol=1e-6`` where they compute; the checkers must pass on a
  right gradient and fail on a wrong one). ``check_consistency`` compares
  two CPU contexts here (the card test compares the CPU with ``cuda:0``).
  ``assert_no_retrace`` passes a clean block and fails a block with a
  retrace in both packages, with the same message text.
- ``initialize``: the faulthandler dump is on after import, and
  ``MXNET_USE_SIGNAL_HANDLER=0`` leaves it off.
- ``metric.Torch`` and ``metric.Caffe`` average the raw outputs under
  their own names, as the JAX package's; ``metric.create("torch")`` and
  ``("caffe")`` raise ``ValueError`` in both, since neither factory lists
  them.
"""
import contextlib
import faulthandler
import io

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import test_utils as jtu
from mxnet_tpu_torch import initialize as tinit
from mxnet_tpu_torch import test_utils as ttu

RTOL, ATOL = 1e-5, 1e-6


def _lenet(pkg):
    s = pkg.sym
    x = s.Convolution(s.Variable("data"), kernel=(5, 5), num_filter=6,
                      name="conv1")
    x = s.Activation(x, act_type="tanh", name="tanh1")
    x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool1")
    # every node named: an automatic name counts the package's earlier
    # symbols, which differ with the tests run before
    x = s.FullyConnected(s.Flatten(x, name="flat"), num_hidden=10,
                         name="fc1")
    return s.SoftmaxOutput(x, name="softmax")


def _printed(pkg, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pkg.viz.print_summary(*args, **kw)
    return out.getvalue()


@pytest.mark.parametrize("shape", [None, {"data": (2, 1, 28, 28)}])
def test_print_summary_prints_the_jax_table(shape):
    got = _printed(mt, _lenet(mt), shape=shape)
    want = _printed(mx, _lenet(mx), shape=shape)
    assert got == want
    assert "conv1(Convolution)" in got and "Total params" in got
    if shape:
        assert "(2, 6, 24, 24)" in got


def test_plot_network_draws_the_jax_graph_or_raises_in_both():
    """With the graphviz package both draw the same graph source; without
    it both raise ``MXNetError``."""
    try:
        import graphviz  # noqa: F401
    except ImportError:
        for pkg in (mx, mt):
            with pytest.raises(pkg.MXNetError, match="graphviz"):
                pkg.viz.plot_network(_lenet(pkg))
    else:
        got = mt.viz.plot_network(_lenet(mt), title="lenet").source
        assert got == mx.viz.plot_network(_lenet(mx), title="lenet").source
        assert "conv1_weight" not in got and "pool1" in got
    for pkg in (mx, mt):
        with pytest.raises(TypeError):
            pkg.viz.print_summary("not a symbol")


def _fc_tanh(pkg):
    s = pkg.sym
    return s.Activation(s.FullyConnected(s.Variable("x"), num_hidden=3,
                                         name="fc"), act_type="tanh")


def _location(seed=0):
    r = np.random.default_rng(seed)
    return {"x": r.standard_normal((4, 5)).astype(np.float32),
            "fc_weight": r.standard_normal((3, 5)).astype(np.float32),
            "fc_bias": r.standard_normal((3,)).astype(np.float32)}


def test_numpy_helpers_match():
    r = np.random.default_rng(1)
    a = r.standard_normal((3, 4, 5)).astype(np.float32)
    b = a * np.float32(1 + 1e-6)
    for axis, keep in ((1, True), ((0, 2), False), (None, True)):
        np.testing.assert_array_equal(
            ttu.np_reduce(a, axis, keep, np.sum),
            jtu.np_reduce(a, axis, keep, np.sum))
    assert ttu.same(a, a.copy()) and not ttu.same(a, b)
    assert ttu.reldiff(a, b) == jtu.reldiff(a, b)
    assert ttu.reldiff(a, a) == 0
    assert ttu.almost_equal(a, b) == jtu.almost_equal(a, b)
    ttu.assert_almost_equal(mt.nd.array(a, ctx=mt.cpu()), b)
    for mod in (ttu, jtu):
        with pytest.raises(AssertionError, match="Location of maximum"):
            mod.assert_almost_equal(a, a + 1.0, names=("x", "y"))


def test_random_helpers_and_default_context():
    for shape, n in ((ttu.rand_shape_2d(3, 4), 2),
                     (ttu.rand_shape_3d(2, 3, 4), 3)):
        assert len(shape) == n and all(d >= 1 for d in shape)
    assert ttu.rand_shape_2d(3, 4)[0] <= 3
    x = ttu.rand_ndarray((6, 7), ctx=mt.cpu(), scale=0.5)
    assert x.shape == (6, 7) and np.abs(x.asnumpy()).max() <= 0.5
    before = ttu.default_context()
    try:
        ttu.set_default_context(mt.cpu(3))
        assert ttu.default_context() == mt.cpu(3)
        assert mt.current_context() == mt.cpu(3)
    finally:
        ttu.set_default_context(before)


def test_simple_forward_and_symbolic_checks_match():
    loc = _location()
    want = jtu.simple_forward(_fc_tanh(mx), ctx=mx.cpu(), **loc)
    got = ttu.simple_forward(_fc_tanh(mt), ctx=mt.cpu(), **loc)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ttu.check_symbolic_forward(_fc_tanh(mt), loc, [want], ctx=mt.cpu(),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(AssertionError):
        ttu.check_symbolic_forward(_fc_tanh(mt), loc, [want + 0.1],
                                   ctx=mt.cpu())
    # expected gradients from the JAX package's executor
    cot = np.random.default_rng(2).standard_normal(want.shape).astype(
        np.float32)
    jgrads = jtu.check_symbolic_backward(
        _fc_tanh(mx), loc, [cot], {}, ctx=mx.cpu())
    expected = dict(zip(_fc_tanh(mx).list_arguments(),
                        [g.asnumpy() for g in jgrads]))
    ttu.check_symbolic_backward(_fc_tanh(mt), loc, [cot], expected,
                                ctx=mt.cpu(), rtol=RTOL, atol=ATOL)
    with pytest.raises(AssertionError):
        ttu.check_symbolic_backward(_fc_tanh(mt), loc, [cot * 2], expected,
                                    ctx=mt.cpu(), rtol=RTOL, atol=ATOL)


def test_gradient_checkers_pass_a_right_gradient_and_fail_a_wrong_one():
    loc = _location(3)
    ttu.check_numeric_gradient(_fc_tanh(mt), loc, ctx=mt.cpu(),
                               numeric_eps=1e-2, rtol=2e-2)
    exe = _fc_tanh(mt).bind(mt.cpu(), {k: mt.nd.array(v, ctx=mt.cpu())
                                       for k, v in loc.items()})
    num = ttu.numeric_grad(exe, {"x": exe.arg_dict["x"]}, eps=1e-2)["x"]
    y = np.tanh(loc["x"] @ loc["fc_weight"].T + loc["fc_bias"])
    np.testing.assert_allclose(num, (1 - y * y) @ loc["fc_weight"],
                               rtol=2e-2, atol=1e-3)
    # a head whose backward is not the forward's derivative
    s = mt.sym
    wrong = s.MakeLoss(s.FullyConnected(s.Variable("x"), num_hidden=3,
                                        name="fc"), grad_scale=3.0)
    with pytest.raises(AssertionError, match="NUMERICAL_x"):
        ttu.check_numeric_gradient(wrong, loc, ctx=mt.cpu(),
                                   numeric_eps=1e-2, rtol=2e-2)


def test_check_consistency_over_two_contexts():
    spec = {"x": (4, 5)}
    out = ttu.check_consistency(_fc_tanh(mt), [
        dict(ctx=mt.cpu(0), **spec), dict(ctx=mt.cpu(1), **spec)])
    assert len(out) == 2
    np.testing.assert_array_equal(out[0][0], out[1][0])


def test_assert_no_retrace_names_its_roadmap_item():
    """Once a stub that raised naming ROADMAP A.12 (the name is kept): the
    ported helper passes a clean block, and fails a block in which a
    watcher recorded a retrace with the JAX package's message text,
    character for character."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import test_utils as jtu, tracecheck as jtc
    from mxnet_tpu_torch import tracecheck as ttc
    x4 = np.ones((4,), np.float32)
    x7 = np.ones((7,), np.float32)
    msgs = {}
    f = jax.jit(lambda x: x * 2.0)
    for pkg, tu, tc, arr, fn in ((mx, jtu, jtc, jnp.asarray, f),
                                 (mt, ttu, ttc, torch.from_numpy, None)):
        w = tc.TraceWatcher("toy")
        n0 = len(tc.RETRACE_EVENTS)

        def dispatch(x):
            x = arr(x)
            if fn is not None:
                fn(x)          # the JAX package watches its jit cache
            w.after_call("k", fn, tc.signature((x,)))
        try:
            dispatch(x4)
            with tu.assert_no_retrace():
                dispatch(x4)
            with pytest.raises(AssertionError) as ei:
                with tu.assert_no_retrace(msg="toy"):
                    dispatch(x7)
            msgs[pkg] = str(ei.value)
        finally:
            del tc.RETRACE_EVENTS[n0:]
            pkg.guard.TRAINING_HEALTH.reset()
    assert msgs[mt] == msgs[mx]
    assert "shape (4,) -> (7,)" in msgs[mt]


def test_initialize_installs_the_crash_dump(monkeypatch):
    was = faulthandler.is_enabled()
    try:
        faulthandler.disable()
        monkeypatch.setenv("MXNET_USE_SIGNAL_HANDLER", "0")
        tinit.install()
        assert not faulthandler.is_enabled()
        monkeypatch.delenv("MXNET_USE_SIGNAL_HANDLER")
        tinit.install()
        assert faulthandler.is_enabled()
    finally:
        if was:
            faulthandler.enable()
        else:
            faulthandler.disable()


@pytest.mark.parametrize("name", ["Torch", "Caffe"])
def test_torch_and_caffe_metrics_match(name):
    r = np.random.default_rng(4)
    preds = [r.standard_normal((3, 2)).astype(np.float32) for _ in range(2)]
    got, want = getattr(mt.metric, name)(), getattr(mx.metric, name)()
    for p in preds:
        got.update(None, [mt.nd.array(p, ctx=mt.cpu())])
        want.update(None, [mx.nd.array(p)])
    assert got.get()[0] == want.get()[0] == name.lower()
    np.testing.assert_allclose(got.get()[1], want.get()[1], rtol=RTOL)
    assert isinstance(got, mt.metric.Loss)
    for pkg in (mx, mt):
        with pytest.raises(ValueError):
            pkg.metric.create(name.lower())
