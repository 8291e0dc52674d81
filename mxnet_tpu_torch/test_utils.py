"""Testing utilities (ref: python/mxnet/test_utils.py).

Counterpart of ``mxnet_tpu/test_utils.py`` on the port's ``nd`` and
:class:`~mxnet_tpu_torch.executor.Executor`: finite-difference gradient
checks (ref: test_utils.py check_numeric_gradient), symbolic forward and
backward comparators, and :func:`check_consistency`, which runs one graph
on several contexts (the CPU and ``cuda:0`` on a card) and compares them.
Every array is made on the context the caller names (by default the
current one, which is ``gpu(0)`` unless a ``with cpu():`` block is open).

:class:`assert_no_retrace` fails a block in which ``tracecheck``'s watch
recorded a retrace.
"""
from __future__ import annotations

import numpy as np

from .context import Context, current_context
from .ndarray import NDArray, array, zeros
from .symbol import Symbol
from . import random as _random


def default_context():
    return current_context()


def set_default_context(ctx):
    Context._default_ctx.value = ctx


def rand_shape_2d(dim0=10, dim1=10):
    rng = _random.np_rng()
    return (int(rng.integers(1, dim0 + 1)), int(rng.integers(1, dim1 + 1)))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    rng = _random.np_rng()
    return tuple(int(rng.integers(1, d + 1)) for d in (dim0, dim1, dim2))


def rand_ndarray(shape, ctx=None, scale=1.0):
    rng = _random.np_rng()
    return array(rng.uniform(-scale, scale, shape).astype(np.float32),
                 ctx=ctx)


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """Apply a numpy reduction over an int, a tuple of axes or all of them
    (None)."""
    if isinstance(axis, int):
        axis = [axis]
    else:
        axis = list(axis) if axis is not None else range(len(dat.shape))
    ret = dat
    for i in reversed(sorted(axis)):
        ret = numpy_reduce_func(ret, axis=i)
    if keepdims:
        keepdims_shape = list(dat.shape)
        for i in axis:
            keepdims_shape[i] = 1
        ret = ret.reshape(tuple(keepdims_shape))
    return ret


def same(a, b):
    return np.array_equal(a, b)


def reldiff(a, b):
    diff = np.sum(np.abs(a - b))
    norm = np.sum(np.abs(a)) + np.sum(np.abs(b))
    if diff == 0:
        return 0
    return diff / norm


def almost_equal(a, b, rtol=None, atol=None):
    return np.allclose(a, b, rtol=rtol or 1e-5, atol=atol or 1e-20)


def _np(a):
    return a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    rtol = rtol or 1e-5
    atol = atol or 1e-20
    a, b = _np(a), _np(b)
    if not np.allclose(a, b, rtol=rtol, atol=atol):
        index, rel = _find_max_violation(a, b, rtol, atol)
        raise AssertionError(
            "Items are not equal:\nError %f exceeds tolerance rtol=%f, atol=%f."
            "  Location of maximum error:%s, %s=%f, %s=%f"
            % (rel, rtol, atol, str(index), names[0], a[index], names[1],
               b[index]))


def _find_max_violation(a, b, rtol, atol):
    diff = np.abs(a - b)
    violation = diff / (atol + rtol * np.abs(b) + 1e-20)
    index = np.unravel_index(np.argmax(violation), violation.shape)
    return index, violation[index]


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """Forward ``sym`` on numpy ``inputs``; its outputs as numpy (one array
    where it has one output)."""
    ctx = ctx or default_context()
    exe = sym.bind(ctx, args={k: array(v, ctx=ctx) for k, v in inputs.items()})
    exe.forward(is_train=is_train)
    outputs = [o.asnumpy() for o in exe.outputs]
    return outputs[0] if len(outputs) == 1 else outputs


def _parse_location(sym, location, ctx):
    if isinstance(location, dict):
        if set(location.keys()) != set(sym.list_arguments()):
            raise ValueError("Symbol arguments and keys of the given location "
                             "do not match. symbol args:%s, location.keys():%s"
                             % (str(set(sym.list_arguments())),
                                str(set(location.keys()))))
    else:
        location = {k: v for k, v in zip(sym.list_arguments(), location)}
    return {k: (array(v, ctx=ctx) if isinstance(v, np.ndarray) else v)
            for k, v in location.items()}


def _parse_aux_states(sym, aux_states, ctx):
    if aux_states is None:
        return None
    if not isinstance(aux_states, dict):
        aux_states = {k: v for k, v in zip(sym.list_auxiliary_states(),
                                           aux_states)}
    return {k: (array(v, ctx=ctx) if isinstance(v, np.ndarray) else v)
            for k, v in aux_states.items()}


def _sum_outputs(executor, proj=None, is_train=True):
    executor.forward(is_train=is_train)
    if proj is None:
        return sum(np.sum(o.asnumpy()) for o in executor.outputs)
    return sum(np.sum(o.asnumpy() * p)
               for o, p in zip(executor.outputs, proj))


def _central_differences(executor, location_npy, names, eps, proj,
                         use_forward_train):
    """d(sum(outputs * proj))/d(input) for each of ``names`` by central
    differences, writing each perturbed value into the executor."""
    grads = {}
    for k in names:
        old = location_npy[k]
        flat = old.reshape(-1)
        grad = np.zeros(flat.size, dtype=np.float32)
        for i in range(flat.size):
            vals = []
            for sign in (1, -1):
                mod = flat.copy()
                mod[i] += sign * eps
                executor.arg_dict[k][:] = mod.reshape(old.shape)
                vals.append(_sum_outputs(executor, proj, use_forward_train))
            grad[i] = (vals[0] - vals[1]) / (2 * eps)
        executor.arg_dict[k][:] = old
        grads[k] = grad.reshape(old.shape)
    return grads


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """d(sum(outputs))/d(input) for every input of ``location`` (a dict of
    the executor's NDArrays) by central differences."""
    npy = {k: v.asnumpy() for k, v in location.items()}
    return _central_differences(executor, npy, list(location), eps, None,
                                use_forward_train)


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None):
    """The symbol's backward against central differences of
    ``sum(outputs * proj)`` for a random projection ``proj`` (ref:
    test_utils.py check_numeric_gradient)."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    location_npy = {k: v.asnumpy() for k, v in location.items()}
    aux = _parse_aux_states(sym, aux_states, ctx)
    if grad_nodes is None:
        grad_nodes = [k for k in sym.list_arguments()
                      if not k.endswith("label")]
    else:
        grad_nodes = list(grad_nodes)
    _, out_shape, _ = sym.infer_shape(
        **{k: v.shape for k, v in location.items()})
    proj = [_random.np_rng().normal(0, 1, s).astype(np.float32)
            for s in out_shape]
    grad_req = {k: ("write" if k in grad_nodes else "null")
                for k in sym.list_arguments()}
    args_grad = {k: zeros(location[k].shape, ctx=ctx) for k in grad_nodes}
    executor = sym.bind(ctx, args=location, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux)
    executor.forward(is_train=use_forward_train)
    executor.backward(out_grads=[array(p, ctx=ctx) for p in proj])
    symbolic = {k: executor.grad_dict[k].asnumpy() for k in grad_nodes}
    numeric = _central_differences(executor, location_npy, grad_nodes,
                                   numeric_eps, proj, use_forward_train)
    for name in grad_nodes:
        assert_almost_equal(numeric[name], symbolic[name], rtol=rtol,
                            atol=atol or 1e-4,
                            names=("NUMERICAL_%s" % name,
                                   "BACKWARD_%s" % name))


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=None,
                           aux_states=None, ctx=None):
    """The symbol's forward outputs against ``expected`` numpy arrays."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    executor = sym.bind(ctx, args=location,
                        aux_states=_parse_aux_states(sym, aux_states, ctx))
    executor.forward(is_train=False)
    for name, expect, output in zip(sym.list_outputs(), expected,
                                    executor.outputs):
        assert_almost_equal(expect, output.asnumpy(), rtol=rtol,
                            atol=atol or 1e-20,
                            names=("EXPECTED_%s" % name, "FORWARD_%s" % name))
    return executor.outputs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None):
    """The symbol's gradients under ``out_grads`` against ``expected``
    (numpy arrays by argument, as a dict or in argument order)."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    if isinstance(expected, (list, tuple)):
        expected = {k: v for k, v in zip(sym.list_arguments(), expected)}
    args_grad = {k: zeros(v.shape, ctx=ctx) for k, v in location.items()}
    executor = sym.bind(ctx, args=location, args_grad=args_grad,
                        grad_req=grad_req,
                        aux_states=_parse_aux_states(sym, aux_states, ctx))
    executor.forward(is_train=True)
    if isinstance(out_grads, (list, tuple)):
        out_grads = [array(v, ctx=ctx) if isinstance(v, np.ndarray) else v
                     for v in out_grads]
    executor.backward(out_grads)
    grads = {k: v.asnumpy() for k, v in executor.grad_dict.items()}
    for name in expected:
        assert_almost_equal(expected[name], grads[name], rtol=rtol,
                            atol=atol or 1e-20,
                            names=("EXPECTED_%s" % name, "BACKWARD_%s" % name))
    return executor.grad_arrays


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None):
    """One graph on several contexts must agree: ``ctx_list`` holds dicts
    of ``ctx`` (a Context), the input shapes and an optional ``type_dict``;
    each binds with ``simple_bind``, takes the same normal inputs (in the
    data's dtype) and runs forward, and every context's outputs are held
    against the first's (ref: test_utils.py check_consistency)."""
    if tol is None:
        tol = {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
               np.dtype(np.float64): 1e-5}
    assert len(ctx_list) > 1
    if isinstance(sym, Symbol):
        sym = [sym] * len(ctx_list)
    else:
        assert len(sym) == len(ctx_list)
    results = []
    rng = _random.np_rng()
    arg_np = None
    for s, spec in zip(sym, ctx_list):
        spec = dict(spec)
        context = spec.pop("ctx")
        dtype = np.dtype(spec.pop("type_dict", {}).get("data", np.float32))
        exe = s.simple_bind(context, grad_req=grad_req, **spec)
        if arg_np is None:
            arg_np = {k: rng.normal(0, scale, v.shape).astype(np.float32)
                      for k, v in exe.arg_dict.items()}
        for k, v in exe.arg_dict.items():
            v[:] = arg_np[k].astype(dtype)
        exe.forward(is_train=False)
        results.append([o.asnumpy().astype(np.float32) for o in exe.outputs])
    for res in results[1:]:
        for r0, r in zip(results[0], res):
            assert_almost_equal(r0, r, rtol=tol[np.dtype(np.float32)],
                                atol=1e-3)
    return results


class assert_no_retrace(object):
    """Context manager asserting that no watched dispatch key retraces
    inside the block: runs with ``MXTPU_TRACECHECK`` forced on (the
    caller's mode is restored on exit), snapshots the process-global
    ``tracecheck.RETRACE_EVENTS`` on entry, and fails with the differ's
    lines (the argument and the property that changed) for any event
    appended in the block.

    Objects passed in that count their seen signatures (a
    ``tracecheck.TraceWatcher``, ``ts._watcher``) are also pinned by that
    count, which grows at a new key too::

        with assert_no_retrace(ts._watcher):
            for epoch in range(3):
                state, _ = ts.run_steps(state, superbatch)
    """

    def __init__(self, *watched, msg=None):
        self._watched = watched
        self._msg = msg
        self._events0 = 0
        self._sizes0 = ()
        self._prev_mode = None

    def __enter__(self):
        from . import engine, tracecheck
        # signature capture must be live for the differ to have anything to
        # report
        if engine.tracecheck_mode() == "off":
            self._prev_mode = engine.set_tracecheck("warn")
        self._events0 = len(tracecheck.RETRACE_EVENTS)
        self._sizes0 = tuple(self._cache_size(w) for w in self._watched)
        return self

    def __exit__(self, exc_type, exc, tb):
        from . import engine, tracecheck
        if self._prev_mode is not None:
            engine.set_tracecheck(self._prev_mode)
        if exc_type is not None:
            return False
        lines = []
        for ev in tracecheck.RETRACE_EVENTS[self._events0:]:
            lines.append("retrace at %s: %s" % (ev.site, "; ".join(ev.diff)))
        for w, s0 in zip(self._watched, self._sizes0):
            s1 = self._cache_size(w)
            if s0 is not None and s1 is not None and s1 > s0:
                lines.append("signatures of %r grew %d -> %d (re-traced)"
                             % (getattr(w, "name", w), s0, s1))
        if lines:
            prefix = (self._msg + ": ") if self._msg else ""
            raise AssertionError(prefix + "unexpected retrace inside "
                                 "assert_no_retrace block\n  "
                                 + "\n  ".join(lines))
        return False

    @staticmethod
    def _cache_size(w):
        size = getattr(w, "_cache_size", None)
        return size() if callable(size) else None
