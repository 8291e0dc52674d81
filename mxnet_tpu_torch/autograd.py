"""Imperative autograd.

Counterpart of ``mxnet_tpu/autograd.py`` (ref: src/ndarray/autograd.{h,cc},
python/mxnet/contrib/autograd.py). While recording, every imperative op
(``ndarray.invoke``) appends an entry to a tape: the op, its attributes,
the tensors it read and the ids of the arrays it made. ``compute_gradient``
replays the tape under ``torch.enable_grad`` from the marked variables'
current values and takes ``torch.autograd.grad`` of the heads, as the JAX
package replays it as a pure function under ``jax.vjp``.

Recording runs the ops without building a torch graph, and the tape holds
the tensors the ops read. NDArray assignment rebinds its tensor rather than
writing into it (``ndarray.py``), so a later ``x += 1`` or ``x[:] = v`` on
an input that is not a marked variable does not change the gradient; a
marked variable is read at ``compute_gradient`` time, as in the JAX
package. Ops that draw random numbers replay from their generator's state
at record time.

API: ``train_section``/``test_section`` (``record``/``pause``),
``is_recording``, ``is_training``, ``set_is_training``,
``mark_variables``, ``compute_gradient``/``backward``, ``grad_and_loss``,
``grad``.
"""
from __future__ import annotations

import functools
import threading

import torch

from .base import MXNetError
from .ops.registry import OpContext

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        _state.tape = []
        # id(NDArray) -> (variable, gradient NDArray, grad_req)
        _state.marked = {}
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_is_training(train_mode):
    """Set the training flag; returns the previous one."""
    prev = _st().training
    _st().training = bool(train_mode)
    return prev


class _RecordingScope(object):
    def __init__(self, train_mode):
        self._train = train_mode

    def __enter__(self):
        s = _st()
        self._prev_rec, self._prev_train = s.recording, s.training
        s.recording, s.training = True, self._train
        return self

    def __exit__(self, *a):
        s = _st()
        s.recording, s.training = self._prev_rec, self._prev_train


def train_section():
    """``with autograd.train_section():`` records ops in training mode."""
    return _RecordingScope(True)


def test_section():
    """``with autograd.test_section():`` records ops in inference mode."""
    return _RecordingScope(False)


record = train_section
pause = test_section


class _TapeEntry(object):
    __slots__ = ("opdef", "attrs", "input_ids", "input_vals", "output_ids",
                 "aux_vals", "rng", "is_train", "output_refs")

    def __init__(self, opdef, attrs, input_ids, input_vals, output_ids,
                 aux_vals, rng, is_train, output_refs):
        self.opdef = opdef
        self.attrs = attrs
        self.input_ids = input_ids
        self.input_vals = input_vals
        self.output_ids = output_ids
        self.aux_vals = aux_vals
        self.rng = rng              # (device, generator state or None)
        self.is_train = is_train
        # keep the recorded outputs alive, so their ids (the tape's keys)
        # are not reused while the tape lives
        self.output_refs = output_refs


def _record(opdef, attrs, nd_inputs, in_vals, nd_outputs, aux_vals, rng,
            is_train):
    """Called by ``ndarray.invoke`` for every op while recording."""
    from .ndarray import NDArray
    _st().tape.append(_TapeEntry(
        opdef, attrs,
        [id(x) if isinstance(x, NDArray) else None for x in nd_inputs],
        list(in_vals), [id(y) for y in nd_outputs], list(aux_vals), rng,
        is_train, list(nd_outputs)))


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to variables (ref: MXAutogradMarkVariables);
    starts a new tape."""
    s = _st()
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        s.marked[id(v)] = (v, g, req)
    s.tape = []


def _replay(tape, env):
    """Run the tape forward over ``env`` (id -> tensor), where the marked
    variables are leaves; records the graph torch differentiates."""
    for e in tape:
        ins = [env.get(iid, dflt) if iid is not None else dflt
               for iid, dflt in zip(e.input_ids, e.input_vals)]
        device, rng_state = e.rng
        gen = None
        if rng_state is not None:
            gen = torch.Generator(device=device)
            gen.set_state(rng_state)
        ctx = OpContext(is_train=e.is_train, rng=gen, device=device)
        outs, _aux = e.opdef.apply(ctx, e.attrs, ins, list(e.aux_vals))
        for oid, val in zip(e.output_ids, outs):
            env[oid] = val


def compute_gradient(outputs, out_grads=None):
    """Gradients of ``outputs`` with respect to every marked variable, into
    their gradient buffers by ``grad_req`` (``write``, ``add``, ``null``)
    (ref: MXAutogradComputeGradient). Returns the heads' values and clears
    the tape."""
    from .ndarray import NDArray, _as_tensor
    s = _st()
    if not s.marked:
        raise MXNetError("compute_gradient: no variables marked")
    marked_ids = list(s.marked.keys())
    leaves = []
    for mid in marked_ids:
        t = s.marked[mid][0].data.detach()
        leaves.append(t.requires_grad_() if t.is_floating_point() else t)
    env = dict(zip(marked_ids, leaves))
    with torch.enable_grad():
        _replay(s.tape, env)
    try:
        heads = [env[id(o)] for o in outputs]
    except KeyError:
        raise MXNetError("compute_gradient: an output was not recorded "
                         "(compute it inside train_section())")
    if out_grads is None:
        cots = [torch.ones_like(h) for h in heads]
    else:
        cots = [_as_tensor(g, h.device).to(h.dtype)
                for g, h in zip(out_grads, heads)]
    diff = [i for i, t in enumerate(leaves) if t.requires_grad]
    pairs = [(h, c) for h, c in zip(heads, cots) if h.requires_grad]
    grads = [None] * len(leaves)
    if diff and pairs:
        got = torch.autograd.grad([h for h, _ in pairs], [leaves[i]
                                                         for i in diff],
                                  [c for _, c in pairs], allow_unused=True)
        for i, g in zip(diff, got):
            grads[i] = g
    for mid, leaf, g in zip(marked_ids, leaves, grads):
        _var, gbuf, req = s.marked[mid]
        if req == "null" or gbuf is None:
            continue
        if g is None:
            g = torch.zeros_like(leaf)
        if req == "add":
            gbuf._set_data(gbuf.data + g)
        else:
            gbuf._set_data(g)
    s.tape = []
    return [NDArray(h.detach()) for h in heads]


backward = compute_gradient


def grad_and_loss(func, argnum=None):
    """Decorate ``func`` into one returning ``(gradients, loss)``
    (ref: contrib/autograd.py grad_and_loss)."""
    from . import ndarray as nd

    @functools.wraps(func)
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            argnums = [argnum] if isinstance(argnum, int) else list(argnum)
            variables = [args[i] for i in argnums]
        for v in variables:
            if not isinstance(v, nd.NDArray):
                raise MXNetError("grad_and_loss: inputs must be NDArray")
        grads = [nd.zeros(v.shape, ctx=v.context, dtype=v.dtype)
                 for v in variables]
        mark_variables(variables, grads)
        with train_section():
            outputs = func(*args)
        compute_gradient(outputs if isinstance(outputs, list)
                         else [outputs])
        return grads, outputs
    return wrapped


def grad(func, argnum=None):
    """Decorate ``func`` into one returning the gradients only."""
    wrapped = grad_and_loss(func, argnum)

    @functools.wraps(func)
    def only_grad(*args):
        return wrapped(*args)[0]
    return only_grad
