"""Fused training step: forward, backward and optimizer update per batch.

Counterpart of ``mxnet_tpu/train_step.py:TrainStep``, the engine under
``Module.fit(steps_per_dispatch=...)`` and ``bench.py``. The JAX package
compiles the step into one donated XLA program; here it runs eagerly on
the card:

- the forward runs the symbol through ``executor._build_graph_runner`` with
  f32 master parameters cast to ``compute_dtype`` inside it, so autograd
  delivers f32 gradients; ``jax.vjp`` with all-ones cotangents becomes
  ``torch.autograd.grad`` with all-ones output gradients;
- buffer donation becomes an in-place update: ``step`` and ``run_steps``
  update the state's tensors and return the same dict, whose keys are the
  JAX package's (``params``, ``aux``, ``opt``, ``step``);
- ``run_steps`` runs K steps in a Python loop, keeps the metric sums on the
  device and reads them back once per dispatch through
  :class:`StepMetrics`.

One divergence from the JAX package: it casts every floating batch input
to ``compute_dtype``, labels included, so bf16 rounds class 257 to 256 and
998 and 999 to 1000 (a class that does not exist). The port casts only the
inputs that are not in ``label_names``.

Not ported yet, and raising when asked for: ``mesh``,
``param_shardings``, ``group2ctx``, ``remat``, ``guard=True``,
``metric_spec`` and ``MXTPU_BF16_STATS``.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .base import MXNetError, env_str
from .context import resolve_device
from .executor import _build_graph_runner
from .initializer import Xavier, InitDesc
from .ops.nn import conv_precision
from . import optimizer as _opt
from .optimizer import Optimizer
from . import random as _random

_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "float64": torch.float64}


def torch_dtype(dtype):
    """A dtype given as a ``torch.dtype``, a name or a numpy dtype -> the
    ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(
        np.dtype(dtype), "name", str(dtype))
    if name not in _TORCH_DTYPES:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _TORCH_DTYPES[name]


class StepMetrics(object):
    """Device-resident metric sums of one ``run_steps`` dispatch, in the
    legacy layout ``[loss_sum, top1_correct, num_samples]``. The first
    property access (or :meth:`fetch`) is the dispatch's one host
    readback."""

    __slots__ = ("device", "_host")

    def __init__(self, device_tensor):
        self.device = device_tensor
        self._host = None

    def _vals(self):
        if self._host is None:
            self._host = self.device.cpu().numpy()
        return self._host

    def fetch(self):
        """Do the host readback now (idempotent); returns self."""
        self._vals()
        return self

    @property
    def fetched(self):
        return self._host is not None

    def values(self):
        v = self._vals()
        return {"loss_sum": float(v[0]), "top1_correct": float(v[1]),
                "num_samples": float(v[2])}

    @property
    def loss_sum(self):
        return float(self._vals()[0])

    @property
    def top1_correct(self):
        return float(self._vals()[1])

    @property
    def num_samples(self):
        return int(round(float(self._vals()[2])))

    @property
    def accuracy(self):
        n = self.num_samples
        return self.top1_correct / n if n else float("nan")

    @property
    def loss_avg(self):
        n = self.num_samples
        return self.loss_sum / n if n else float("nan")

    def __repr__(self):
        return ("StepMetrics(loss_sum=%.6g, top1_correct=%g, num_samples=%d)"
                % (self.loss_sum, self.top1_correct, self.num_samples))


def _metric_step_sums(outs, labels, zero):
    """One step's metric sums (cross-entropy with eps 1e-8, top-1 correct)
    over every (rank-2 output, rank-1 label) pair, positionally; ``None``
    labels skip (ref: the JAX package's ``_metric_step_sums``)."""
    loss = zero
    correct = zero
    for o, lbl in zip(outs, labels):
        if (lbl is not None and o.dim() == 2 and lbl.dim() == 1
                and o.shape[0] == lbl.shape[0]):
            li = lbl.to(torch.int32)
            p = torch.gather(o, 1, li.long()[:, None])[:, 0].float()
            loss = loss + torch.sum(-torch.log(p + 1e-8))
            correct = correct + torch.sum(
                (torch.argmax(o, dim=1).to(torch.int32) == li).float())
    return loss, correct


def _default_slot_sums(outs, labels, batch_size):
    """The legacy packed layout ``(ce_loss, top1_correct, num_samples)``."""
    zero = torch.zeros((), dtype=torch.float32, device=outs[0].device)
    loss, correct = _metric_step_sums(outs, labels, zero)
    return loss, correct, zero + float(batch_size)


class TrainStep(object):
    """Training step over a symbol, on one device.

    state = ``{params, aux, opt, step}``; ``step(state, batch)`` updates it
    in place and returns ``(state, outputs)``. ``optimizer`` is a registry
    name (created with ``learning_rate``/``momentum``/``wd``) or an
    :class:`~mxnet_tpu_torch.optimizer.Optimizer` with a fused update.
    ``device``: where it runs, ``cuda:0`` by default; without CUDA that
    raises (pass ``device="cpu"`` to train on the CPU).
    """

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), optimizer="sgd",
                 learning_rate=0.01, momentum=0.9, wd=0.0, rescale_grad=None,
                 mesh=None, param_shardings=None, dtype=np.float32,
                 compute_dtype=None, remat=False, frozen_param_names=None,
                 group2ctx=None, device=None):
        for name, val in (("mesh", mesh), ("param_shardings", param_shardings),
                          ("group2ctx", group2ctx), ("remat", remat)):
            if val:
                raise MXNetError("TrainStep: %s= is not ported yet" % name)
        if env_str("MXTPU_BF16_STATS").lower() not in ("", "0", "false",
                                                        "off", "no"):
            raise MXNetError("TrainStep: MXTPU_BF16_STATS (bf16 optimizer "
                             "and BatchNorm statistics) is not ported yet")
        self.device = resolve_device(device, "TrainStep")
        self.symbol = symbol
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.param_names = [n for n in self.arg_names
                            if n not in self.data_names + self.label_names]
        self.frozen_param_names = set(frozen_param_names or ())
        if isinstance(optimizer, Optimizer):
            self._opt = optimizer
            # an instance's rescale_grad is authoritative, as the JAX
            # package's (ref: module.py:460-463 warns on 1.0)
            if rescale_grad is None:
                rescale_grad = optimizer.rescale_grad
                if rescale_grad == 1.0:
                    logging.warning(
                        "TrainStep: optimizer instance has rescale_grad=1.0 "
                        "(gradients are batch sums); pass "
                        "rescale_grad=1/batch_size to the optimizer or to "
                        "TrainStep if per-example scaling is intended")
        else:
            kwargs = {"learning_rate": learning_rate, "wd": wd,
                      "sym": symbol}
            if optimizer.lower() == "sgd":
                kwargs["momentum"] = momentum
            self._opt = _opt.create(optimizer, **kwargs)
        if not self._opt.fused_supported:
            raise MXNetError("fused step: optimizer %r has no fused update"
                             % type(self._opt).__name__)
        self.optimizer = optimizer
        self.rescale_grad = rescale_grad
        self.dtype = torch_dtype(dtype)
        if compute_dtype is not None:
            self.compute_dtype = torch_dtype(compute_dtype)
        elif self.dtype != torch.float32:
            # parameters stored in another dtype: inputs are cast to match
            self.compute_dtype = self.dtype
        else:
            self.compute_dtype = None
        self._run, self._nodes = _build_graph_runner(symbol)
        self._needs_rng = any((not n.is_variable) and n.op.needs_rng
                              for n in self._nodes)
        self._base_key = None

    # ------------------------------------------------------------------
    def init(self, data_shapes, label_shapes=None, initializer=None, seed=0):
        """Allocate and initialize the state on the device from the
        inferred shapes. Seeding is scoped: the random module's state is
        restored afterwards."""
        shapes = dict(data_shapes)
        shapes.update(label_shapes or {})
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**shapes)
        shape_of = dict(zip(self.arg_names, arg_shapes))
        aux_shape_of = dict(zip(self.aux_names, aux_shapes))
        initializer = initializer or Xavier()
        attrs = self.symbol.attr_dict()
        saved = _random.get_state()
        _random.seed(seed)
        try:
            def make(name, shape):
                t = torch.zeros(shape, dtype=self.dtype, device=self.device)
                initializer(InitDesc(name, attrs.get(name, {})), t)
                return t
            params = {n: make(n, shape_of[n]) for n in self.param_names}
            aux = {n: make(n, aux_shape_of[n]) for n in self.aux_names}
        finally:
            _random.set_state(saved)
        opt = {n: self._opt.create_fused_state(v) for n, v in params.items()
               if n not in self.frozen_param_names}
        return {"params": params, "aux": aux, "opt": opt,
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    # ------------------------------------------------------------------
    def _to_device(self, batch):
        out = {}
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            out[k] = t.to(self.device)
        return out

    def _next_lr(self):
        # the scheduler clock advances on the host, once per step
        self._opt.num_update += 1
        if self._opt.lr_scheduler is not None:
            return self._opt.lr_scheduler(self._opt.num_update)
        return self._opt.lr

    def _step_key(self, state):
        """The run's rng key: a base drawn once from the random module,
        offset by the state's own step counter (read from the device only
        for graphs with a random op)."""
        if not self._needs_rng:
            return None
        if self._base_key is None:
            self._base_key = _random.randint63()
        return self._base_key + int(state["step"])

    def _step(self, state, batch, lr, batch_size):
        """One forward, backward and in-place update; returns the outputs
        (detached)."""
        params, aux, opt = state["params"], state["aux"], state["opt"]
        updated = [n for n in self.param_names
                   if n not in self.frozen_param_names]
        rescale = (self.rescale_grad if self.rescale_grad is not None
                   else 1.0 / batch_size)
        cdt = self.compute_dtype
        key = self._step_key(state)
        leaves = {n: params[n].detach().requires_grad_(
            n not in self.frozen_param_names) for n in self.param_names}
        with torch.enable_grad(), conv_precision(self.device):
            arg_vals = {k: (v.to(cdt) if cdt is not None
                            and v.is_floating_point()
                            and k not in self.label_names else v)
                        for k, v in batch.items()}
            arg_vals.update({n: (v.to(cdt) if cdt is not None else v)
                             for n, v in leaves.items()})
            outs, aux_up = self._run(arg_vals, aux, key, True)
            grads = torch.autograd.grad(
                outs, [leaves[n] for n in updated],
                grad_outputs=[torch.ones_like(o) for o in outs],
                allow_unused=True)
        with torch.no_grad():
            t = state["step"].float() + 1.0
            wd = self._opt.wd
            for n, g in zip(updated, grads):
                w = params[n]
                g = (torch.zeros_like(w) if g is None else g.to(w.dtype)) \
                    * rescale
                self._opt.fused_update(
                    n, w, g, opt[n], lr * self._opt.lr_mult.get(n, 1.0),
                    wd * self._opt.wd_mult.get(n, 1.0), t)
            for k, v in aux_up.items():
                aux[k].copy_(v)
            state["step"].add_(1)
        return [o.detach() for o in outs]

    def step(self, state, batch, guard=False):
        """One training step. ``batch``: dict name -> array or tensor.
        Returns ``(state, outputs)``; the state's tensors are updated in
        place."""
        if guard:
            raise MXNetError("TrainStep.step: guard=True (the training-"
                             "health sentinels) is not ported yet")
        batch = self._to_device(batch)
        bs = next(iter(batch.values())).shape[0]
        return state, self._step(state, batch, self._next_lr(), bs)

    def run_steps(self, state, superbatch, k=None, guard=False,
                  metric_spec=None):
        """K training steps over a stacked ``(k, batch, ...)`` superbatch.
        Returns ``(state, metrics)``: the state updated in place and a
        :class:`StepMetrics` of the K steps' loss, top-1 and sample sums,
        held on the device until read."""
        if guard:
            raise MXNetError("TrainStep.run_steps: guard=True is not ported "
                             "yet")
        if metric_spec is not None:
            raise MXNetError("TrainStep.run_steps: metric_spec (packed "
                             "metric accumulators) is not ported yet")
        superbatch = self._to_device(superbatch)
        vals = list(superbatch.values())
        if not vals:
            raise MXNetError("run_steps: empty superbatch")
        lead = vals[0].shape[0]
        if k is not None and k != lead:
            raise MXNetError("run_steps: k=%d but superbatch is stacked %d "
                             "deep" % (k, lead))
        k = lead
        if any(v.shape[0] != k or v.dim() < 2 for v in vals):
            raise MXNetError("run_steps: superbatch arrays must share a "
                             "(k, batch, ...) leading shape, got %r"
                             % {n: tuple(v.shape)
                                for n, v in superbatch.items()})
        bs = vals[0].shape[1]
        lrs = [self._next_lr() for _ in range(k)]
        acc = torch.zeros(3, dtype=torch.float32, device=self.device)
        for i in range(k):
            batch = {n: v[i] for n, v in superbatch.items()}
            outs = self._step(state, batch, lrs[i], bs)
            with torch.no_grad():
                acc += torch.stack(_default_slot_sums(
                    outs, [batch.get(n) for n in self.label_names], bs))
        return state, StepMetrics(acc)
