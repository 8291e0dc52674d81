"""Evaluation metrics (ref: python/mxnet/metric.py).

Counterpart of ``mxnet_tpu/metric.py``: numpy metrics updated per batch
from ``(labels, preds)`` as the reference's EvalMetric family, the
``create`` factory and ``CompositeEvalMetric``, and the packed-accumulator
protocol of the K-step dispatch: a metric's :meth:`EvalMetric.device_sum_spec`
declares slots whose per-step sums ``TrainStep.run_steps(metric_spec=)``
accumulates on the device (here the ``step_sums`` are torch expressions
over the step's output and label tensors), and
:func:`update_from_device_sums` folds one dispatch's sums back into the
metric.
"""
from __future__ import annotations

import numpy
import torch

from .base import MXNetError
from .ndarray import NDArray


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_shape, pred_shape))


def _np(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


def _f32(x, device):
    """A float32 scalar tensor on ``device``. A Python number is filled in
    on the device: copying it from host memory would wait for the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _gather_last(o, li):
    """``o[..., li]`` along the last axis, in float32."""
    return torch.gather(o.float(), -1, li.long().unsqueeze(-1)).squeeze(-1)


def _prod(shape):
    out = 1
    for d in shape:
        out *= int(d)
    return out


class DeviceSumSpec(object):
    """One metric's declared device-side sum layout for the fused K-step
    dispatch.

    ``slots`` names the packed accumulator lanes. ``step_sums(outs,
    labels)`` runs on the device after each step of the dispatch: given
    one step's output tensors (in symbol output order) and label tensors
    (in declared label order), it returns one float32 scalar per slot —
    ``run_steps`` keeps the running sums on the device and the whole
    dispatch crosses to the host as ONE packed array. ``fold(metric,
    values)`` consumes one dispatch's accumulated ``{slot: float}``
    host-side — the K-step analog of ``update(labels, preds)`` without its
    per-step readbacks.

    ``signature`` is a hashable tuple naming the layout and its constants
    (CrossEntropy eps, TopK k, an axis). ``loss_slots`` optionally names a
    ``(loss_sum_slot, sample_count_slot)`` pair whose ratio is a watchable
    mean loss, what the training guard watches (a spec without one gains
    two hidden slots for it under ``run_steps(guard=True)``,
    ``train_step._with_guard_loss``). ``tag`` is a short human-readable
    token for logs.
    """

    __slots__ = ("slots", "step_sums", "fold", "signature", "loss_slots",
                 "tag")

    def __init__(self, slots, step_sums, fold, signature, loss_slots=None,
                 tag=None):
        slots = tuple(slots)
        if len(set(slots)) != len(slots):
            raise MXNetError("DeviceSumSpec: duplicate slot names in %r"
                             % (slots,))
        if loss_slots is not None:
            loss_slots = tuple(loss_slots)
            for s in loss_slots:
                if s not in slots:
                    raise MXNetError(
                        "DeviceSumSpec: loss_slots entry %r is not a "
                        "declared slot %r" % (s, slots))
        self.slots = slots
        self.step_sums = step_sums
        self.fold = fold
        self.signature = signature
        self.loss_slots = loss_slots
        self.tag = tag if tag is not None else str(signature[0])


def device_sum_spec(metric, out_shapes, label_shapes):
    """Resolve ``metric``'s packed-accumulator spec against concrete model
    shapes; None when the metric (or these shapes) need per-step host
    ``update()``. ``out_shapes``/``label_shapes``: shape tuples in symbol
    output / declared label order."""
    out_shapes = [tuple(int(d) for d in s) for s in (out_shapes or [])]
    label_shapes = [tuple(int(d) for d in s) for s in (label_shapes or [])]
    return metric.device_sum_spec(out_shapes, label_shapes)


class EvalMetric(object):
    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def device_sum_spec(self, out_shapes, label_shapes):
        """Packed-accumulator protocol: return a :class:`DeviceSumSpec` declaring this
        metric's device-side K-step sum layout for a model with the given
        output/label shapes, or None when the metric needs per-step host
        ``update()`` (the K-step dispatch then falls back to k=1 with a
        warning naming this metric)."""
        return None

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def update(self, labels, preds):
        raise NotImplementedError()

    def get(self):
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [x / y if y != 0 else float("nan")
                  for x, y in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite", **kwargs)
        self.metrics = metrics if metrics is not None else []

    def add(self, metric):
        self.metrics.append(metric)

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("Metric index {} is out of range 0 and {}".format(
                index, len(self.metrics)))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def get(self):
        names = []
        results = []
        for metric in self.metrics:
            result = metric.get()
            names.append(result[0])
            results.append(result[1])
        return (names, results)

    def device_sum_spec(self, out_shapes, label_shapes):
        """Concatenation of every child's spec (slot names prefixed by
        child index); None when ANY child needs the per-step host path —
        a composite folds as a unit, so one ineligible child forces the
        whole metric back to k=1."""
        if not self.metrics:
            return None
        children = []
        for m in self.metrics:
            sp = m.device_sum_spec(out_shapes, label_shapes)
            if sp is None:
                return None
            children.append(sp)
        slots = tuple("%d/%s" % (i, s)
                      for i, sp in enumerate(children) for s in sp.slots)

        def step_sums(outs, labels):
            vals = []
            for sp in children:
                vals.extend(sp.step_sums(outs, labels))
            return tuple(vals)

        def fold(metric, values):
            for i, (m, sp) in enumerate(zip(metric.metrics, children)):
                sp.fold(m, {s: values["%d/%s" % (i, s)] for s in sp.slots})

        loss_slots = None
        for i, sp in enumerate(children):
            if sp.loss_slots is not None:
                loss_slots = tuple("%d/%s" % (i, s) for s in sp.loss_slots)
                break
        return DeviceSumSpec(
            slots, step_sums, fold,
            ("comp",) + tuple(sp.signature for sp in children),
            loss_slots=loss_slots,
            tag="+".join(sp.tag for sp in children))


class Accuracy(EvalMetric):
    def __init__(self, axis=1):
        super().__init__("accuracy")
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_label = _np(pred_label)
            label = _np(label)
            if pred_label.shape != label.shape:
                pred_label = numpy.argmax(pred_label, axis=self.axis)
            pred_label = pred_label.astype("int32").flatten()
            label = label.astype("int32").flatten()
            check_label_shapes(label, pred_label, shape=1)
            self.sum_metric += (pred_label == label).sum()
            self.num_inst += len(pred_label)

    def device_sum_spec(self, out_shapes, label_shapes):
        """Any-axis argmax accuracy: each positional (output, label) pair
        must either match shapes exactly (predictions already class ids)
        or reduce to the label shape by argmax over ``self.axis``."""
        if not out_shapes or len(out_shapes) != len(label_shapes):
            return None
        axis = self.axis
        plan = []
        for o, l in zip(out_shapes, label_shapes):
            if o == l:
                plan.append(False)
                continue
            if len(o) != len(l) + 1 or not (-len(o) <= axis < len(o)):
                return None
            ax = axis % len(o)
            if o[:ax] + o[ax + 1:] != l:
                return None
            plan.append(True)
        n = sum(_prod(l) for l in label_shapes)

        def step_sums(outs, labels):
            dev = outs[0].device
            correct = _f32(0.0, dev)
            for use_argmax, o, l in zip(plan, outs, labels):
                li = l.to(torch.int32)
                p = (torch.argmax(o, dim=axis).to(torch.int32)
                     if use_argmax else o.to(torch.int32))
                correct = correct + (p == li).float().sum()
            return (correct, _f32(n, dev))

        def fold(metric, values):
            metric.sum_metric += float(values["correct"])
            metric.num_inst += int(values["n"])

        return DeviceSumSpec(("correct", "n"), step_sums, fold,
                             ("acc", axis), tag="acc")


class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1):
        super().__init__("top_k_accuracy")
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_label = _np(pred_label)
            label = _np(label).astype("int32")
            assert len(pred_label.shape) <= 2, "Predictions should be no more than 2 dims"
            num_samples = pred_label.shape[0]
            num_dims = len(pred_label.shape)
            # dims checked BEFORE argsort: the reference argsorts(axis=1)
            # first, making its 1-D branch unreachable (1-D preds raised) —
            # here 1-D preds are class ids and score directly
            if num_dims == 1:
                self.sum_metric += (pred_label.flatten() == label.flatten()).sum()
            elif num_dims == 2:
                # stable sort, as the device-sum spec's: an unstable host
                # quicksort could break tied-score rows' k=1-vs-k=K parity
                pred_label = numpy.argsort(pred_label.astype("float32"),
                                           axis=1, kind="stable")
                num_classes = pred_label.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (
                        pred_label[:, num_classes - 1 - j].flatten()
                        == label.flatten()).sum()
            self.num_inst += num_samples

    def device_sum_spec(self, out_shapes, label_shapes):
        if not out_shapes or len(out_shapes) != len(label_shapes):
            return None
        for o, l in zip(out_shapes, label_shapes):
            if len(o) not in (1, 2) or len(l) != 1 or o[0] != l[0]:
                return None
        top_k = self.top_k
        n = sum(o[0] for o in out_shapes)

        def step_sums(outs, labels):
            dev = outs[0].device
            correct = _f32(0.0, dev)
            for o, l in zip(outs, labels):
                li = l.to(torch.int32)
                if o.dim() == 1:
                    correct = correct + (o.to(torch.int32) == li).float() \
                        .sum()
                    continue
                # mirror the host argsort scoring (stable sort; host takes
                # the top_k last columns of an ascending argsort)
                idx = torch.argsort(o.float(), dim=1, stable=True)
                num_classes = o.shape[1]
                for j in range(min(num_classes, top_k)):
                    correct = correct + (
                        idx[:, num_classes - 1 - j].to(torch.int32)
                        == li).float().sum()
            return (correct, _f32(n, dev))

        def fold(metric, values):
            metric.sum_metric += float(values["correct"])
            metric.num_inst += int(values["n"])

        return DeviceSumSpec(("correct", "n"), step_sums, fold,
                             ("topk", top_k), tag="top%d" % top_k)


class F1(EvalMetric):
    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _np(pred)
            label = _np(label).astype("int32")
            pred_label = numpy.argmax(pred, axis=1)
            check_label_shapes(label, pred)
            if len(numpy.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary classification.")
            true_pos = ((pred_label == 1) & (label == 1)).sum()
            false_pos = ((pred_label == 1) & (label == 0)).sum()
            false_neg = ((pred_label == 0) & (label == 1)).sum()
            precision = true_pos / (true_pos + false_pos) if true_pos + false_pos > 0 else 0.0
            recall = true_pos / (true_pos + false_neg) if true_pos + false_neg > 0 else 0.0
            if precision + recall > 0:
                f1_score = 2 * precision * recall / (precision + recall)
            else:
                f1_score = 0.0
            self.sum_metric += f1_score
            self.num_inst += 1


class Perplexity(EvalMetric):
    """ref: metric.py Perplexity — exp(sum CE / num)."""

    def __init__(self, ignore_label, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _np(label)
            pred = _np(pred)
            assert label.size == pred.size / pred.shape[-1], \
                "shape mismatch: %s vs. %s" % (label.shape, pred.shape)
            label = label.reshape((label.size,)).astype("int32")
            probs = pred.reshape(-1, pred.shape[-1])[numpy.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= numpy.sum(ignore)
                probs = probs * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label.size
        self.sum_metric += numpy.exp(loss / num) * num
        self.num_inst += num

    def device_sum_spec(self, out_shapes, label_shapes):
        """Per-position CE over the LAST output dim, exp'd per step (the
        host folds ``exp(loss/num)*num`` once per ``update()`` call — one
        step of the dispatch is exactly one update). The raw (loss, n) pair is
        carried too so the guard can watch the mean CE."""
        if not out_shapes or len(out_shapes) != len(label_shapes):
            return None
        for o, l in zip(out_shapes, label_shapes):
            if len(o) < 2 or _prod(l) != _prod(o) // o[-1]:
                return None
        ignore = self.ignore_label

        def step_sums(outs, labels):
            dev = outs[0].device
            loss = _f32(0.0, dev)
            num = _f32(0.0, dev)
            for o, l in zip(outs, labels):
                # rank-agnostic: index the LAST dim in place; only a label
                # whose layout differs from the pred's (e.g. (b, s) vs
                # flat (b*s, v)) is rearranged to match
                if tuple(l.shape) != tuple(o.shape[:-1]):
                    l = l.reshape(o.shape[:-1])
                li = l.to(torch.int32)
                probs = _gather_last(o, li)
                if ignore is not None:
                    ign = (li == int(ignore)).float()
                    num = num - ign.sum()
                    probs = probs * (1.0 - ign) + ign
                loss = loss - torch.log(probs.clamp_min(1e-10)).sum()
                num = num + float(li.numel())
            ppl = torch.where(num > 0, torch.exp(loss / num) * num,
                              _f32(0.0, dev))
            return (ppl, loss, num)

        def fold(metric, values):
            metric.sum_metric += float(values["ppl"])
            metric.num_inst += int(round(float(values["n"])))

        return DeviceSumSpec(
            ("ppl", "loss", "n"), step_sums, fold,
            ("ppl", None if ignore is None else int(ignore)),
            loss_slots=("loss", "n"), tag="ppl")


def _reg2d(label, pred):
    """The regression metrics' shape rule: 1-D arrays become column
    vectors. BOTH sides must be lifted — reshaping only the label (the
    historical behavior) made a 1-D prediction broadcast (n,1)-(n,) into
    an (n,n) OUTER difference, silently scoring garbage (the matrix-fact
    RMSE bug)."""
    if len(label.shape) == 1:
        label = label.reshape(label.shape[0], 1)
    if len(pred.shape) == 1:
        pred = pred.reshape(pred.shape[0], 1)
    return label, pred


def _regression_spec(kind, out_shapes, label_shapes):
    """Shared packed-accumulator layout for MAE/MSE/RMSE: one per-batch
    mean-error term per (output, label) pair per step (mirroring the host
    ``num_inst += 1`` per pair), lifted through the same 1-D column rule
    as the host update."""
    if not out_shapes or len(out_shapes) != len(label_shapes):
        return None
    for o, l in zip(out_shapes, label_shapes):
        l2 = l if len(l) != 1 else (l[0], 1)
        o2 = o if len(o) != 1 else (o[0], 1)
        try:
            numpy.broadcast_shapes(l2, o2)
        except ValueError:
            return None
    n = len(out_shapes)

    def step_sums(outs, labels):
        dev = outs[0].device
        err = _f32(0.0, dev)
        for o, l in zip(outs, labels):
            if l.dim() == 1:
                l = l.reshape(-1, 1)
            if o.dim() == 1:
                o = o.reshape(-1, 1)
            d = l.float() - o.float()
            if kind == "mae":
                e = d.abs().mean()
            elif kind == "mse":
                e = d.square().mean()
            else:
                e = d.square().mean().sqrt()
            err = err + e
        return (err, _f32(n, dev))

    def fold(metric, values):
        metric.sum_metric += float(values["err"])
        metric.num_inst += int(values["n"])

    return DeviceSumSpec(("err", "n"), step_sums, fold, (kind,), tag=kind)


class MAE(EvalMetric):
    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _reg2d(_np(label), _np(pred))
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1

    def device_sum_spec(self, out_shapes, label_shapes):
        return _regression_spec("mae", out_shapes, label_shapes)


class MSE(EvalMetric):
    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _reg2d(_np(label), _np(pred))
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1

    def device_sum_spec(self, out_shapes, label_shapes):
        return _regression_spec("mse", out_shapes, label_shapes)


class RMSE(EvalMetric):
    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _reg2d(_np(label), _np(pred))
            self.sum_metric += numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1

    def device_sum_spec(self, out_shapes, label_shapes):
        return _regression_spec("rmse", out_shapes, label_shapes)


class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _np(label)
            pred = _np(pred)
            label = label.ravel()
            pred = pred.reshape(-1, pred.shape[-1])  # rank-3 LM heads
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]

    def device_sum_spec(self, out_shapes, label_shapes):
        """eps is a declared constant of the layout (part of the spec
        signature), so any eps rides the K-step dispatch."""
        if not out_shapes or len(out_shapes) != len(label_shapes):
            return None
        for o, l in zip(out_shapes, label_shapes):
            if len(o) < 2 or _prod(l) != _prod(o) // o[-1]:
                return None
        eps = float(self.eps)
        n = sum(_prod(o) // o[-1] for o in out_shapes)

        def step_sums(outs, labels):
            dev = outs[0].device
            loss = _f32(0.0, dev)
            for o, l in zip(outs, labels):
                # a gather over the LAST dim, rank-agnostic like
                # Perplexity's
                if tuple(l.shape) != tuple(o.shape[:-1]):
                    l = l.reshape(o.shape[:-1])
                p = _gather_last(o, l.to(torch.int32))
                loss = loss + (-torch.log(p + eps)).sum()
            return (loss, _f32(n, dev))

        def fold(metric, values):
            metric.sum_metric += float(values["loss"])
            metric.num_inst += int(values["n"])

        return DeviceSumSpec(("loss", "n"), step_sums, fold, ("ce", eps),
                             loss_slots=("loss", "n"), tag="ce")


class Loss(EvalMetric):
    """Average of the raw outputs — for MakeLoss heads."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += _np(pred).sum()
            self.num_inst += _np(pred).size

    def device_sum_spec(self, out_shapes, label_shapes):
        if not out_shapes:
            return None
        n = sum(_prod(o) for o in out_shapes)

        def step_sums(outs, labels):
            dev = outs[0].device
            s = _f32(0.0, dev)
            for o in outs:
                s = s + o.float().sum()
            return (s, _f32(n, dev))

        def fold(metric, values):
            metric.sum_metric += float(values["sum"])
            metric.num_inst += int(values["n"])

        return DeviceSumSpec(("sum", "n"), step_sums, fold, ("loss",),
                             tag="loss")


class Torch(Loss):
    """The average of the raw outputs of a Torch criterion, named
    ``torch`` (ref: metric.py Torch)."""

    def __init__(self):
        super(Loss, self).__init__("torch")


class Caffe(Loss):
    """The average of the raw outputs of a Caffe loss, named ``caffe``
    (ref: metric.py Caffe)."""

    def __init__(self):
        super(Loss, self).__init__("caffe")


class CustomMetric(EvalMetric):
    """``device_step_sums`` is the packed-accumulator opt-in: a torch
    ``(outs, labels) -> (sum, count)`` returning two scalars per step, letting a custom metric ride the
    fused K-step dispatch instead of forcing the k=1 fallback. The host
    ``feval`` stays authoritative for the per-step path; the caller owns
    their parity."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 device_step_sums=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs
        self._device_step_sums = device_step_sums

    def device_sum_spec(self, out_shapes, label_shapes):
        if self._device_step_sums is None:
            return None
        fn = self._device_step_sums

        def step_sums(outs, labels):
            dev = outs[0].device
            s, n = fn(outs, labels)
            return (_f32(s, dev), _f32(n, dev))

        def fold(metric, values):
            metric.sum_metric += float(values["sum"])
            metric.num_inst += int(round(float(values["n"])))

        return DeviceSumSpec(("sum", "n"), step_sums, fold,
                             ("custom", self.name, fn), tag="custom")

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label = _np(label)
            pred = _np(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Create a CustomMetric from a numpy feval (ref: metric.py np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


class MultiBoxMetric(EvalMetric):
    """SSD training metric (ref: example/ssd/train/metric.py
    MultiBoxMetric): index 0 the softmax cross-entropy of the class head
    over its valid anchors (``cls_prob`` (batch, classes, anchors) scored
    against the net's own ``cls_target`` output), index 1 the smooth-L1
    localization loss over the same count. Reads the SSD train symbol's
    outputs ``[cls_prob, loc_loss, cls_target, ...]``; the ground truth
    rides the graph through MultiBoxTarget, so the labels are unused."""

    def __init__(self, eps=1e-8):
        self.eps = eps
        super().__init__("multibox", num=2)

    def update(self, labels, preds):
        cls_prob = _np(preds[0])
        loc_loss = _np(preds[1])
        cls_label = _np(preds[2])
        num_classes = cls_prob.shape[1]
        label = cls_label.flatten().astype("int64")
        valid = label >= 0          # -1: a negative mined away
        prob = cls_prob.transpose(0, 2, 1).reshape(-1, num_classes)
        sel = prob[numpy.arange(label.shape[0]),
                   numpy.clip(label, 0, num_classes - 1)]
        ce = numpy.where(valid, -numpy.log(sel + self.eps), 0.0)
        n_valid = float(valid.sum())
        self.sum_metric[0] += ce.sum()
        self.num_inst[0] += n_valid
        self.sum_metric[1] += loc_loss.sum()
        self.num_inst[1] += n_valid

    def device_sum_spec(self, out_shapes, label_shapes):
        """SSD's heads: a rank-3 ``cls_prob``, the smooth-L1 values and a
        rank-2 ``cls_target``; the valid count is taken on the device from
        the target, where hard negative mining sets it each step."""
        if len(out_shapes) < 3:
            return None
        cp, cl = out_shapes[0], out_shapes[2]
        if len(cp) != 3 or len(cl) != 2:
            return None
        if cp[0] != cl[0] or cp[2] != cl[1]:
            return None
        eps = float(self.eps)

        def step_sums(outs, labels):
            cls_prob, loc_loss, cls_label = outs[0], outs[1], outs[2]
            num_classes = cls_prob.shape[1]
            li = cls_label.reshape(-1).to(torch.int32)
            valid = li >= 0
            flat = cls_prob.transpose(1, 2).reshape(-1, num_classes)
            sel = _gather_last(flat, torch.clamp(li, 0, num_classes - 1))
            ce = torch.where(valid, -torch.log(sel + eps),
                             torch.zeros_like(sel)).sum()
            return (ce, loc_loss.float().sum(), valid.float().sum())

        def fold(metric, values):
            metric.sum_metric[0] += float(values["ce"])
            metric.num_inst[0] += float(values["n"])
            metric.sum_metric[1] += float(values["l1"])
            metric.num_inst[1] += float(values["n"])

        return DeviceSumSpec(("ce", "l1", "n"), step_sums, fold,
                             ("multibox", eps), loss_slots=("ce", "n"),
                             tag="multibox")


# -- K-step dispatch aggregation (TrainStep.run_steps) ----------------------

def supports_device_sums(metric, out_shapes=None, label_shapes=None):
    """True when ``metric`` declares a packed-accumulator layout
    (:meth:`EvalMetric.device_sum_spec`) for the given model shapes —
    i.e. when ``Module.fit(steps_per_dispatch=k)`` can keep its sums on
    device and read back once per dispatch. With no shapes, probes the
    canonical single (rank-2 output, rank-1 label) classification head.

    Subclasses that redefine what ``update()`` accumulates inherit
    ``device_sum_spec() -> None`` from :class:`EvalMetric` unless they
    declare their own layout, so they fall back to per-step dispatch
    instead of silently folding the parent's sums."""
    if out_shapes is None:
        out_shapes, label_shapes = [(2, 4)], [(2,)]
    return device_sum_spec(metric, out_shapes, label_shapes) is not None


def update_from_device_sums(metric, sums):
    """Fold one dispatch's accumulated sums (a ``train_step.StepMetrics``)
    into ``metric`` — the K-step analog of ``metric.update(labels, preds)``
    without the per-step host readbacks it would have cost.

    A spec-carrying ``sums`` (the packed-accumulator protocol) folds by
    slot name through its metric's own ``fold``; the spec-less legacy
    layout (``[loss, correct, nsamp]`` — bench/TrainStep callers) still
    folds acc/ce directly. Folds go through Python float/int regardless
    of what the sums object yields: under NEP 50 a stray np.float32 in
    ``0.0 + x`` DEMOTES the host accumulator to float32 for the rest of
    the run — past 2**24 accumulated samples ``+= 1``-sized increments
    stop landing."""
    spec = getattr(sums, "spec", None)
    if spec is not None:
        spec.fold(metric, sums.values())
        return
    if isinstance(metric, CompositeEvalMetric):
        for m in metric.metrics:
            update_from_device_sums(m, sums)
        return
    # exact types: subclasses may redefine what update() accumulates
    if type(metric) is Accuracy:
        metric.sum_metric += float(sums.top1_correct)
        metric.num_inst += int(sums.num_samples)
    elif type(metric) is CrossEntropy:
        if metric.eps != 1e-8:
            # the LEGACY (spec-less) layout computed its on-device loss
            # with the hardcoded default eps; silently folding it into a
            # different-eps metric is the drift the old hard raise
            # blocked — the protocol path carries any eps, so say how to
            # get there
            raise MXNetError(
                "metric %r (CrossEntropy) has eps=%g but this spec-less "
                "dispatch accumulated its loss with eps=1e-8 — "
                "pass run_steps(metric_spec=metric.device_sum_spec(...)) "
                "so the declared eps rides the dispatch, or construct "
                "CrossEntropy(eps=1e-8)" % (metric.name, metric.eps))
        metric.sum_metric += float(sums.loss_sum)
        metric.num_inst += int(sums.num_samples)
    else:
        raise MXNetError(
            "%s cannot consume dispatch-level sums; train with "
            "steps_per_dispatch=1 or use acc/ce metrics"
            % type(metric).__name__)


def create(metric, **kwargs):
    """Create metric by name or callable or list (ref: metric.py create)."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    metrics = {
        "acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
        "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
        "top_k_accuracy": TopKAccuracy, "perplexity": Perplexity,
        "cross-entropy": CrossEntropy, "loss": Loss,
        "multibox": MultiBoxMetric,
    }
    try:
        return metrics[str(metric).lower()](**kwargs)
    except Exception:
        raise ValueError("Metric must be either callable or in {}".format(
            sorted(metrics.keys())))
