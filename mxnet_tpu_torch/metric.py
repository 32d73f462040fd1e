"""Evaluation metrics (port of ``mxnet_tpu/metric.py``; reference
python/mxnet/metric.py).

A metric's ``update`` reads its labels and predictions on the host with
``.asnumpy()`` (``Perplexity`` copies only each label's picked
probability).  On the fused route a metric with a device rule
(``graph_update``: ``Accuracy``, as in the JAX package) is accumulated
inside ``SPMDTrainer.step`` instead (:func:`try_install_deferred`, which
``fit`` calls): the step adds to a ``(sum, count)`` pair of float32
tensors on the device and the host folds them in on ``get()`` /
``reset()`` or every ``MXTPU_METRIC_INTERVAL`` updates, so a step copies
nothing to the host; ``MXTPU_METRIC_BLOCKING=1`` keeps the per-step
host update.  The two give the same numbers (integer counts in float32).
``SkippedSteps`` surfaces the step guard's skip counter as a metric row.
"""
from __future__ import annotations

import math

import numpy as _numpy
import torch

from .base import MXNetError, Registry
from .base import register_env as _register_env
from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "Perplexity",
           "MAE", "MSE", "RMSE", "CrossEntropy", "Loss", "Torch", "Caffe",
           "CustomMetric", "CompositeEvalMetric", "SkippedSteps",
           "check_label_shapes", "np", "create", "try_install_deferred",
           "ENV_METRIC_INTERVAL", "ENV_METRIC_BLOCKING"]

metric_registry = Registry("metric")


def check_label_shapes(labels, preds, shape=False):
    if shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape[0], preds.shape[0]
    if label_shape != pred_shape:
        raise ValueError("Shape of labels %d does not match shape of "
                         "predictions %d" % (label_shape, pred_shape))


class EvalMetric(object):
    """Base metric (reference metric.py:EvalMetric).

    Deferred device accumulation: a fused trainer can keep this metric's
    (sum, count) on the device (``SPMDTrainer.install_metric``) so a
    step's ``update`` never copies to the host.  The trainer is attached
    as a deferred source (:meth:`attach_deferred_source`); ``get()`` and
    ``reset()`` fold the device totals in first, so reads are exact and
    between reads the host copy lags by at most the fold interval
    (``MXTPU_METRIC_INTERVAL``).
    """

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num
        reset_fn = getattr(self, "_deferred_reset", None)
        if reset_fn is not None:
            reset_fn()

    # -- deferred (on-device) accumulation ---------------------------------
    def graph_update(self, label_names):
        """A torch function ``fn(outs, data) -> (sum, count)`` mirroring
        :meth:`update` on the step's device tensors, or None when this
        metric has no device rule (the caller then keeps the blocking host
        path).  ``outs`` is the step's output list, ``data`` its input
        dict (labels under ``label_names``)."""
        return None

    def attach_deferred_source(self, fetch, reset):
        """Fold device-side accumulators into this metric lazily:
        ``fetch() -> (sum_delta, count_delta)`` is drained on every
        ``get``/explicit fold; ``reset()`` zeroes the device side when the
        metric resets."""
        self._deferred_fetch = fetch
        self._deferred_reset = reset

    def detach_deferred_source(self):
        self._deferred_fetch = None
        self._deferred_reset = None

    def fold_deferred(self):
        """Drain any pending device-side (sum, count) into the host
        accumulators (one small device-to-host read; no-op when no
        deferred source is attached)."""
        fetch = getattr(self, "_deferred_fetch", None)
        if fetch is None:
            return
        s, c = fetch()
        if c:
            self.sum_metric += s
            self.num_inst += int(c)

    def get(self):
        self.fold_deferred()
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
    """Manage multiple metrics (reference metric.py:CompositeEvalMetric)."""

    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite", **kwargs)
        self.metrics = metrics if metrics is not None else []

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, results = [], []
        for metric in self.metrics:
            name, result = metric.get()
            names.append(name)
            results.append(result)
        return names, results


def _as_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else _numpy.asarray(x)


@metric_registry.register(aliases=("acc",))
class Accuracy(EvalMetric):
    """Classification accuracy (reference metric.py:Accuracy)."""

    def __init__(self, axis=1, name="accuracy"):
        super().__init__(name)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").reshape(-1)
            label = label.astype("int32").reshape(-1)
            check_label_shapes(label, pred)
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)

    def graph_update(self, label_names):
        """The device rule: integer counts in float32, so the deferred
        totals equal the host path's exactly."""
        if not label_names:
            return None
        axis = self.axis

        def fn(outs, data):
            s = 0.0
            c = 0.0
            for name, pred in zip(label_names, outs):
                label = data[name]
                if pred.dim() > label.dim():
                    pred = pred.argmax(dim=axis)
                pred = pred.to(torch.int32).reshape(-1)
                label = label.to(torch.int32).reshape(-1)
                s = s + (pred == label).sum().to(torch.float32)
                c = c + float(label.shape[0])
            return s, c

        return fn


@metric_registry.register(name="top_k_accuracy", aliases=("topkaccuracy",))
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference metric.py:TopKAccuracy)."""

    def __init__(self, top_k=1, **kwargs):
        super().__init__("top_k_accuracy")
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            assert pred.ndim == 2, "Predictions should be 2 dims"
            pred = _numpy.argsort(pred, axis=1)
            num_samples, num_classes = pred.shape
            top_k = min(num_classes, self.top_k)
            for j in range(top_k):
                self.sum_metric += \
                    (pred[:, num_classes - 1 - j].astype("int32") ==
                     label.astype("int32")).sum()
            self.num_inst += num_samples


@metric_registry.register
class F1(EvalMetric):
    """Binary F1 (reference metric.py:F1)."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).astype("int32")
            pred_label = _numpy.argmax(pred, axis=1)
            check_label_shapes(label, pred)
            if len(_numpy.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            tp = ((pred_label == 1) & (label == 1)).sum()
            fp = ((pred_label == 1) & (label == 0)).sum()
            fn = ((pred_label == 0) & (label == 1)).sum()
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            if precision + recall > 0:
                f1 = 2 * precision * recall / (precision + recall)
            else:
                f1 = 0.0
            self.sum_metric += f1
            self.num_inst += 1


def pick_probs(pred, label):
    """``pred.reshape(-1, V)[arange, label]`` as a float32 (or float64)
    numpy vector, ``label`` an int32 numpy vector (a negative label
    counts from the end, as numpy's indexing does).  A prediction on the
    card is gathered there and only the picked values are copied."""
    if not isinstance(pred, NDArray):
        pred = _numpy.asarray(pred)
        pred = pred.reshape(-1, pred.shape[-1])
        return pred[_numpy.arange(label.shape[0]), label]
    data = pred._data.detach()
    data = data.reshape(-1, data.shape[-1])
    idx = _numpy.where(label < 0, label + data.shape[1], label)
    idx = torch.from_numpy(idx.astype(_numpy.int64)).to(data.device)
    picked = torch.gather(data, 1, idx.reshape(-1, 1)).reshape(-1)
    if picked.dtype == torch.bfloat16:
        picked = picked.float()
    return picked.to("cpu").numpy()


@metric_registry.register
class Perplexity(EvalMetric):
    """Perplexity, ``exp`` of the mean negative log probability of the
    labels (reference metric.py:Perplexity); labels equal to
    ``ignore_label`` count neither in the sum nor in the number.  The
    values equal the JAX package's host formula bit for bit: the pick
    copies the same float32 values, and the sum runs in numpy."""

    def __init__(self, ignore_label=None, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_np(label).reshape(-1).astype("int32")
            probs = pick_probs(pred, label)
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = _numpy.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= _numpy.sum(_numpy.log(_numpy.maximum(1e-10, probs)))
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@metric_registry.register
class MAE(EvalMetric):
    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += _numpy.abs(label - pred).mean()
            self.num_inst += 1


@metric_registry.register
class MSE(EvalMetric):
    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@metric_registry.register
class RMSE(EvalMetric):
    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += _numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@metric_registry.register(name="ce", aliases=("crossentropy",))
class CrossEntropy(EvalMetric):
    """Cross entropy over class-probability outputs (metric.py:CrossEntropy)."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[_numpy.arange(label.shape[0]), _numpy.int32(label)]
            self.sum_metric += (-_numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@metric_registry.register
class Loss(EvalMetric):
    """Mean of the output values (for MakeLoss-style outputs)."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += _as_np(pred).sum()
            self.num_inst += pred.size


class Torch(Loss):
    """The mean of a torch criterion's outputs (reference
    metric.py:Torch)."""

    def __init__(self, name="torch"):
        super(Loss, self).__init__(name)


class Caffe(Torch):
    """The mean of a caffe loss layer's outputs (reference
    metric.py:Caffe)."""

    def __init__(self):
        super(Loss, self).__init__("caffe")


class CustomMetric(EvalMetric):
    """Wrap a python feval function (reference metric.py:CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds, shape=True)
        for pred, label in zip(preds, labels):
            label, pred = _as_np(label), _as_np(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


class SkippedSteps(EvalMetric):
    """The fused step guard's skipped-update counter as a metric row, so
    NaN-skips show in the same epoch logs as accuracy or loss.

    ``source`` is anything exposing the counter: a Module
    (``skipped_update_count``) or an SPMDTrainer (``skipped_steps``).
    The value is a running total, not a per-batch average; ``reset()``
    keeps it (the counter belongs to the trainer).  The source's counter
    property reads the device counters, so ``get()`` is exact even when
    the guard's reads are deferred."""

    def __init__(self, source, name="skipped_steps"):
        self._source = source
        super().__init__(name)

    def update(self, labels, preds):
        pass

    def reset(self):
        pass

    def _count(self):
        for attr in ("skipped_update_count", "skipped_steps"):
            v = getattr(self._source, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    def get(self):
        return (self.name, self._count())


#: fold the device-side accumulators into the host metric every N
#: ``update_metric`` calls; 0 (default) folds only on reads
ENV_METRIC_INTERVAL = _register_env(
    "MXTPU_METRIC_INTERVAL", default=0,
    doc="Fold deferred on-device train-metric accumulators into the host "
        "metric every N update_metric calls (0 = on reads only)")
#: "1" disables deferred metrics: every step updates the host metric
#: from its copied outputs
ENV_METRIC_BLOCKING = _register_env(
    "MXTPU_METRIC_BLOCKING", default=0,
    doc="1 disables deferred metrics: every step updates the host metric "
        "from fetched outputs (exact-parity mode for tests)")


def try_install_deferred(trainer, metric):
    """Move ``metric``'s accumulation into ``trainer``'s fused step when
    possible.  Returns the fold interval (an int, 0 = on reads only) when
    installed, or None when the blocking path must be used (no trainer,
    ``MXTPU_METRIC_BLOCKING=1``, a compute dtype that would round the
    labels, a composite or multi-slot metric, or no device rule).  Call
    before the first step (fit does)."""
    from .base import get_env
    if trainer is None or getattr(trainer, "_eval", None) is None:
        return None
    if str(get_env(ENV_METRIC_BLOCKING, "0")) == "1":
        return None
    if getattr(trainer, "compute_dtype", None) is not None:
        # the step casts floating labels to the compute dtype too, and
        # bfloat16 cannot hold odd class ids above 256: the device
        # comparison would drift from the host path's exact labels
        return None
    if not isinstance(metric, EvalMetric) or metric.num is not None:
        return None
    fn = metric.graph_update(list(trainer.label_names))
    if fn is None:
        return None
    interval = int(get_env(ENV_METRIC_INTERVAL, "0"))
    # equivalence key: a second fit() with the same metric keeps the rule
    key = (type(metric).__name__, getattr(metric, "axis", None),
           tuple(trainer.label_names), interval)
    trainer.install_metric(fn, flush_interval=interval, key=key)
    metric.attach_deferred_source(trainer.fetch_metric,
                                  trainer.reset_metric)
    return interval


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Create a CustomMetric from a numpy function (reference metric.py:np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, **kwargs):
    """Create by name / callable / list (reference metric.py:create)."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    if isinstance(metric, str):
        return metric_registry.create(metric, **kwargs)
    raise MXNetError("invalid metric spec %r" % (metric,))
