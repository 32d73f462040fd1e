"""Evaluation metrics (port of ``mxnet_tpu/metric.py:21-398,
486-507``; reference python/mxnet/metric.py).

Every metric reads its labels and predictions on the host with
``.asnumpy()`` at each ``update``: the JAX package's
``MXTPU_METRIC_BLOCKING=1`` path, whose values equal its deferred
in-graph accumulation.  ``Perplexity`` is the exception: it picks each
label's probability where the prediction lies and copies only those
(one float per label) to the host, then finishes in numpy as the JAX
package does.  ``SkippedSteps`` and the deferred metrics come with the
resilience slice.
"""
from __future__ import annotations

import math

import numpy as _numpy
import torch

from .base import MXNetError, Registry
from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "Perplexity",
           "MAE", "MSE", "RMSE", "CrossEntropy", "Loss", "Torch", "Caffe",
           "CustomMetric", "CompositeEvalMetric", "check_label_shapes", "np",
           "create"]

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
    """Base metric (reference metric.py:EvalMetric)."""

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
