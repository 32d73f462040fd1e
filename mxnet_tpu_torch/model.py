"""Checkpoints: ``save_checkpoint`` (with ``blocking=``, asynchronous
through ``resilience``'s writer) / ``load_checkpoint`` (port of
``mxnet_tpu/model.py:87-140``; reference python/mxnet/model.py), the
Module stack's helpers (``mxnet_tpu/model.py:28-86``): ``BatchEndParam``
and the kvstore update trio, and the legacy ``FeedForward`` API
(``mxnet_tpu/model.py:142-253``) over ``Module``.

The files are the JAX package's: ``prefix-symbol.json`` and
``prefix-%04d.params`` with ``arg:``/``aux:`` name prefixes, so a
checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from . import ndarray as nd
from . import symbol as sym_mod
from .context import current_context
from .initializer import Uniform
from .ndarray import NDArray

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """Decide kvstore + update_on_kvstore policy (reference model.py:40-77):
    one device and a 'local'-style name need no store at all; 'tpu' always
    makes one (the Module's fused route reads its type)."""
    from . import kvstore as kvs
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore) or hasattr(kvstore, "push"):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore and kvstore != "tpu":
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(np.prod(p.shape) for p in arg_params.values())
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """kv.init each param; pull initial weights if updating on kvstore
    (reference model.py:79-86)."""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """push grads / pull weights (reference model.py:88-97)."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        kvstore.push(index, grad_list, priority=-index)
        kvstore.pull(index, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Aggregate grads (via kvstore if given) and run the local updater per
    device (reference model.py:99-123)."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        if kvstore:
            kvstore.push(index, grad_list, priority=-index)
            kvstore.pull(index, grad_list, priority=-index)
        for k, p in enumerate(zip(arg_list, grad_list)):
            w, g = p
            updater(index * num_device + k, g, w)


def write_atomically(path, data):
    """Write ``data`` (bytes) to ``path`` through a temporary file, fsync
    and rename (``resilience.atomic_write``, with its ``checkpoint_write``
    fault point): a crash mid-save never tears an existing file."""
    from .resilience import atomic_write
    atomic_write(path, data)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    blocking=None):
    """Save ``prefix-symbol.json`` + ``prefix-%04d.params`` (reference
    model.py:save_checkpoint; the JAX package's bytes).  Files land via
    temp + fsync + rename, so a crash mid-save can never tear an existing
    checkpoint.

    ``blocking=False`` (default: the ``MXTPU_CKPT_ASYNC`` env) returns
    after copying the params to the host (one copy per tensor); the shared
    background :class:`~mxnet_tpu_torch.resilience.CheckpointWriter` then
    serializes and writes: drain with ``resilience.wait_checkpoints()``.
    ``symbol`` may be a Symbol or its JSON (what async snapshots and
    ``CheckpointManager``'s writer hand in)."""
    from .resilience import (atomic_path, atomic_write, checkpoint_async,
                             snapshot_params, submit_checkpoint)
    sym_json = symbol if isinstance(symbol, str) or symbol is None \
        else symbol.tojson()
    if blocking is None:
        blocking = not checkpoint_async()
    if not blocking:
        arg_params = snapshot_params(arg_params)
        aux_params = snapshot_params(aux_params)

    def _write():
        if sym_json is not None:
            atomic_write("%s-symbol.json" % prefix, sym_json)
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        param_name = "%s-%04d.params" % (prefix, epoch)
        with atomic_path(param_name) as tmp:
            nd.save(tmp, save_dict)
        logging.info("Saved checkpoint to \"%s\"", param_name)

    if blocking:
        _write()
    else:
        submit_checkpoint(_write, "%s epoch %d" % (prefix, epoch))


def load_checkpoint(prefix, epoch, ctx=None):
    """Load ``(symbol, arg_params, aux_params)``; the arrays land on
    ``ctx``, the host when None."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (symbol, arg_params, aux_params)


class FeedForward(object):
    """The legacy pre-Module training API (reference
    model.py:FeedForward), a thin adapter over ``mx.mod.Module``: numpy
    or NDArray inputs become an ``NDArrayIter`` of ``numpy_batch_size``;
    the extra keyword arguments are the optimizer's."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=Uniform(0.01),
                 numpy_batch_size=128, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        self.symbol = symbol
        self.ctx = ctx if ctx is not None else [current_context()]
        if not isinstance(self.ctx, (list, tuple)):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    def _get_module(self, data):
        from .module import Module
        # without labels in the data (predict), the symbol's label
        # arguments are still inputs, not parameters, as the reference's
        # predictor has them (the JAX package's FeedForward asks a loaded
        # model for "softmax_label" as a parameter)
        label_names = [d.name for d in (data.provide_label or [])] or \
            [n for n in self.symbol.list_arguments() if n.endswith("label")]
        return Module(self.symbol,
                      data_names=[d.name for d in data.provide_data],
                      label_names=label_names, context=self.ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        data = self._init_iter(X, y, is_train=True)
        self._module = self._get_module(data)
        self._module.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore,
                         optimizer=self.optimizer,
                         optimizer_params=self.kwargs,
                         initializer=self.initializer,
                         arg_params=self.arg_params,
                         aux_params=self.aux_params,
                         begin_epoch=self.begin_epoch,
                         num_epoch=self.num_epoch, monitor=monitor)
        self.arg_params, self.aux_params = self._module.get_params()

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy arrays (a list when the symbol
        has several)."""
        data = self._init_iter(X, None, is_train=False)
        if self._module is None or not self._module.binded:
            self._module = self._get_module(data)
            self._module.bind([(d.name, d.shape) for d in data.provide_data],
                              None, for_training=False)
            self._module.set_params(self.arg_params or {},
                                    self.aux_params or {},
                                    allow_missing=False)
        if reset:
            data.reset()
        outputs = self._module.predict(data, num_batch=num_batch)
        if isinstance(outputs, list):
            return [o.asnumpy() for o in outputs]
        return outputs.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None, **kwargs):
        """The value of ``eval_metric`` over ``X`` (an iterator with
        labels)."""
        data = self._init_iter(X, None, is_train=False)
        if self._module is None or not self._module.binded:
            self._module = self._get_module(data)
            self._module.bind([(d.name, d.shape) for d in data.provide_data],
                              [(l.name, l.shape) for l in data.provide_label],
                              for_training=False)
            self._module.set_params(self.arg_params or {},
                                    self.aux_params or {})
        res = self._module.score(data, eval_metric, num_batch=num_batch)
        return res[0][1]

    def _init_iter(self, X, y, is_train):
        if isinstance(X, (np.ndarray, NDArray)):
            from .io import NDArrayIter
            batch = min(self.numpy_batch_size, len(X))
            return NDArrayIter(X, y, batch_size=batch, shuffle=is_train,
                               last_batch_handle="roll_over" if is_train
                               else "pad")
        return X

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list)
        return model
