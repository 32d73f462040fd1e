"""Checkpoints: ``save_checkpoint`` / ``load_checkpoint`` (port of
``mxnet_tpu/model.py:87-140``; reference python/mxnet/model.py), and the
Module stack's helpers (``mxnet_tpu/model.py:28-86``): ``BatchEndParam``
and the kvstore update trio.  ``FeedForward`` comes with a later slice.

The files are the JAX package's: ``prefix-symbol.json`` and
``prefix-%04d.params`` with ``arg:``/``aux:`` name prefixes, so a
checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import logging
import os
from collections import namedtuple

import numpy as np

from . import ndarray as nd
from . import symbol as sym_mod

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

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


def _replace_atomically(path, write):
    """``write(tmp_path)``, fsync, then rename over ``path``: a crash
    mid-save never tears an existing file."""
    tmp = "%s.tmp%d" % (path, os.getpid())
    try:
        write(tmp)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def write_atomically(path, data):
    """Write ``data`` (bytes) to ``path`` through a temporary file."""
    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)
    _replace_atomically(path, write)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save ``prefix-symbol.json`` + ``prefix-%04d.params``."""
    sym_json = symbol if isinstance(symbol, str) else symbol.tojson()

    def write_json(tmp):
        with open(tmp, "w") as f:
            f.write(sym_json)
    _replace_atomically("%s-symbol.json" % prefix, write_json)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    _replace_atomically(param_name, lambda tmp: nd.save(tmp, save_dict))
    logging.info("Saved checkpoint to \"%s\"", param_name)


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
