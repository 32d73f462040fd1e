"""Weight carry between numpy and the port.

``params_from_numpy`` takes the arrays a checkpoint holds as numpy
(``{name: np.ndarray}`` with ``arg:``/``aux:`` prefixes, or a pair of
dicts ``(arg, aux)``) — what the JAX package's NDArrays give through
``.asnumpy()`` — and returns the port's ``(arg_params, aux_params)``.
The result feeds ``Predictor``, ``Executor.copy_params_from`` and
``SPMDTrainer.init_params``.  ``params_to_numpy`` goes back: NDArrays or
tensors (a trainer's ``get_params()``, an executor's ``arg_dict``) to
numpy.  Files carry weights too, through the shared ``.params`` format
(:func:`ndarray.save` / :func:`ndarray.load`).

``tree_from_numpy`` / ``tree_to_numpy`` carry a nested dict of arrays
(the JAX long-context LM's params pytree, ``models/long_context_lm``)
to plain tensors on a context and back.

``shards_from_numpy`` lays numpy params over a mesh inside one process
by ``param_shardings`` rules (``parallel/collectives.Sharded``: each
position's part in its own storage, what ``SPMDTrainer.params`` holds on
such a mesh; unruled params replicated), and ``shards_to_numpy`` puts
placed shards back together as whole numpy arrays.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import current_context
from .ndarray import NDArray, tensor_from_numpy

__all__ = ["params_from_numpy", "params_to_numpy", "tree_from_numpy",
           "tree_to_numpy", "shards_from_numpy", "shards_to_numpy"]


def params_from_numpy(arrays, ctx=None):
    """``(arg_params, aux_params)`` of NDArrays on ``ctx`` (the current
    context when None), dtypes kept, values copied."""
    ctx = ctx if ctx is not None else current_context()
    if isinstance(arrays, tuple):
        if len(arrays) != 2:
            raise MXNetError("params_from_numpy: expected (arg, aux) dicts")
        args, auxs = arrays
    else:
        args, auxs = {}, {}
        for key, value in arrays.items():
            kind, sep, name = key.partition(":")
            if not sep or kind not in ("arg", "aux"):
                raise MXNetError(
                    "params_from_numpy: key %r has no arg:/aux: prefix"
                    % key)
            (args if kind == "arg" else auxs)[name] = value
    return ({k: NDArray(tensor_from_numpy(v), ctx=ctx) for k, v in args.items()},
            {k: NDArray(tensor_from_numpy(v), ctx=ctx) for k, v in auxs.items()})


def params_to_numpy(*dicts):
    """numpy copies of dicts of NDArrays or tensors, one dict per dict
    given (bfloat16 comes back as float32, exactly)."""
    out = []
    for d in dicts:
        out.append({k: (v if isinstance(v, NDArray)
                        else NDArray._from_torch(v, None)).asnumpy()
                    for k, v in (d or {}).items()})
    return out[0] if len(out) == 1 else tuple(out)


def tree_from_numpy(tree, ctx=None):
    """A nested dict of numpy arrays as the same dict of tensors on
    ``ctx``'s device (the current context when None), dtypes kept, values
    copied."""
    dev = (ctx if ctx is not None else current_context()).torch_device
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, ctx) for k, v in tree.items()}
    return tensor_from_numpy(tree).to(dev)


def tree_to_numpy(tree):
    """A nested dict of tensors as the same dict of numpy arrays
    (bfloat16 comes back as float32, exactly)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def shards_from_numpy(arrays, mesh, rules=None):
    """``{name: Sharded}``: each numpy array of ``arrays`` laid over the
    in-process ``mesh`` by the first regex of ``rules`` (``{pattern:
    spec}``, the ``param_shardings`` form) that matches its name, or
    replicated (the trainer's rule matching)."""
    from .parallel import collectives as C
    from .parallel.trainer import _spec_for
    out = {}
    for name, value in arrays.items():
        spec = C.P(*_spec_for(name, value.shape, rules))
        out[name] = C.shard(tensor_from_numpy(value), mesh, spec)
    return out


def shards_to_numpy(placed):
    """Whole numpy arrays from ``{name: Sharded}`` (or tensors)."""
    from .parallel.collectives import Sharded
    return tree_to_numpy({k: v.full() if isinstance(v, Sharded) else v
                          for k, v in placed.items()})
