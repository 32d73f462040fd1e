"""RNN checkpoint helpers (port of ``mxnet_tpu/rnn/rnn.py``; reference
python/mxnet/rnn/rnn.py).

A checkpoint holds each cell's weights unpacked into the per-gate form
(``unpack_weights``), so one written from a ``FusedRNNCell`` loads into
its unfused stack and back; the files are ``model.save_checkpoint``'s.
"""
from __future__ import annotations

from .. import model
from .rnn_cell import BaseRNNCell

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _as_list(cells):
    if isinstance(cells, BaseRNNCell):
        return [cells]
    return cells


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save a checkpoint with the cells' weights unpacked to the per-gate
    form (reference rnn/rnn.py:save_rnn_checkpoint)."""
    args = arg_params
    for cell in _as_list(cells):
        args = cell.unpack_weights(args)
    model.save_checkpoint(prefix, epoch, symbol, args, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load a checkpoint and pack the per-gate weights into the cells'
    form (reference rnn/rnn.py:load_rnn_checkpoint)."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    for cell in _as_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback that saves an RNN checkpoint every ``period``
    epochs (reference rnn/rnn.py:do_rnn_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
