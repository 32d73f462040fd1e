"""RNN toolkit (port of ``mxnet_tpu/rnn``; reference python/mxnet/rnn/).

This slice ports the cells the LSTM language model needs: ``LSTMCell``,
``FusedRNNCell`` and ``SequentialRNNCell`` over ``BaseRNNCell`` and
``RNNParams``.  ``RNNCell``, ``GRUCell``, ``BidirectionalCell``,
``DropoutCell``, ``ZoneoutCell``, ``ResidualCell`` and the bucketing
input pipeline (``rnn/io.py``, ``rnn/rnn.py``) come with a later slice.
"""
from .rnn_cell import (BaseRNNCell, FusedRNNCell, LSTMCell, RNNParams,
                       SequentialRNNCell)

__all__ = ["BaseRNNCell", "FusedRNNCell", "LSTMCell", "RNNParams",
           "SequentialRNNCell"]
