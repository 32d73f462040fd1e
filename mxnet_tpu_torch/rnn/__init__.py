"""RNN toolkit (port of ``mxnet_tpu/rnn``; reference python/mxnet/rnn/):
the cells (``rnn_cell.py``), the bucketed sentence iterator and the
sentence encoder (``io.py``) and the RNN checkpoint helpers
(``rnn.py``)."""
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       RNNCell, RNNParams, ResidualCell, SequentialRNNCell,
                       ZoneoutCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import do_rnn_checkpoint, load_rnn_checkpoint, save_rnn_checkpoint

__all__ = ["BaseRNNCell", "BidirectionalCell", "DropoutCell", "FusedRNNCell",
           "GRUCell", "LSTMCell", "ModifierCell", "RNNCell", "RNNParams",
           "ResidualCell", "SequentialRNNCell", "ZoneoutCell",
           "BucketSentenceIter", "encode_sentences", "save_rnn_checkpoint",
           "load_rnn_checkpoint", "do_rnn_checkpoint"]
