"""Multi-layer LSTM language model (port of ``mxnet_tpu/models/lstm_lm.py``;
reference example/rnn/lstm_bucketing.py — the LSTM PTB workload of
BASELINE.json config #3).

Built on the fused ``RNN`` op: embedding -> stacked LSTM -> per-step FC
-> SoftmaxOutput.  ``sym_gen(seq_len)`` returns a symbol per bucket.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["lstm_lm_sym", "make_sym_gen"]


def lstm_lm_sym(seq_len, vocab_size, num_embed=200, num_hidden=200,
                num_layers=2, dropout=0.0):
    """Return (symbol, data_names, label_names) for one bucket: data
    (batch, seq_len) int tokens, label (batch, seq_len)."""
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data=data, input_dim=vocab_size,
                          output_dim=num_embed, name="embed")
    # (N, T, E) -> (T, N, E) time-major for the fused RNN
    tnc = sym.SwapAxis(embed, dim1=0, dim2=1, name="tnc")
    params = sym.Variable("lstm_parameters")
    init_h = sym.Variable("lstm_init_h")   # shape back-inferred by RNN
    init_c = sym.Variable("lstm_init_c")
    rnn = sym.RNN(data=tnc, parameters=params, state=init_h,
                  state_cell=init_c, state_size=num_hidden,
                  num_layers=num_layers, mode="lstm", p=dropout,
                  name="lstm")
    # (T, N, H) -> (T*N, H) -> logits per step
    hidden = sym.Reshape(rnn, shape=(-1, num_hidden), name="reshape_h")
    pred = sym.FullyConnected(data=hidden, num_hidden=vocab_size,
                              name="pred")
    # label (N, T) -> (T, N) -> (T*N,)
    lab = sym.Reshape(sym.SwapAxis(label, dim1=0, dim2=1), shape=(-1,),
                      name="reshape_l")
    out = sym.SoftmaxOutput(data=pred, label=lab, name="softmax")
    return out, ("data",), ("softmax_label",)


def make_sym_gen(vocab_size, num_embed=200, num_hidden=200, num_layers=2,
                 dropout=0.0):
    def sym_gen(seq_len):
        return lstm_lm_sym(seq_len, vocab_size, num_embed, num_hidden,
                           num_layers, dropout)
    return sym_gen
