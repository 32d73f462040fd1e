"""Port of ``mxnet_tpu/serving/sequence.py`` (numpy only).

Bucketed SEQUENCE serving: variable-length token streams behind the
same admission-controlled front end as fixed-shape traffic.

This is the serving-side analog of the training-side bucketing iterator
(``rnn/io.BucketSentenceIter`` + ``BucketingModule``): a request carries
one token sequence of arbitrary length; the front end picks the
smallest configured LENGTH bucket that fits, edge-pads the sequence to
it, and batches it with other requests of the SAME bucket — so the
fused-RNN forward (``ops/nn.RNN``: one ``lstm_seq`` recurrence a
layer) binds once per (batch-bucket, length-bucket) pair and every
request rides a warm executor.  Each (model, length) pair gets its OWN
:class:`~.batcher.BucketBatcher` (registered as ``model@seq<L>``), so
length buckets never cross-contaminate batch shapes and all the QoS
machinery — priority, deadlines, weighted-fair tenants — applies per
bucket unchanged.

Why edge-padding is safe here: the language-model scan is CAUSAL —
step ``t`` depends only on tokens ``<= t`` — so the first ``len``
output steps are independent of whatever the pad region holds, and the
front end trims the answer back to the true length before replying.
``tests/test_torch_serving.py`` pins this as the BIT-STABILITY contract: the
same prefix served through two different length buckets answers
identically on the real steps.

The one model-shape fact this module owns: the reference LM head
(``models/lstm_lm.lstm_lm_sym``) emits its softmax as ``(L*B, V)``
rows in TIME-MAJOR interleave (row ``t*B + b``).  The batcher splits
batches on axis 0, so :class:`SequenceEntry` re-lays such outputs to
``(B, L, V)`` before handing them back.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError, get_env, register_env

__all__ = ["SequenceEntry", "parse_seq_buckets", "pick_seq_bucket",
           "seq_batcher_name", "ENV_SERVE_SEQ_BUCKETS"]

ENV_SERVE_SEQ_BUCKETS = register_env(
    "MXTPU_SERVE_SEQ_BUCKETS", default="8,16,32,64",
    doc="Sequence-LENGTH buckets for POST /predict_seq/<model> "
        "(comma-separated, ascending). A request's token list is "
        "edge-padded to the smallest bucket that fits; longer than the "
        "largest bucket is a 400. Each (model, bucket) pair batches "
        "independently")


def parse_seq_buckets(spec=None):
    """``"8,16,32"`` (or any int iterable) -> ascending unique tuple.
    ``None`` reads ``MXTPU_SERVE_SEQ_BUCKETS``."""
    if spec is None:
        spec = get_env(ENV_SERVE_SEQ_BUCKETS)
    if isinstance(spec, str):
        spec = [tok for tok in spec.replace(";", ",").split(",")
                if tok.strip()]
    try:
        buckets = sorted({int(b) for b in spec})
    except (TypeError, ValueError):
        raise MXNetError("bad sequence-bucket spec %r (want e.g. "
                         "'8,16,32')" % (spec,))
    if not buckets or buckets[0] < 1:
        raise MXNetError("sequence buckets must be positive ints, got %r"
                         % (spec,))
    return tuple(buckets)


def pick_seq_bucket(length, buckets):
    """Smallest bucket >= ``length`` (the BucketSentenceIter rule);
    raises :class:`MXNetError` when the sequence is longer than every
    bucket — the caller answers 400, never truncates silently."""
    n = int(length)
    if n < 1:
        raise MXNetError("empty token sequence")
    for b in buckets:
        if n <= b:
            return b
    raise MXNetError("sequence length %d exceeds the largest bucket %d"
                     % (n, buckets[-1]))


def seq_batcher_name(model, seq_len):
    """The per-(model, length-bucket) batcher key — shows up as its own
    row in ``/stats`` ``queue_depth``/``est_wait_ms``."""
    return "%s@seq%d" % (model, int(seq_len))


class SequenceEntry(object):
    """A per-(model, length-bucket) view of a pooled model, shaped like
    a :class:`~.pool.PooledModel` where the batcher is concerned
    (``input_names``/``sample_shapes``/``forward``).

    It forwards the token input plus a ZERO loss label of the same
    ``(B, L)`` shape (shape inference cannot derive a label's shape
    from the data side, and inference ignores its value) — the fused
    RNN's init states stay free symbol args the
    :class:`~..predict.Predictor` zero-fills at their back-inferred
    ``(layers, B, H)`` shape, which is exactly the zero initial state
    the training side used, at whatever batch bucket this batch
    happens to run.  Outputs whose leading axis is the time-major
    ``L*B`` interleave are re-laid to batch-major ``(B, L, ...)`` so
    the batcher's axis-0 per-request split holds.
    """

    def __init__(self, base, seq_len, data_name=None):
        self.base = base
        self.seq_len = int(seq_len)
        if data_name is None:
            names = getattr(base, "input_names", None) or ["data"]
            data_name = "data" if "data" in names else names[0]
        self.data_name = data_name
        self.input_names = [data_name]
        self.sample_shapes = {data_name: (self.seq_len,)}
        #: free label args (not in the loaded params): fed zeros at the
        #: data's shape so per-bucket shape inference completes
        symbol = getattr(base, "symbol", None)
        loaded = getattr(base, "arg_params", None) or {}
        self.label_names = [
            n for n in (symbol.list_arguments() if symbol is not None
                        else ())
            if n.endswith("label") and n not in loaded]

    @property
    def loaded_epoch(self):
        return self.base.loaded_epoch

    def _relay(self, out, batch):
        """Time-major ``(L*B, ...)`` -> batch-major ``(B, L, ...)``;
        anything already batch-major (or unbatched) passes through."""
        out = np.asarray(out)
        if out.ndim >= 1 and batch and \
                out.shape[0] == self.seq_len * batch and \
                out.shape[0] != batch:
            out = out.reshape((self.seq_len, batch) + out.shape[1:])
            out = np.swapaxes(out, 0, 1)
        return out

    def forward(self, inputs, n_valid=None):
        data = np.asarray(inputs[self.data_name])
        batch = int(data.shape[0]) if data.ndim else 0
        feed = {self.data_name: data}
        for name in self.label_names:
            feed[name] = np.zeros(data.shape, dtype=np.float32)
        outs = self.base.forward(feed, n_valid=n_valid)
        return [self._relay(o, batch) for o in outs]
