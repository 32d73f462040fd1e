"""Bucketed sentence iterator (port of ``mxnet_tpu/rnn/io.py``; reference
python/mxnet/rnn/io.py).

Sentences are padded into the smallest bucket that holds them; each batch
carries its ``bucket_key`` (the padded length) and its own
``provide_data``/``provide_label``, which ``BucketingModule`` binds one
executor for.  Batches are host (``cpu()``) arrays, as ``NDArrayIter``'s
are.  The shuffles use ``random.shuffle`` over the batch index and
``np.random.shuffle`` over each bucket's rows, as the JAX package does,
so seeding both global generators alike gives both packages the same
batches in the same order.
"""
from __future__ import annotations

import bisect
import random

import numpy as np

from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import array as nd_array

__all__ = ["BucketSentenceIter", "encode_sentences"]


class BucketSentenceIter(DataIter):
    """Bucketed iterator for variable-length sentences (reference
    rnn/io.py:BucketSentenceIter).  The label of a sentence is the
    sentence shifted left by one, ``invalid_label`` at its end."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            buckets = [i for i, j in enumerate(
                np.bincount([len(s) for s in sentences]))
                if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sentence in sentences:
            buck = bisect.bisect_left(buckets, len(sentence))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sentence)] = sentence
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)

        if self.major_axis == 0:
            shape = (batch_size, self.default_bucket_key)
        else:
            shape = (self.default_bucket_key, batch_size)
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        host = cpu()
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd_array(buck, ctx=host, dtype=self.dtype))
            self.ndlabel.append(nd_array(label, ctx=host, dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape,
                                                layout=self.layout)],
                         provide_label=[DataDesc(self.label_name, label.shape,
                                                 layout=self.layout)])


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Map token sequences to integer id sequences, growing ``vocab`` as
    new tokens appear (reference rnn/io.py:encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab, "Unknown token %s" % word
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab
