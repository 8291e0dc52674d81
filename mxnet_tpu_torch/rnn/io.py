"""Bucketing data iterator for variable-length sequences
(ref: python/mxnet/rnn/io.py, BucketSentenceIter). Counterpart of
``mxnet_tpu/rnn/io.py``: the same buckets, padding and next-token labels;
the shuffle draws from ``random.np_rng()``, so for one seed its order
differs from the JAX package's (the same ``np.random.Generator`` given to
both through ``random.scoped_np_rng`` gives the same order). Batches are
host arrays, as the port's other iterators give them; ``next_host`` gives
them as numpy for ``SuperBatchIter`` to stack."""
from __future__ import annotations

import logging

import numpy as np

from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc
from .. import ndarray as nd
from .. import random as _random


class BucketSentenceIter(DataIter):
    """Bucketed iterator over encoded sentences.

    ``sentences``: lists of int ids. Each sentence lands in the smallest
    bucket that fits, padded with ``invalid_label``; a sentence longer
    than the largest bucket is dropped. Without ``buckets``, every length
    with at least ``batch_size`` sentences is a bucket. ``layout`` ``"NT"``
    gives (batch, time) batches, ``"TN"`` (time, batch). The label is the
    data shifted by one step, ending in ``invalid_label``."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            lengths = [len(s) for s in sentences]
            buckets = [i for i, j in enumerate(np.bincount(lengths))
                       if j >= batch_size]
        buckets = sorted(buckets)
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sentence in sentences:
            buck = np.searchsorted(buckets, len(sentence))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sentence)] = sentence
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        if ndiscard:
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket.", ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        shape = ((batch_size, self.default_bucket_key)
                 if self.major_axis == 0
                 else (self.default_bucket_key, batch_size))
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        rng = _random.np_rng()
        rng.shuffle(self.idx)
        for buck in self.data:
            rng.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(buck)
            self.ndlabel.append(label)

    def next_host(self):
        """The next batch with numpy data and label."""
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data, label = data.T, label.T
        data = np.ascontiguousarray(data)
        label = np.ascontiguousarray(label)
        return DataBatch([data], [label], pad=0, bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape)],
                         provide_label=[DataDesc(self.label_name,
                                                 label.shape)])

    def next(self):
        b = self.next_host()
        b.data = [nd.array(v, ctx=cpu()) for v in b.data]
        b.label = [nd.array(v, ctx=cpu()) for v in b.label]
        return b


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0):
    """Encode tokenized sentences into int ids; returns ``(encoded,
    vocab)``. Without ``vocab`` a new one is built, skipping the id
    ``invalid_label``; with one, an unknown token is an error."""
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
