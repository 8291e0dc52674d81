"""RNN toolkit (ref: python/mxnet/rnn/): cells, the bucketing sentence
iterator and RNN checkpoints. Counterpart of ``mxnet_tpu/rnn``."""
from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell, FusedRNNCell,
                       SequentialRNNCell, BidirectionalCell, DropoutCell,
                       ZoneoutCell, ModifierCell, RNNParams)
from .io import BucketSentenceIter, encode_sentences
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)
