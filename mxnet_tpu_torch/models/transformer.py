"""Decoder-only transformer LM: the long-context flagship model.

The port's copy of ``mxnet_tpu/models/transformer.py``: built inside the
same ``NameManager`` state it gives the same symbol JSON and parameter
names (``tok_embed_weight``, ``pos_embed_weight``, ``layer{i}_ln1_gamma``,
``layer{i}_attn_qkv_weight``, ``layer{i}_ffn_fc1_weight``, ...,
``final_ln_*``, ``lm_head_*``), so checkpoints carry across.

Pre-LN blocks: x + MHA(LN(x)); x + FFN(LN(x)); the loss is per-position
softmax cross-entropy over the vocabulary. ``stack_layers=True`` builds
the layer stack as one ``TransformerStack`` op over (num_layers, ...)
stacked weights. ``seq_parallel`` builds, and the first forward raises
(the port has no mesh yet, ROADMAP.md A.7b).
"""
from .. import symbol as sym
from ..base import MXNetError


def _ffn(x, embed, hidden, name):
    # flatten=False keeps (b, s, e) through both projections
    h = sym.FullyConnected(data=x, num_hidden=hidden, flatten=False,
                           name=name + "_fc1")
    h = sym.Activation(data=h, act_type="relu")
    h = sym.FullyConnected(data=h, num_hidden=embed, flatten=False,
                           name=name + "_fc2")
    return h


def _validate(vocab_size, embed, num_heads, num_layers, seq_len,
              ffn_hidden, max_seq_len, seq_parallel, block_size, dropout,
              stack_layers):
    """Build-time configuration checks with actionable errors (a config
    that would silently clamp positions or gather garbage embeddings must
    fail here, not three layers down)."""
    if vocab_size < 2:
        raise MXNetError(
            "transformer: vocab_size must be >= 2, got %d — the LM head "
            "and embedding table need a real vocabulary" % vocab_size)
    if seq_len < 1:
        raise MXNetError("transformer: seq_len must be >= 1, got %d"
                         % seq_len)
    if num_layers < 1:
        raise MXNetError("transformer: num_layers must be >= 1, got %d"
                         % num_layers)
    if embed % num_heads:
        raise MXNetError(
            "transformer: embed %d %% num_heads %d != 0 — the head dim "
            "must be integral (pick embed a multiple of num_heads)"
            % (embed, num_heads))
    if ffn_hidden < 1:
        raise MXNetError("transformer: ffn_hidden must be >= 1, got %d"
                         % ffn_hidden)
    if max_seq_len is not None and seq_len > max_seq_len:
        raise MXNetError(
            "transformer: seq_len %d exceeds the positional embedding "
            "table (%d rows) — positions past it would be silently "
            "clamped at serve time; raise max_seq_len or shorten seq_len"
            % (seq_len, max_seq_len))
    if block_size < 0 or block_size > seq_len:
        raise MXNetError(
            "transformer: block_size %d is outside [0, seq_len=%d] — 0 "
            "disables blocking, otherwise blocks must fit the sequence"
            % (block_size, seq_len))
    if block_size and seq_len % block_size:
        raise MXNetError(
            "transformer: seq_len %d %% block_size %d != 0 — blockwise "
            "attention needs equal blocks" % (seq_len, block_size))
    if not 0.0 <= dropout < 1.0:
        raise MXNetError("transformer: dropout must be in [0, 1), got %g"
                         % dropout)
    if stack_layers and seq_parallel:
        raise MXNetError(
            "transformer: stack_layers=True cannot combine with "
            "seq_parallel=%r — a pipeline stage body already runs inside "
            "shard_map, where the nested seq-parallel shard_map cannot "
            "be formed; pick 'pipe' OR 'seq' for the layer stack"
            % seq_parallel)
    if stack_layers and dropout > 0:
        raise MXNetError(
            "transformer: stack_layers=True does not support dropout — "
            "the stacked stage body is shared across layers; train the "
            "per-layer build or drop dropout")


def get_symbol(vocab_size=256, embed=128, num_heads=4, num_layers=2,
               seq_len=128, ffn_hidden=None, causal=True, seq_parallel="",
               block_size=0, dropout=0.0, max_seq_len=None,
               stack_layers=False, num_microbatches=0,
               preserve_shape=False, **kwargs):
    """Returns the LM symbol; data (batch, seq) int tokens, label
    (batch, seq) next-token ids.

    ``preserve_shape=True`` keeps the head rank-3 — (batch, seq, vocab)
    probabilities, label consumed as (batch, seq) — instead of the
    flattened (batch*seq, vocab) output. ``max_seq_len`` gives the
    positional-embedding table ``max_seq_len`` rows (serve-time decode
    may then run past ``seq_len``, up to the table). ``stack_layers=True``
    builds the layer stack as one ``TransformerStack`` op over stacked
    weights (``num_microbatches`` is the pipeline's, unused on one
    device). Token ids must lie in [0, vocab_size): ``DecodeLoop.generate``
    rejects others at serve time."""
    ffn_hidden = ffn_hidden or 4 * embed
    _validate(vocab_size, embed, num_heads, num_layers, seq_len,
              ffn_hidden, max_seq_len, seq_parallel, block_size, dropout,
              stack_layers)
    table_rows = max_seq_len if max_seq_len is not None else seq_len
    data = sym.Variable("data")
    pos = sym.Variable("pos_embed_weight", shape=(table_rows, embed))
    if table_rows != seq_len:
        pos = sym.slice_axis(pos, axis=0, begin=0, end=seq_len)
    tok = sym.Embedding(data=data, input_dim=vocab_size, output_dim=embed,
                        name="tok_embed")
    x = sym.broadcast_add(tok, sym.expand_dims(pos, axis=0))
    if stack_layers:
        x = sym.TransformerStack(
            data=x, num_layers=num_layers, num_heads=num_heads,
            ffn_hidden=ffn_hidden, causal=causal, block_size=block_size,
            num_microbatches=num_microbatches, name="stack")
    else:
        for i in range(num_layers):
            name = "layer%d" % i
            a = sym.LayerNorm(data=x, name=name + "_ln1")
            a = sym.MultiHeadAttention(data=a, num_heads=num_heads,
                                       causal=causal,
                                       seq_parallel=seq_parallel,
                                       block_size=block_size,
                                       name=name + "_attn")
            if dropout > 0:
                a = sym.Dropout(data=a, p=dropout)
            x = x + a
            f = sym.LayerNorm(data=x, name=name + "_ln2")
            f = _ffn(f, embed, ffn_hidden, name + "_ffn")
            if dropout > 0:
                f = sym.Dropout(data=f, p=dropout)
            x = x + f
    x = sym.LayerNorm(data=x, name="final_ln")
    label = sym.Variable("softmax_label")
    if preserve_shape:
        # rank-3 head: (b, s, vocab) probabilities over the last dim with
        # the (b, s) label consumed directly
        logits = sym.FullyConnected(data=x, num_hidden=vocab_size,
                                    flatten=False, name="lm_head")
        return sym.SoftmaxOutput(data=logits, label=label,
                                 preserve_shape=True, name="softmax")
    x = sym.Reshape(data=x, shape=(-1, embed))
    logits = sym.FullyConnected(data=x, num_hidden=vocab_size, name="lm_head")
    label = sym.Reshape(data=label, shape=(-1,))
    return sym.SoftmaxOutput(data=logits, label=label, name="softmax")
