"""The port's recurrent layer (the RNN op, the rnn cells, the Sequence ops
and SliceChannel, BucketSentenceIter, the FusedRNN initializer and RNN
checkpoints) against the JAX package, on the CPU.

The same numpy inputs and weights go through both packages. Tolerances,
each with its reason:
- the RNN op and every cell's unroll, forward ``rtol=1e-5, atol=1e-6``
  and gradients ``rtol=1e-4, atol=1e-5``: the port adds the hidden bias
  into the input projection (one ``addmm`` a step) where the JAX op adds
  it after, and the two backends sum the products in other orders; both
  round once per operation in float32 (measured: at most 2.4e-7 apart
  forward);
- a fused cell against its ``unfuse()`` in the same package, ``rtol=1e-5,
  atol=1e-6``: one product over all time steps against one a step;
- the Sequence ops, SliceChannel, the iterator, the encoding, the
  initializer with a constant ``init`` and the checkpoints: exact (no
  arithmetic, or the same arithmetic);
- inter-layer dropout (``p > 0``): the port's generators are not JAX's, so
  masks cannot match bit for bit; held by statistics (dropped fraction
  within 0.5 +- 0.02 over 12288 draws at p = 0.5) and by the kept values
  (exact, scaled by 1 / keep).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu import rnn as jrnn
from mxnet_tpu.ops import rnn_op as jrnn_op
from mxnet_tpu.ops.registry import OpContext as JOpContext
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import rnn as trnn
from mxnet_tpu_torch.ops import rnn_op as trnn_op
from mxnet_tpu_torch.ops.registry import OpContext as TOpContext

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
MODES = ["rnn_relu", "rnn_tanh", "lstm", "gru"]


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _rnn_inputs(rng, mode, bi, T=5, N=3, C=4, H=6, L=2):
    d = 2 if bi else 1
    size = trnn_op.rnn_param_size(mode, C, H, L, bi)
    assert size == jrnn_op.rnn_param_size(mode, C, H, L, bi)
    ins = [rng.standard_normal((T, N, C)).astype(np.float32),
           (0.3 * rng.standard_normal(size)).astype(np.float32),
           rng.standard_normal((L * d, N, H)).astype(np.float32)]
    if mode == "lstm":
        ins.append(rng.standard_normal((L * d, N, H)).astype(np.float32))
    attrs = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bi,
                 state_outputs=True)
    return ins, attrs


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax(mode, bi):
    """Outputs, final states and the gradients of every input (data, the
    packed parameters, the begin states) under random head gradients."""
    rng = _rng("op-%s-%s" % (mode, bi))
    ins, attrs = _rnn_inputs(rng, mode, bi)
    jouts, vjp = jax.vjp(
        lambda *a: jrnn_op._rnn(JOpContext(True, None), attrs, list(a), []),
        *[jnp.asarray(i) for i in ins])
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = [torch.from_numpy(i).requires_grad_() for i in ins]
    touts = trnn_op._rnn(TOpContext(is_train=True), attrs, leaves, [])
    tgrads = torch.autograd.grad(touts, leaves,
                                 [torch.from_numpy(c) for c in cots])
    assert len(touts) == len(jouts) == (3 if mode == "lstm" else 2)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **FWD)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD)


@pytest.mark.parametrize("state_outputs", [False, True])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_symbol_names_shapes_and_forward(mode, state_outputs):
    """``sym.RNN``'s arguments, outputs and inferred shapes, and a bound
    forward, match the JAX package's."""
    rng = _rng("sym-%s-%s" % (mode, state_outputs))
    ins, attrs = _rnn_inputs(rng, mode, True)
    attrs["state_outputs"] = state_outputs
    outs = {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        kw = {n: pkg.sym.Variable(n) for n in
              ["data", "parameters", "state", "state_cell"][:len(ins)]}
        s = pkg.sym.RNN(name="rnn", **kw, **attrs)
        shapes = dict(zip(s.list_arguments(), [i.shape for i in ins]))
        arg_shapes, out_shapes, _ = s.infer_shape(data=ins[0].shape)
        ex = s.bind(ctx, {n: pkg.nd.array(v, ctx=ctx)
                          for n, v in zip(s.list_arguments(), ins)})
        outs[pkg.__name__] = (s.list_arguments(), s.list_outputs(),
                              arg_shapes, out_shapes, shapes,
                              [o.asnumpy() for o in ex.forward()])
    j, t = outs["mxnet_tpu"], outs["mxnet_tpu_torch"]
    assert t[:5] == j[:5]
    for a, b in zip(t[5], j[5]):
        np.testing.assert_allclose(a, b, **FWD)


def test_rnn_inter_layer_dropout_statistics():
    """``p`` drops the first layer's outputs before the second in training
    only. The second layer passes its input through (W_x = I, W_h = 0, no
    bias, relu over positive values), so the output is the first layer's
    output masked and scaled by 1 / keep."""
    T, N, H, p = 8, 48, 32, 0.5
    slices, total = trnn_op._param_slices("rnn_relu", H, H, 2, False)
    params = torch.zeros(total)
    rng = _rng("dropout")
    for (layer, _), specs in slices.items():
        off, n, shape = specs[0]
        w = (np.eye(H, dtype=np.float32) if layer == 1 else
             np.abs(rng.standard_normal(shape)).astype(np.float32) / H)
        params[off:off + n] = torch.from_numpy(w.reshape(-1))
    data = torch.from_numpy(
        np.abs(rng.standard_normal((T, N, H))).astype(np.float32) + 0.1)
    state = torch.zeros(2, N, H)
    plain = dict(state_size=H, num_layers=2, mode="rnn_relu")
    ref = trnn_op._rnn(TOpContext(is_train=True), plain,
                       [data, params, state], [])[0]
    attrs = dict(plain, p=p)
    gen = torch.Generator().manual_seed(3)
    out = trnn_op._rnn(TOpContext(is_train=True, rng=gen), attrs,
                       [data, params, state], [])[0]
    dropped = (out == 0).float().mean().item()
    assert abs(dropped - p) < 0.02
    kept = out != 0
    torch.testing.assert_close(out[kept], ref[kept] / (1 - p), rtol=0,
                               atol=0)
    # inference ignores p
    torch.testing.assert_close(
        trnn_op._rnn(TOpContext(is_train=False, rng=gen), attrs,
                     [data, params, state], [])[0], ref, rtol=0, atol=0)


# -- cells ---------------------------------------------------------------

def _cells(pkg, kind):
    r = pkg.rnn
    H = 5
    if kind == "rnn_tanh":
        return r.RNNCell(H, activation="tanh", prefix="rnn_")
    if kind == "rnn_relu":
        return r.RNNCell(H, activation="relu", prefix="rnn_")
    if kind == "lstm":
        return r.LSTMCell(H, prefix="lstm_")
    if kind == "gru":
        return r.GRUCell(H, prefix="gru_")
    if kind == "sequential":
        c = r.SequentialRNNCell()
        c.add(r.LSTMCell(H, prefix="l0_"))
        c.add(r.DropoutCell(0.5, prefix="d0_"))
        c.add(r.GRUCell(H, prefix="l1_"))
        return c
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(H, prefix="l_"),
                                   r.GRUCell(H, prefix="r_"))
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(H, prefix="z_"),
                             zoneout_outputs=0.3, zoneout_states=0.2)
    if kind.startswith("fused"):
        _, mode, bi = kind.split("-")
        return r.FusedRNNCell(H, num_layers=2, mode=mode,
                              bidirectional=(bi == "bi"), prefix="f_")
    raise ValueError(kind)


CELLS = ["rnn_tanh", "rnn_relu", "lstm", "gru", "sequential",
         "bidirectional", "zoneout", "fused-lstm-uni", "fused-gru-bi",
         "fused-rnn_tanh-bi"]


def _unroll(pkg, kind, T, N, C):
    """The cell of ``kind`` unrolled over a (N, T, C) ``data`` with its
    begin states as inputs: ``(cell, symbol, input shapes)``."""
    cell = _cells(pkg, kind)
    with pkg.symbol.NameManager():
        data = pkg.sym.Variable("data")
        begin = cell.begin_state()
        outs, states = cell.unroll(T, inputs=data, begin_state=begin,
                                   layout="NTC", merge_outputs=True)
    shapes = {"data": (N, T, C)}
    for b, info in zip(begin, cell.state_info):
        shapes[b.list_outputs()[0]] = tuple(N if d == 0 else d
                                            for d in info["shape"])
    s = pkg.sym.Group([outs] + list(states)) if states else outs
    return cell, s, shapes


def _eval(pkg, s, vals, is_train=False, cots=None):
    ctx = pkg.cpu()
    args = {n: pkg.nd.array(vals[n], ctx=ctx) for n in s.list_arguments()}
    grads = {n: pkg.nd.zeros(vals[n].shape, ctx=ctx)
             for n in s.list_arguments()}
    ex = s.bind(ctx, args, args_grad=grads if cots else None,
                grad_req="write" if cots else "null")
    outs = [o.asnumpy() for o in ex.forward(is_train=is_train or bool(cots))]
    if cots:
        ex.backward([pkg.nd.array(c, ctx=ctx) for c in cots])
        return outs, {n: g.asnumpy() for n, g in ex.grad_dict.items()}
    return outs, None


def _values(s, shapes_from, rng):
    arg_shapes, out_shapes, _ = s.infer_shape(**shapes_from)
    vals = {n: (0.4 * rng.standard_normal(sh)).astype(np.float32)
            for n, sh in zip(s.list_arguments(), arg_shapes)}
    return vals, out_shapes


@pytest.mark.parametrize("kind", CELLS)
def test_cell_unroll_matches_jax(kind):
    """Argument names, output shapes, outputs and gradients of every
    cell's ``unroll`` (begin states as inputs) against the JAX package's
    (the dropout-bearing cells in inference, where they pass through)."""
    T, N, C = 4, 3, 7
    rng = _rng("cell-" + kind)
    _, js, shapes = _unroll(mx, kind, T, N, C)
    _, ts, tshapes = _unroll(mt, kind, T, N, C)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert tshapes == shapes
    vals, out_shapes = _values(js, shapes, rng)
    assert ts.infer_shape(**shapes)[1] == out_shapes
    dropout = kind in ("sequential", "zoneout")
    cots = None if dropout else [rng.standard_normal(s).astype(np.float32)
                                 for s in out_shapes]
    jo, jg = _eval(mx, js, vals, cots=cots)
    to, tg = _eval(mt, ts, vals, cots=cots)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **FWD)
    if cots:
        assert set(tg) == set(jg)
        for n in jg:
            np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **GRAD)


@pytest.mark.parametrize("pkg", [mx, mt], ids=["jax", "port"])
@pytest.mark.parametrize("kind", ["fused-lstm-uni", "fused-gru-bi",
                                  "fused-rnn_relu-uni", "fused-rnn_tanh-bi"])
def test_fused_cell_matches_its_unfuse(kind, pkg):
    """A FusedRNNCell and its ``unfuse()`` compute the same function on
    the same weights, unpacked by ``unpack_weights`` (the gate order and
    the packed layout agree), in each package."""
    T, N, C = 5, 2, 3
    rng = _rng("unfuse-" + kind)
    fused, fs, shapes = _unroll(pkg, kind, T, N, C)
    vals, _ = _values(fs, shapes, rng)
    fo, _ = _eval(pkg, fs, vals)
    stack = fused.unfuse()
    with pkg.symbol.NameManager():
        outs = pkg.sym.Variable("data")
        begin = stack.begin_state()
        # layer by layer: a stack of BidirectionalCells cannot be stepped
        rest = list(begin)
        for layer in stack._cells:
            n = len(layer.state_info)
            outs, _ = layer.unroll(T, inputs=outs, begin_state=rest[:n],
                                   layout="NTC", merge_outputs=True)
            rest = rest[n:]
    ctx = pkg.cpu()
    unpacked = fused.unpack_weights(
        {"f_parameters": pkg.nd.array(vals["f_parameters"], ctx=ctx)})
    uvals = {"data": vals["data"]}
    uvals.update({n: v.asnumpy() for n, v in unpacked.items()})
    # unfuse's begin states are one a layer and direction ([h, c] each for
    # an LSTM): take them from the fused (L*D, N, H) states in that order
    fused_states = [vals[n] for n in sorted(k for k in vals
                                            if "begin_state" in k)]
    per_layer = [st[i] for i in range(fused_states[0].shape[0])
                 for st in fused_states]
    assert len(begin) == len(per_layer)
    uvals.update(zip((b.list_outputs()[0] for b in begin), per_layer))
    uo, _ = _eval(pkg, outs, uvals)
    np.testing.assert_allclose(uo[0], fo[0], **FWD)
    repacked = fused.pack_weights(unpacked)
    np.testing.assert_array_equal(repacked["f_parameters"].asnumpy(),
                                  vals["f_parameters"])


@pytest.mark.parametrize("kind", ["lstm", "gru", "fused-lstm-bi",
                                  "bidirectional", "sequential"])
def test_pack_unpack_weights_match_jax(kind):
    """``unpack_weights`` gives the JAX package's names and values, and
    ``pack_weights`` inverts it, in both packages."""
    T, N, C = 3, 2, 4
    rng = _rng("pack-" + kind)
    _, js, shapes = _unroll(mx, kind, T, N, C)
    vals, _ = _values(js, shapes, rng)
    params = {n: v for n, v in vals.items()
              if n != "data" and "begin_state" not in n}
    jcell, tcell = _cells(mx, kind), _cells(mt, kind)
    ju = jcell.unpack_weights({n: mx.nd.array(v) for n, v in params.items()})
    tu = tcell.unpack_weights({n: mt.nd.array(v, ctx=mt.cpu())
                               for n, v in params.items()})
    assert sorted(tu) == sorted(ju)
    for n in ju:
        np.testing.assert_array_equal(tu[n].asnumpy(), ju[n].asnumpy())
    tp = tcell.pack_weights(tu)
    assert sorted(tp) == sorted(params)
    for n, v in params.items():
        np.testing.assert_array_equal(tp[n].asnumpy(), v)


# -- Sequence ops and SliceChannel ---------------------------------------

SEQ_CASES = [("SequenceLast", False), ("SequenceLast", True),
             ("SequenceMask", False), ("SequenceMask", True),
             ("SequenceReverse", False), ("SequenceReverse", True)]


@pytest.mark.parametrize("op,use_len", SEQ_CASES)
def test_sequence_ops_match_jax(op, use_len):
    """Forward and data gradient, with and without ``sequence_length``."""
    rng = _rng("seq-%s-%s" % (op, use_len))
    T, N = 6, 5
    x = rng.standard_normal((T, N, 3)).astype(np.float32)
    # a length past T: SequenceLast clips it, SequenceMask keeps every step;
    # SequenceReverse needs lengths within T (the JAX package reads NaN
    # past the end, the port clips)
    lens = np.array([1, 3, 6, 2, 5 if op == "SequenceReverse" else 7],
                    np.float32)
    res = {}
    for pkg in (mx, mt):
        kw = {"data": pkg.sym.Variable("data")}
        attrs = {}
        if use_len:
            kw["sequence_length"] = pkg.sym.Variable("sequence_length")
            attrs["use_sequence_length"] = True
        if op == "SequenceMask":
            attrs["value"] = -2.0
        s = getattr(pkg.sym, op)(name="s", **kw, **attrs)
        vals = {"data": x, "sequence_length": lens}
        vals = {n: vals[n] for n in s.list_arguments()}
        oshape = s.infer_shape(**{n: v.shape for n, v in vals.items()})[1][0]
        cot = _rng("cot").standard_normal(oshape).astype(np.float32)
        ctx = pkg.cpu()
        ex = s.bind(ctx, {n: pkg.nd.array(v, ctx=ctx)
                          for n, v in vals.items()},
                    args_grad={"data": pkg.nd.zeros(x.shape, ctx=ctx)},
                    grad_req={"data": "write"})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([pkg.nd.array(cot, ctx=ctx)])
        res[pkg.__name__] = (s.list_arguments(), out,
                             ex.grad_dict["data"].asnumpy())
    j, t = res["mxnet_tpu"], res["mxnet_tpu_torch"]
    assert t[0] == j[0]
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[2], j[2])


@pytest.mark.parametrize("axis,squeeze", [(1, False), (0, True), (2, False),
                                          (1, True)])
def test_slice_channel_and_split_match_jax(axis, squeeze):
    """Output names, shapes, values and the gradient; ``split`` is the
    same op."""
    rng = _rng("slice-%d-%s" % (axis, squeeze))
    x = rng.standard_normal((4, 4, 6)).astype(np.float32)
    n = 2 if axis == 2 else 4
    n = x.shape[axis] if squeeze else n
    res = {}
    for pkg in (mx, mt):
        for fn in ("SliceChannel", "split"):
            s = getattr(pkg.sym, fn)(data=pkg.sym.Variable("data"), axis=axis,
                                     num_outputs=n, squeeze_axis=squeeze,
                                     name="sc")
            ctx = pkg.cpu()
            ex = s.bind(ctx, {"data": pkg.nd.array(x, ctx=ctx)},
                        args_grad={"data": pkg.nd.zeros(x.shape, ctx=ctx)})
            outs = [o.asnumpy() for o in ex.forward(is_train=True)]
            cots = [np.full(o.shape, k + 1, np.float32)
                    for k, o in enumerate(outs)]
            ex.backward([pkg.nd.array(c, ctx=ctx) for c in cots])
            res[(pkg.__name__, fn)] = (s.list_outputs(), outs,
                                       ex.grad_dict["data"].asnumpy())
    j = res[("mxnet_tpu", "SliceChannel")]
    for key, t in res.items():
        assert t[0] == j[0] == ["sc_output%d" % k for k in range(n)]
        for a, b in zip(t[1], j[1]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t[2], j[2])


# -- BucketSentenceIter and encode_sentences ------------------------------

def _sentences(seed, n=90):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, 30, size=int(rng.integers(2, 14))))
            for _ in range(n)]


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    """Given the same numpy Generator, both packages give the same batches
    (data, next-token labels padded with ``invalid_label``, bucket keys,
    descriptors) over two epochs, and the same default bucket."""
    sents = _sentences(1)
    batches = {}
    for pkg, rmod in ((jrnn, jrandom), (trnn, trandom)):
        with rmod.scoped_np_rng(np.random.default_rng(7)):
            it = pkg.BucketSentenceIter(sents, 4, buckets=[5, 9, 14],
                                        invalid_label=0, layout=layout)
            got = []
            for _ in range(2):
                for b in it:
                    got.append((b.bucket_key, b.data[0].asnumpy(),
                                b.label[0].asnumpy(),
                                tuple(b.provide_data[0].shape)))
                it.reset()
        batches[pkg.__name__] = (it.default_bucket_key,
                                 [tuple(d.shape) for d in it.provide_data],
                                 got)
    j, t = batches["mxnet_tpu.rnn"], batches["mxnet_tpu_torch.rnn"]
    assert t[0] == j[0] == 14 and t[1] == j[1]
    assert len(t[2]) == len(j[2]) > 10
    for (tk, td, tl, tp), (jk, jd, jl, jp) in zip(t[2], j[2]):
        assert tk == jk and tp == jp
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
    # labels are the data shifted by one step, ending in the invalid label
    _, d, l, _ = t[2][0]
    if layout == "TN":
        d, l = d.T, l.T
    np.testing.assert_array_equal(l[:, :-1], d[:, 1:])
    assert (l[:, -1] == 0).all()


def test_bucket_sentence_iter_default_buckets_and_discard():
    """Without ``buckets`` every length with a full batch is a bucket; a
    sentence longer than the largest bucket is dropped, as in the JAX
    package."""
    sents = [[1] * 3] * 5 + [[2] * 4] * 2 + [[3] * 6] * 4
    for pkg in (jrnn, trnn):
        it = pkg.BucketSentenceIter(sents, 4)
        assert it.buckets == [3, 6]
        it2 = pkg.BucketSentenceIter(sents, 2, buckets=[4])
        assert sum(len(b) for b in it2.data) == 7


def test_encode_sentences_matches_jax():
    words = [["the", "cat", "sat"], ["a", "cat"], ["the", "dog", "ran"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 0},
               {"invalid_label": 0, "start_label": 1}):
        assert (trnn.encode_sentences(words, **kw)
                == jrnn.encode_sentences(words, **kw))
    _, vocab = trnn.encode_sentences(words)
    assert trnn.encode_sentences([["dog", "the"]], vocab=vocab)[0] == \
        jrnn.encode_sentences([["dog", "the"]], vocab=dict(vocab))[0]


# -- FusedRNN initializer and RNN checkpoints -----------------------------

@pytest.mark.parametrize("mode,bi", [("lstm", False), ("lstm", True),
                                     ("gru", True), ("rnn_tanh", False)])
def test_fused_rnn_initializer_matches_jax(mode, bi):
    """With a constant ``init`` both packages fill the packed vector the
    same (the LSTM forget slices at ``forget_bias``); with Xavier the
    forget slices match and every weight block is drawn at its own
    Xavier scale."""
    H, L, C = 4, 2, 3
    size = trnn_op.rnn_param_size(mode, C, H, L, bi)
    t = torch.zeros(size)
    tinit.FusedRNN(tinit.Constant(0.25), H, L, mode, bi, forget_bias=2.0)(
        tinit.InitDesc("f_parameters"), t)
    j = mx.nd.zeros((size,))
    mx.initializer.FusedRNN(mx.initializer.Constant(0.25), H, L, mode, bi,
                            forget_bias=2.0)(
        mx.initializer.InitDesc("f_parameters"), j)
    np.testing.assert_array_equal(t.numpy(), j.asnumpy())
    # the initializer's JSON round-trips through an __init__ attribute
    init = tinit.FusedRNN(tinit.Xavier(), H, L, mode, bi)
    assert init.dumps() == mx.initializer.FusedRNN(
        mx.initializer.Xavier(), H, L, mode, bi).dumps()
    mt.random.seed(3)
    x = torch.zeros(size)
    tinit.Uniform()(tinit.InitDesc("f_parameters",
                                   {"__init__": init.dumps()}), x)
    slices, _ = trnn_op._param_slices(mode, C, H, L, bi)
    for specs in slices.values():
        for k, (off, n, shape) in enumerate(specs):
            block = x[off:off + n].reshape(shape)
            if k < 2:
                bound = (3.0 / ((shape[0] + shape[1]) / 2.0)) ** 0.5
                assert 0 < block.abs().max() <= bound
            elif mode == "lstm":
                np.testing.assert_array_equal(block[H:2 * H].numpy(), 1.0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rnn_checkpoint_loads_in_the_other_package(writer, tmp_path):
    """``save_rnn_checkpoint`` packs a FusedRNNCell's unpacked weights into
    its ``parameters`` vector; ``load_rnn_checkpoint`` in the other
    package unpacks the same arrays."""
    rng = _rng("ckpt")
    T = 3
    _, js, _ = _unroll(mx, "fused-lstm-bi", T, 2, 4)
    jcell = _cells(mx, "fused-lstm-bi")
    tcell = _cells(mt, "fused-lstm-bi")
    flat = rng.standard_normal(
        trnn_op.rnn_param_size("lstm", 4, 5, 2, True)).astype(np.float32)
    unpacked = {n: v.asnumpy() for n, v in jcell.unpack_weights(
        {"f_parameters": mx.nd.array(flat)}).items()}
    aux = {}
    prefix = str(tmp_path / "rnn")
    if writer == "jax":
        mx.rnn.save_rnn_checkpoint(
            jcell, prefix, 3, js, {n: mx.nd.array(v)
                                   for n, v in unpacked.items()}, aux)
        sym, args, _ = trnn.load_rnn_checkpoint(tcell, prefix, 3)
    else:
        _, ts, _ = _unroll(mt, "fused-lstm-bi", T, 2, 4)
        trnn.save_rnn_checkpoint(
            tcell, prefix, 3, ts, {n: mt.nd.array(v, ctx=mt.cpu())
                                   for n, v in unpacked.items()}, aux)
        sym, args, _ = mx.rnn.load_rnn_checkpoint(jcell, prefix, 3)
    assert sorted(args) == sorted(unpacked)
    for n, v in unpacked.items():
        np.testing.assert_array_equal(args[n].asnumpy(), v)
    assert sym.list_arguments() == js.list_arguments()
    # the file holds the packed vector
    saved = (mt.nd.load("%s-0003.params" % prefix, ctx=mt.cpu())
             if writer == "jax" else mx.nd.load("%s-0003.params" % prefix))
    np.testing.assert_array_equal(saved["arg:f_parameters"].asnumpy(), flat)
