"""The model-parallel LSTM language model of
``example/model-parallel-lstm/lstm.py`` in the port: its ``build_symbol``
rebuilt from the port's ``mt.rnn.LSTMCell`` and ``mt.AttrScope``, every
group on the 'model' axis of an 8-position CPU mesh, trained through
``TrainStep(group2ctx=)`` against the one-device port run and the JAX
package's run on the conftest's 8 virtual devices.

Sizes: the example's defaults but 2 layers (its ``--check`` test's):
sequence 16, hidden 128, embed 64, vocabulary 64, batch 32; Adam at lr
0.01 for 60 steps, from the JAX package's initial state. Tolerances: the
example's own ``--check`` bound, ``rtol=1e-4, atol=1e-4``, over the span it
checks: the first 10 losses, and the parameters after those 10 steps; the
loss falls by half over the 60. (Later, Adam's normalisation turns the
last-bit differences of near-zero gradients into whole steps of size lr,
as the example notes for any two partitionings.)
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.train_step import TrainStep as JTrainStep
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.train_step import TrainStep

T, LAYERS, HIDDEN, EMBED, VOCAB, BATCH = 16, 2, 128, 64, 64, 32
STEPS, LR = 60, 0.01
#: the steps after which the parameters are compared
SNAP = 10
CHECK = dict(rtol=1e-4, atol=1e-4)


def build_symbol(pkg, seq_len, num_layers, num_hidden, num_embed,
                 vocab_size, batch_size):
    """The example's stacked LSTM LM: layer k in ctx_group 'layer%d', the
    embedding in 'embed', the decoder in 'decode'; zero begin states are
    data inputs. Returns (symbol, state names)."""
    sym = pkg.sym
    with pkg.symbol.NameManager():
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        with pkg.AttrScope(ctx_group="embed"):
            embed = sym.Embedding(data, name="embed", input_dim=vocab_size,
                                  output_dim=num_embed)
        outputs = embed
        state_names = []
        for k in range(num_layers):
            with pkg.AttrScope(ctx_group="layer%d" % k):
                cell = pkg.rnn.LSTMCell(num_hidden, prefix="lstm%d_" % k)
                begin = cell.begin_state(shape=(batch_size, num_hidden))
                state_names += [s.name for s in begin]
                outs, _ = cell.unroll(seq_len, inputs=outputs,
                                      begin_state=begin, layout="NTC",
                                      merge_outputs=True)
            outputs = outs
        with pkg.AttrScope(ctx_group="decode"):
            flat = sym.Reshape(outputs, shape=(-1, num_hidden))
            pred = sym.FullyConnected(flat, name="pred",
                                      num_hidden=vocab_size)
            lab = sym.Reshape(label, shape=(-1,))
            out = sym.SoftmaxOutput(pred, lab, name="softmax")
    return out, state_names


def _corpus():
    """The example's next-token-predictable corpus (a shifted cycle)."""
    rng = np.random.default_rng(0)
    starts = rng.integers(1, VOCAB - 1, size=(BATCH,))
    seq = (starts[:, None] + np.arange(T + 1)) % (VOCAB - 1) + 1
    return seq[:, :-1].astype(np.float32), seq[:, 1:].astype(np.float32)


def _nll(prob, y):
    prob = np.asarray(prob).reshape(-1, VOCAB)
    return float(-np.log(np.maximum(
        prob[np.arange(prob.shape[0]), y.reshape(-1).astype(int)],
        1e-8)).mean())


@pytest.fixture(scope="module")
def runs():
    x, y = _corpus()
    g2c = {"embed": "model", "decode": "model"}
    g2c.update({"layer%d" % k: "model" for k in range(LAYERS)})
    jsym, names = build_symbol(mx, T, LAYERS, HIDDEN, EMBED, VOCAB, BATCH)
    tsym, tnames = build_symbol(mt, T, LAYERS, HIDDEN, EMBED, VOCAB, BATCH)
    assert tnames == names and tsym.tojson() == jsym.tojson()
    batch = {"data": x, "softmax_label": y}
    batch.update({n: np.zeros((BATCH, HIDDEN), np.float32) for n in names})
    shapes = {"data": (BATCH, T)}
    shapes.update({n: (BATCH, HIDDEN) for n in names})
    label = {"softmax_label": (BATCH, T)}
    kw = dict(data_names=["data"] + names, optimizer="adam",
              learning_rate=LR)
    jstep = JTrainStep(jsym, mesh=jmake_mesh({"model": 8}), group2ctx=g2c,
                       **kw)
    jst = jstep.init(shapes, label, seed=42)
    start = convert.to_reference_state(convert.from_reference_state(jst))
    out = {}
    jl = []
    for i in range(STEPS):
        jst, outs = jstep.step(jst, batch)
        jl.append(_nll(outs[0], y))
        if i + 1 == SNAP:
            jsnap = {n: np.asarray(v).copy() for n, v in jst["params"].items()}
    out["jax"] = (jl, jsnap)
    for tag, mesh, g in (("one", None, None),
                         ("mesh", tmesh.make_mesh({"model": 8}, ["cpu"] * 8),
                          g2c)):
        ts = TrainStep(tsym, mesh=mesh, group2ctx=g, device="cpu", **kw)
        ts.init(shapes, label)
        st = ts.replicate_state(convert.from_reference_state(start))
        losses = []
        for i in range(STEPS):
            st, outs = ts.step(st, batch)
            losses.append(_nll(outs[0].numpy(), y))
            if i + 1 == SNAP:
                snap = {n: v.numpy().copy() for n, v in
                        ts.whole_state(st)["params"].items()}
        out[tag] = (losses, snap, ts, st)
    return out


def test_lstm_weights_are_sharded_over_the_model_axis(runs):
    _, _, ts, st = runs["mesh"]
    assert len(ts.replica_states(st)) == 8
    # the (4H, D) i2h weight splits its gate dimension across the axis
    assert tuple(st["params"]["lstm0_i2h_weight"].shape) == (
        4 * HIDDEN // 8, EMBED)
    assert ts.param_spec("lstm1_h2h_weight") == ("model", None)


def test_mp_lstm_loss_falls_and_matches_one_device(runs):
    losses, params = runs["mesh"][:2]
    ref_losses, ref = runs["one"][:2]
    assert losses[-1] < losses[0] * 0.5, losses
    np.testing.assert_allclose(losses[:10], ref_losses[:10], **CHECK)
    for n in ref:
        np.testing.assert_allclose(params[n], ref[n], err_msg=n, **CHECK)


def test_mp_lstm_matches_the_jax_package(runs):
    losses, params = runs["mesh"][:2]
    jlosses, jparams = runs["jax"]
    np.testing.assert_allclose(losses[:10], jlosses[:10], **CHECK)
    for n in jparams:
        np.testing.assert_allclose(params[n], jparams[n], err_msg=n, **CHECK)
