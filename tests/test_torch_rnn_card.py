"""Variable-length training on the card, in small form: the RNN op on
``cuda:0`` against the same op on the CPU, and ``BucketingModule.fit`` at
``steps_per_dispatch`` 4 against 1 (``chip_smoke.py`` phase 16 runs both at
the full width of example/rnn/lstm_bucketing.py).

Checks:
- the RNN op (LSTM and GRU, unidirectional and bidirectional), outputs
  within ``atol=2e-5`` and gradients within 1e-4 of the largest gradient
  of the CPU's on the same inputs (float32 on both, TF32 off, summed in
  other orders through the time steps);
- an LSTM language model over two buckets through ``fit`` at K=4 ends on
  the parameters of K=1, bit for bit (phase 16 measured it so at full
  width), or else within 1e-3 of each parameter's norm: the K-step path
  and the single steps run the same step code, and only a backward whose
  sums are not bitwise repeatable (the embedding's accumulating
  index_put) could part them.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rnn_card.py -q

Without CUDA each test skips, with its reason.
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import rnn_op
from mxnet_tpu_torch.ops.registry import OpContext

V, E, H, L, B = 64, 16, 24, 2, 8


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the RNN op and BucketingModule "
                    "run on cuda:0 here (chip_smoke.py phase 16 runs this "
                    "path at full width)")


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


@pytest.mark.gpu
@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_op_card_matches_cpu(mode, bi):
    _need_card()
    rng = _rng("card-%s-%s" % (mode, bi))
    T, N, C = 20, 8, 12
    d = 2 if bi else 1
    size = rnn_op.rnn_param_size(mode, C, H, L, bi)
    ins = [rng.standard_normal((T, N, C)).astype(np.float32),
           (rng.uniform(-1, 1, size) / np.sqrt(H)).astype(np.float32),
           (0.5 * rng.standard_normal((L * d, N, H))).astype(np.float32)]
    if mode == "lstm":
        ins.append((0.5 * rng.standard_normal((L * d, N, H)))
                   .astype(np.float32))
    attrs = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bi,
                 state_outputs=True)
    res = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            leaves = [torch.from_numpy(i).to(dev).requires_grad_()
                      for i in ins]
            outs = rnn_op._rnn(OpContext(is_train=True), attrs, leaves, [])
            cots = [torch.from_numpy(_rng("cot").standard_normal(
                tuple(o.shape)).astype(np.float32)).to(dev) for o in outs]
            grads = torch.autograd.grad(outs, leaves, cots)
            res[dev] = ([o.detach().cpu().numpy() for o in outs],
                        [g.cpu().numpy() for g in grads])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(res["cuda"][0], res["cpu"][0]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def _sym_gen():
    cell = mt.rnn.FusedRNNCell(H, num_layers=L, mode="lstm", prefix="lstm_")

    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        emb = mt.sym.Embedding(data=data, input_dim=V, output_dim=E,
                               name="embed")
        outputs, _ = cell.unroll(seq_len, inputs=emb, layout="NTC",
                                 merge_outputs=True)
        pred = mt.sym.Reshape(data=outputs, shape=(-1, H))
        pred = mt.sym.FullyConnected(data=pred, num_hidden=V, name="pred")
        label_flat = mt.sym.Reshape(data=label, shape=(-1,))
        pred = mt.sym.SoftmaxOutput(data=pred, label=label_flat,
                                    name="softmax")
        return pred, ("data", "lstm_begin_state_0",
                      "lstm_begin_state_1"), ("softmax_label",)
    return sym_gen


def _iter(sentences):
    from mxnet_tpu_torch import random as trandom
    with trandom.scoped_np_rng(np.random.default_rng(5)):
        inner = mt.rnn.BucketSentenceIter(sentences, B, buckets=[6, 12],
                                          invalid_label=0)
    state = (L, B, H)

    class StateIter(mt.io.DataIter):
        def __init__(self):
            super().__init__(B)
            self.default_bucket_key = inner.default_bucket_key
            self.provide_data = list(inner.provide_data) + [
                mt.io.DataDesc("lstm_begin_state_0", state),
                mt.io.DataDesc("lstm_begin_state_1", state)]
            self.provide_label = inner.provide_label

        def reset(self):
            with trandom.scoped_np_rng(np.random.default_rng(6)):
                inner.reset()

        def next(self):
            b = inner.next()
            z = mt.nd.zeros(state, ctx=mt.cpu())
            b.data = list(b.data) + [z, z]
            b.provide_data = list(b.provide_data) + self.provide_data[1:]
            return b
    return StateIter()


@pytest.mark.gpu
def test_bucketing_fit_k4_equals_k1_on_card():
    _need_card()
    rng = _rng("fit")
    sentences = []
    for _ in range(96):
        n = int(rng.choice([5, 6, 11, 12]))
        s0 = int(rng.integers(1, V - 1))
        sentences.append([(s0 + t) % (V - 1) + 1 for t in range(n)])
    n = rnn_op.rnn_param_size("lstm", E, H, L, False)
    w = {"embed_weight": 0.3 * rng.standard_normal((V, E)),
         "lstm_parameters": 0.2 * rng.standard_normal(n),
         "pred_weight": 0.3 * rng.standard_normal((V, H)),
         "pred_bias": np.zeros(V)}
    params = {}
    for k in (1, 4):
        it = _iter(sentences)
        mod = mt.mod.BucketingModule(_sym_gen(),
                                     default_bucket_key=it.default_bucket_key,
                                     context=mt.gpu(0))
        metric = mt.metric.Perplexity(ignore_label=0)
        mod.fit(it, eval_metric=metric, num_epoch=2, optimizer="adam",
                optimizer_params={"learning_rate": 0.01},
                arg_params={k_: mt.nd.array(v.astype(np.float32),
                                            ctx=mt.cpu())
                            for k_, v in w.items()},
                steps_per_dispatch=k)
        assert mod._fused_state["params"]["pred_weight"].is_cuda
        assert np.isfinite(metric.get()[1])
        args, _ = mod.get_params()
        params[k] = {n_: v.asnumpy() for n_, v in args.items()}
    if all(np.array_equal(params[1][n_], params[4][n_]) for n_ in w):
        return
    for n_ in w:
        diff = np.linalg.norm(params[4][n_] - params[1][n_])
        assert diff <= 1e-3 * np.linalg.norm(params[1][n_]), n_
