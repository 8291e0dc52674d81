"""The eight examples the JAX package's tests run
(``tests/test_examples_r5.py`` and the autograd example), rebuilt in the
port: ``example/autograd/mnist_autograd.py`` (``nd.log_softmax``),
``example/nce-loss/nce_lm.py`` (``sym.LogisticRegressionOutput``),
``example/recommenders/matrix_fact.py`` (``sym.LinearRegressionOutput``),
``example/numpy-ops/numpy_softmax.py`` (a ``sym.Custom`` softmax loss
written in numpy through ``operator.CustomOp``),
``example/multi-task/multi_task.py`` (``sym.Group`` of two heads, a
custom iterator and ``EvalMetric``, the ``bind``/``forward``/``backward``/
``update`` loop), ``example/cnn_text_classification/text_cnn.py``,
``example/adversary/fgsm.py`` (an executor bound with a gradient array on
its input) and ``example/reinforcement-learning/reinforce.py``
(``autograd.train_section``, ``mark_variables``, ``compute_gradient``).
Each example's JAX run passes here.

Each example's graph and loop are rebuilt here with ``pkg`` standing for
either package, at the example's own sizes, and run through both on the
CPU from the same data and initial parameters: per-epoch losses (the
REINFORCE loop's per-iteration losses) are held against the JAX package's
run, and each run must pass the example's own check (accuracy above 0.95;
ranking accuracy of at least 0.95; holdout RMSE below 0.35 of the label
spread; text-cnn's holdout accuracy and REINFORCE's greedy accuracy of at
least 0.9; FGSM's clean accuracy of at least 0.95 falling by 0.3 or
more). text-cnn's dropout draws its masks from each package's generator,
so its losses are held with dropout 0 and the example as it is must pass
its check in both packages.

The JAX package's trained matrix-factorization parameters, carried across
by ``convert``, score the holdout in the port's module as in the JAX
package's.

``example/image-classification/train_imagenet.py``'s loop (records
written here, ``ImageRecordIter`` on the host route into a small resnet
through ``Module.fit``) is held at its own, wider tolerance: see
``test_train_imagenet_matches_jax_and_passes``.

Two things are fixed that the examples leave to each package's generator:
the iterators' one shuffle (``NDArrayIter(shuffle=True)`` draws from the
package's ``random.np_rng``, which differs between them) is taken as a
seeded permutation of the data, and the initial parameters (the examples'
``Normal(0.1)`` and ``Xavier()``) are drawn with numpy from a seed
(normal, biases 0) and given to both fits. A fit's epoch loss is the
cross-entropy of a forward over the training set at that epoch's
parameters.

Tolerance: each epoch's loss (and the holdout RMSE) within
``rtol=1e-5``, the float32 bound of ``tests/test_torch_ops.py`` less the
atol: after 80 SGD steps and 750-768 Adam steps the two packages' losses
differ by at most 3.3e-7 of their value on this CPU, and by at most 3.1e-6
over REINFORCE's 300 iterations (whose sampled actions agree exactly).
"""
import numpy as np

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert

TOL = dict(rtol=1e-5, atol=0)
#: train_imagenet's losses (see its test)
IMNET_TOL = dict(rtol=5e-2, atol=0)


# ---------------------------------------------------------------------------
# example/autograd/mnist_autograd.py
# ---------------------------------------------------------------------------

def mnist_data(rng, n=512, feat=32, classes=4):
    temps = rng.standard_normal((classes, feat)).astype(np.float32) * 2
    X = np.concatenate([t + rng.standard_normal(
        (n // classes, feat)).astype(np.float32) for t in temps])
    Y = np.repeat(np.arange(classes), n // classes)
    perm = rng.permutation(len(X))
    return X[perm], Y[perm].astype(np.int64)


def mnist_autograd(pkg, epochs=10):
    """The example's loop; returns each epoch's mean loss and the last
    epoch's accuracy."""
    nd, ag = pkg.nd, pkg.autograd
    ctx = pkg.cpu()
    rng = np.random.default_rng(0)
    X, Y = mnist_data(rng)
    feat, hidden, classes = X.shape[1], 64, 4
    params = {
        "w1": nd.array(rng.standard_normal((feat, hidden)).astype(
            np.float32) * 0.1, ctx=ctx),
        "b1": nd.zeros((hidden,), ctx=ctx),
        "w2": nd.array(rng.standard_normal((hidden, classes)).astype(
            np.float32) * 0.1, ctx=ctx),
        "b2": nd.zeros((classes,), ctx=ctx),
    }
    grads = {k: nd.zeros(v.shape, ctx=ctx) for k, v in params.items()}
    ag.mark_variables(list(params.values()), list(grads.values()))

    def net(x):
        h = nd.relu(nd.dot(x, params["w1"]) + params["b1"])
        return nd.dot(h, params["w2"]) + params["b2"]

    lr, batch = 0.1, 64
    losses = []
    for _ in range(epochs):
        total_loss, correct = 0.0, 0
        for i in range(0, len(X), batch):
            xb = nd.array(X[i:i + batch], ctx=ctx)
            yb = Y[i:i + batch]
            onehot = np.eye(classes, dtype=np.float32)[yb]
            with ag.train_section():
                logits = net(xb)
                logp = nd.log_softmax(logits, axis=1)
                loss = -nd.sum(logp * nd.array(onehot, ctx=ctx)) / len(yb)
            ag.compute_gradient([loss])
            for k in params:
                params[k][:] = params[k].asnumpy() - lr * grads[k].asnumpy()
            total_loss += float(loss.asnumpy())
            correct += int((logits.asnumpy().argmax(1) == yb).sum())
        losses.append(total_loss / (len(X) // batch))
    return losses, correct / len(X)


# ---------------------------------------------------------------------------
# example/nce-loss/nce_lm.py
# ---------------------------------------------------------------------------

def nce_net(pkg, vocab, dim):
    sym = pkg.sym
    data, cand = sym.Variable("data"), sym.Variable("cand")
    label = sym.Variable("nce_label")
    in_emb = sym.Embedding(data, input_dim=vocab, output_dim=dim,
                           name="in_emb")
    out_emb = sym.Embedding(cand, input_dim=vocab, output_dim=dim,
                            name="out_emb")
    ctx = sym.Reshape(in_emb, shape=(-1, 1, dim))
    scores = sym.sum(sym.broadcast_mul(out_emb, ctx), axis=2)
    return sym.LogisticRegressionOutput(data=scores, label=label, name="nce")


def nce_lm(pkg, num_epoch=12, batch=64):
    """The example's fit; returns each epoch's training loss (the mean
    binary cross-entropy of the NCE scores) and its ranking accuracy."""
    rng = np.random.RandomState(0)
    vocab, dim, k_noise, n = 50, 16, 8, 4096
    centers = rng.randint(0, vocab, n)
    true_next = (centers + 1) % vocab
    cand = np.concatenate(
        [true_next[:, None], rng.randint(0, vocab, (n, k_noise))], axis=1)
    labels = np.zeros((n, 1 + k_noise), np.float32)
    labels[:, 0] = 1.0
    init = np.random.RandomState(1)
    arg_params = {k: pkg.nd.array(init.normal(0, 0.1, (vocab, dim)).astype(
        np.float32), ctx=pkg.cpu()) for k in ("in_emb_weight",
                                              "out_emb_weight")}
    perm = np.random.RandomState(2).permutation(n)
    it = pkg.io.NDArrayIter(
        {"data": centers[perm].astype(np.float32),
         "cand": cand[perm].astype(np.float32)},
        {"nce_label": labels[perm]}, batch_size=batch)
    losses = []

    def epoch_loss(epoch, symbol, args, aux):
        w_in = args["in_emb_weight"].asnumpy()
        w_out = args["out_emb_weight"].asnumpy()
        s = (w_in[centers][:, None, :] * w_out[cand]).sum(2)
        p = np.clip(1 / (1 + np.exp(-s)), 1e-7, 1 - 1e-7)
        losses.append(float(-(labels * np.log(p) + (1 - labels)
                              * np.log(1 - p)).mean()))

    mod = pkg.mod.Module(nce_net(pkg, vocab, dim), data_names=("data", "cand"),
                         label_names=("nce_label",), context=pkg.cpu())
    mod.fit(it, num_epoch=num_epoch, optimizer="adam",
            optimizer_params={"learning_rate": 0.02},
            arg_params=arg_params, epoch_end_callback=epoch_loss)
    args, _ = mod.get_params()
    w_in = args["in_emb_weight"].asnumpy()
    w_out = args["out_emb_weight"].asnumpy()
    test_c = rng.randint(0, vocab, 512)
    pos = (test_c + 1) % vocab
    neg = (test_c + 1 + rng.randint(1, vocab - 1, 512)) % vocab
    s_pos = (w_in[test_c] * w_out[pos]).sum(1)
    s_neg = (w_in[test_c] * w_out[neg]).sum(1)
    return losses, float((s_pos > s_neg).mean())


# ---------------------------------------------------------------------------
# example/recommenders/matrix_fact.py
# ---------------------------------------------------------------------------

def mf_net(pkg, n_users, n_items, k):
    sym = pkg.sym
    user, item = sym.Variable("user"), sym.Variable("item")
    score = sym.Variable("score_label")
    u = sym.Embedding(user, input_dim=n_users, output_dim=k, name="user_emb")
    v = sym.Embedding(item, input_dim=n_items, output_dim=k, name="item_emb")
    pred = sym.sum(u * v, axis=1)
    return sym.LinearRegressionOutput(data=pred, label=score, name="lro")


def matrix_fact(pkg, num_epoch=15, batch=64):
    """The example's fit; returns each epoch's training RMSE (from the
    epoch's parameters over the training ratings), the holdout RMSE and
    the label spread it must beat."""
    rng = np.random.RandomState(0)
    n_users, n_items, k = 60, 40, 6
    U = rng.randn(n_users, k).astype(np.float32) * 0.8
    V = rng.randn(n_items, k).astype(np.float32) * 0.8
    n_obs = 4000
    users = rng.randint(0, n_users, n_obs).astype(np.float32)
    items = rng.randint(0, n_items, n_obs).astype(np.float32)
    ratings = ((U[users.astype(int)] * V[items.astype(int)]).sum(1)
               + rng.randn(n_obs).astype(np.float32) * 0.1)
    init = np.random.RandomState(1)
    arg_params = {"user_emb_weight": init.normal(0, 0.1, (n_users, k)),
                  "item_emb_weight": init.normal(0, 0.1, (n_items, k))}
    arg_params = {n: pkg.nd.array(v.astype(np.float32), ctx=pkg.cpu())
                  for n, v in arg_params.items()}
    perm = np.random.RandomState(2).permutation(3200)
    it = pkg.io.NDArrayIter({"user": users[:3200][perm],
                             "item": items[:3200][perm]},
                            {"score_label": ratings[:3200][perm]},
                            batch_size=batch)
    val = pkg.io.NDArrayIter({"user": users[3200:], "item": items[3200:]},
                             {"score_label": ratings[3200:]},
                             batch_size=batch)
    losses = []

    def epoch_rmse(epoch, symbol, args, aux):
        pu = args["user_emb_weight"].asnumpy()[users[:3200].astype(int)]
        pv = args["item_emb_weight"].asnumpy()[items[:3200].astype(int)]
        losses.append(float(np.sqrt((((pu * pv).sum(1)
                                      - ratings[:3200]) ** 2).mean())))

    mod = pkg.mod.Module(mf_net(pkg, n_users, n_items, k),
                         data_names=("user", "item"),
                         label_names=("score_label",), context=pkg.cpu())
    mod.fit(it, num_epoch=num_epoch, optimizer="adam",
            optimizer_params={"learning_rate": 0.02},
            arg_params=arg_params, eval_metric="rmse",
            epoch_end_callback=epoch_rmse)
    rmse = mod.score(val, pkg.metric.RMSE())[0][1]
    return losses, rmse, float(np.std(ratings[3200:])), mod, val


def test_mnist_autograd_matches_jax_and_passes():
    (jl, jacc), (tl, tacc) = mnist_autograd(mx), mnist_autograd(mt)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0] * 0.2
    assert tacc > 0.95 and jacc > 0.95


def test_nce_lm_matches_jax_and_passes():
    (jl, jacc), (tl, tacc) = nce_lm(mx), nce_lm(mt)
    assert len(tl) == len(jl) == 12
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    assert tacc >= 0.95, tacc
    assert abs(tacc - jacc) <= 0.02


def test_matrix_fact_matches_jax_and_passes():
    (jl, jrmse, base, jmod, _), (tl, trmse, tbase, tmod, tval) = \
        matrix_fact(mx), matrix_fact(mt)
    assert len(tl) == len(jl) == 15 and base == tbase
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(trmse, jrmse, **TOL)
    assert trmse < base * 0.35, (trmse, base)
    # the JAX package's trained parameters, carried by convert, score in
    # the port's module as they score in the JAX package's
    args, aux = convert.from_reference_params(*jmod.get_params())
    tmod.set_params({k: mt.nd.NDArray(v) for k, v in args.items()},
                    {k: mt.nd.NDArray(v) for k, v in aux.items()})
    tval.reset()
    np.testing.assert_allclose(tmod.score(tval, mt.metric.RMSE())[0][1],
                               jrmse, **TOL)


# ---------------------------------------------------------------------------
# the five examples of ROADMAP A.13: the same data, seeded permutations for
# the examples' shuffles and numpy-drawn initial parameters for their
# Xavier draws
# ---------------------------------------------------------------------------

def _on_cpu(example):
    """Run ``example(pkg, ...)`` with the CPU as ``pkg``'s default context
    (the port's default is the card), as the examples run on a host."""
    def run(pkg, *args, **kwargs):
        with pkg.cpu():
            return example(pkg, *args, **kwargs)
    run.__name__ = example.__name__
    return run


def _normal_params(pkg, shapes, seed, scale=0.1):
    """Initial parameters drawn with numpy from ``seed`` (weights
    ``normal(0, scale)``, biases 0), the same for both packages."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        v = (np.zeros(shape, np.float32) if name.endswith("_bias") else
             rng.normal(0, scale, shape).astype(np.float32))
        out[name] = pkg.nd.array(v, ctx=pkg.cpu())
    return out


def _param_shapes(sym, **shapes):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    return {n: s for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _train_ce(pkg, sym, args, aux, X, y):
    """The mean cross-entropy of the first output's class probabilities
    over ``X`` at ``args`` (a forward at inference, so dropout is off): one
    epoch's training loss."""
    exe = sym.simple_bind(pkg.cpu(), grad_req="null", data=X.shape,
                          softmax_label=y.shape)
    for k, v in args.items():
        if k in exe.arg_dict:
            exe.arg_dict[k][:] = v.asnumpy()
    for k, v in (aux or {}).items():
        exe.aux_dict[k][:] = v.asnumpy()
    exe.forward(is_train=False, data=pkg.nd.array(X),
                softmax_label=pkg.nd.array(y))
    p = exe.outputs[0].asnumpy()
    return float(-np.log(np.maximum(p[np.arange(len(y)), y.astype(int)],
                                    1e-30)).mean())


# example/numpy-ops/numpy_softmax.py ----------------------------------------

_CUSTOM = set()


def _register_numpy_softmax(pkg):
    """The example's softmax loss as a CustomOp written in numpy, under a
    name of this test's (the example registers ``numpy_softmax``)."""
    op = pkg.operator
    if pkg in _CUSTOM:
        return
    _CUSTOM.add(pkg)

    class NumpySoftmax(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().astype(np.int32)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], y / lab.shape[0])

    @op.register("examples_numpy_softmax")
    class NumpySoftmaxProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()


@_on_cpu
def numpy_softmax(pkg, num_epoch=10, batch=32):
    """The example's fit; returns each epoch's training loss and the
    training accuracy the example checks."""
    _register_numpy_softmax(pkg)
    rng = np.random.RandomState(0)
    n_class, dim = 6, 20
    templates = rng.randn(n_class, dim).astype(np.float32) * 2
    labels = np.arange(n_class * 64) % n_class
    X = templates[labels] + rng.randn(len(labels), dim).astype(
        np.float32) * .4
    y = labels.astype(np.float32)
    sym = pkg.sym
    net = sym.Custom(data=sym.FullyConnected(sym.Variable("data"),
                                             num_hidden=n_class, name="fc"),
                     label=sym.Variable("softmax_label"),
                     op_type="examples_numpy_softmax", name="softmax")
    params = _normal_params(pkg, _param_shapes(
        net, data=(batch, dim), softmax_label=(batch,)), 10)
    perm = np.random.RandomState(11).permutation(len(X))
    losses = []
    mod = pkg.mod.Module(net, label_names=("softmax_label",),
                         context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(X[perm], y[perm], batch_size=batch,
                               label_name="softmax_label"),
            num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5}, arg_params=params,
            epoch_end_callback=lambda e, s, a, x: losses.append(
                _train_ce(pkg, net, a, x, X, y)))
    acc = mod.score(pkg.io.NDArrayIter(X, y, batch_size=batch,
                                       label_name="softmax_label"),
                    pkg.metric.Accuracy())[0][1]
    return losses, acc


# example/multi-task/multi_task.py ------------------------------------------

@_on_cpu
def multi_task(pkg, num_epoch=12, batch=32):
    """The example's bind/forward/backward/update loop over two heads
    (``sym.Group``) with its per-head ``EvalMetric``; returns each epoch's
    summed cross-entropy of the two heads and the accuracies it checks."""
    rng = np.random.RandomState(0)
    n_class, dim = 6, 24
    templates = rng.randn(n_class, dim).astype(np.float32) * 2
    labels = np.arange(n_class * 64) % n_class
    X = templates[labels] + rng.randn(len(labels), dim).astype(
        np.float32) * .4
    y = labels.astype(np.float32)
    sym, io = pkg.sym, pkg.io

    class MultiTaskIter(io.DataIter):
        def __init__(self):
            super().__init__(batch)
            self._it = io.NDArrayIter(X, y, batch_size=batch)

        @property
        def provide_data(self):
            return self._it.provide_data

        @property
        def provide_label(self):
            (_, shape), = self._it.provide_label
            return [("softmax1_label", shape), ("softmax2_label", shape)]

        def reset(self):
            self._it.reset()

        def next(self):
            b = self._it.next()
            cls = b.label[0]
            return io.DataBatch(data=b.data, label=[
                cls, pkg.nd.array(cls.asnumpy() % 2)], pad=b.pad,
                index=b.index)

    class MultiAccuracy(pkg.metric.EvalMetric):
        def __init__(self, num=2):
            super().__init__("multi-accuracy", num=num)

        def update(self, labels, preds):
            for i in range(self.num):
                pred = preds[i].asnumpy().argmax(axis=1)
                lab = labels[i].asnumpy().astype(np.int64)
                self.sum_metric[i] += float((pred == lab).sum())
                self.num_inst[i] += len(lab)

    body = sym.Activation(sym.FullyConnected(
        sym.Variable("data"), num_hidden=64, name="fc_body"),
        act_type="relu")
    net = sym.Group([
        sym.SoftmaxOutput(sym.FullyConnected(body, num_hidden=n_class,
                                             name="fc1"), name="softmax1"),
        sym.SoftmaxOutput(sym.FullyConnected(body, num_hidden=2,
                                             name="fc2"), name="softmax2")])
    mod = pkg.mod.Module(net, label_names=("softmax1_label",
                                           "softmax2_label"),
                         context=pkg.cpu())
    it = MultiTaskIter()
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=_normal_params(
        pkg, _param_shapes(net, data=(batch, dim)), 20))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.2})
    metric = MultiAccuracy()
    losses = []
    for _ in range(num_epoch):
        it.reset()
        metric.reset()
        ce = 0.0
        for b in it:
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            outs = mod.get_outputs()
            metric.update(b.label, outs)
            for o, lab in zip(outs, b.label):
                p = o.asnumpy()
                ce -= np.log(p[np.arange(len(p)),
                               lab.asnumpy().astype(int)]).sum()
        losses.append(ce / len(X))
    return losses, metric.get()[1]


# example/cnn_text_classification/text_cnn.py -------------------------------

def text_cnn_net(pkg, vocab_size, num_embed, seq_len, filter_widths,
                 num_filter, n_class, dropout):
    sym = pkg.sym
    embed = sym.Embedding(sym.Variable("data"), input_dim=vocab_size,
                          output_dim=num_embed, name="embed")
    conv_in = sym.Reshape(embed, shape=(-1, 1, seq_len, num_embed))
    pooled = []
    for w in filter_widths:
        act = sym.Activation(sym.Convolution(
            conv_in, kernel=(w, num_embed), num_filter=num_filter,
            name="conv%d" % w), act_type="relu")
        pooled.append(sym.Pooling(act, kernel=(seq_len - w + 1, 1),
                                  pool_type="max", name="pool%d" % w))
    flat = sym.Flatten(sym.Concat(*pooled, dim=1))
    drop = sym.Dropout(flat, p=dropout)
    return sym.SoftmaxOutput(sym.FullyConnected(drop, num_hidden=n_class,
                                                name="fc"), name="softmax")


def text_cnn_corpus(n_sent, seq_len, vocab_size, n_class, rng):
    X = rng.randint(10, vocab_size, size=(n_sent, seq_len))
    y = rng.randint(0, n_class, size=n_sent)
    for i in range(n_sent):
        pos = rng.randint(0, seq_len - 3)
        X[i, pos:pos + 3] = [y[i] + 1, y[i] + 2, y[i] + 3]
    return X.astype(np.float32), y.astype(np.float32)


@_on_cpu
def text_cnn(pkg, dropout=0.25, num_epoch=8, batch=32):
    """The example's fit; returns each epoch's training loss and the
    holdout accuracy it checks."""
    rng = np.random.RandomState(3)
    vocab_size, num_embed, seq_len, n_class = 40, 16, 12, 4
    X, y = text_cnn_corpus(640, seq_len, vocab_size, n_class, rng)
    Xv, yv = text_cnn_corpus(160, seq_len, vocab_size, n_class, rng)
    net = text_cnn_net(pkg, vocab_size, num_embed, seq_len, (3, 4), 16,
                       n_class, dropout)
    params = _normal_params(pkg, _param_shapes(net, data=(batch, seq_len)),
                            30)
    perm = np.random.RandomState(31).permutation(len(X))
    losses = []
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(X[perm], y[perm], batch_size=batch),
            num_epoch=num_epoch, optimizer="adam",
            optimizer_params={"learning_rate": 0.005}, arg_params=params,
            epoch_end_callback=lambda e, s, a, x: losses.append(
                _train_ce(pkg, net, a, x, X, y)))
    acc = mod.score(pkg.io.NDArrayIter(Xv, yv, batch_size=batch),
                    pkg.metric.Accuracy())[0][1]
    return losses, acc


# example/adversary/fgsm.py -------------------------------------------------

@_on_cpu
def fgsm(pkg, num_epoch=4, batch=64, eps=1.0):
    """The example: train, bind an executor with a gradient array on
    ``data``, perturb each batch by ``eps * sign(dL/dx)``; returns each
    epoch's training loss and the clean and adversarial accuracies it
    checks."""
    nd, sym = pkg.nd, pkg.sym
    rng = np.random.RandomState(0)
    n_class, dim = 5, 16
    templates = rng.randn(n_class, dim).astype(np.float32) * 1.2
    labels = np.arange(n_class * 80) % n_class
    X = templates[labels] + rng.randn(len(labels), dim).astype(
        np.float32) * .3
    y = labels.astype(np.float32)
    h = sym.Activation(sym.FullyConnected(sym.Variable("data"),
                                          num_hidden=48, name="fc1"),
                       act_type="relu")
    net = sym.SoftmaxOutput(sym.FullyConnected(h, num_hidden=n_class,
                                               name="fc2"), name="softmax")
    params = _normal_params(pkg, _param_shapes(net, data=(batch, dim)), 40,
                            scale=0.3)
    perm = np.random.RandomState(41).permutation(len(X))
    losses = []
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(X[perm], y[perm], batch_size=batch),
            num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1}, arg_params=params,
            epoch_end_callback=lambda e, s, a, x: losses.append(
                _train_ce(pkg, net, a, x, X, y)))
    arg_params, aux_params = mod.get_params()
    args = {"data": nd.array(X[:batch]), "softmax_label": nd.array(y[:batch])}
    args.update(arg_params)
    exe = net.bind(pkg.cpu(), args, args_grad={"data": nd.zeros(
        (batch, dim))}, grad_req="write", aux_states=aux_params)

    def batch_acc(xb, yb):
        exe.arg_dict["data"][:] = xb
        exe.forward(is_train=False)
        return float((exe.outputs[0].asnumpy().argmax(axis=1) == yb).mean())

    clean = adv = 0.0
    n = 0
    for s in range(0, len(X) - batch + 1, batch):
        xb, yb = X[s:s + batch], y[s:s + batch]
        exe.arg_dict["data"][:] = xb
        exe.arg_dict["softmax_label"][:] = yb
        exe.forward(is_train=True)
        exe.backward()
        gsign = np.sign(exe.grad_dict["data"].asnumpy())
        clean += batch_acc(xb, yb)
        adv += batch_acc(xb + eps * gsign, yb)
        n += 1
    return losses, clean / n, adv / n


# example/reinforcement-learning/reinforce.py -------------------------------

@_on_cpu
def reinforce(pkg, iters=300, batch=128, lr=0.5, seed=0):
    """The example's imperative REINFORCE loop (``train_section``,
    ``mark_variables``, ``compute_gradient``, actions sampled on the host
    from the policy's probabilities); returns each iteration's loss, the
    last batch's mean reward and the greedy policy's accuracy it checks."""
    nd, autograd = pkg.nd, pkg.autograd
    rng = np.random.RandomState(seed)
    n_state, n_arm, hidden = 16, 4, 32
    W1 = nd.array(rng.randn(n_state, hidden).astype(np.float32) * 0.3)
    W2 = nd.array(rng.randn(hidden, n_arm).astype(np.float32) * 0.3)
    G1, G2 = nd.zeros(W1.shape), nd.zeros(W2.shape)
    autograd.mark_variables([W1, W2], [G1, G2])

    def one_hot(idx, n):
        out = np.zeros((len(idx), n), np.float32)
        out[np.arange(len(idx)), idx] = 1.0
        return out

    baseline, losses = 0.0, []
    for _ in range(iters):
        states = rng.randint(0, n_state, batch)
        X = nd.array(one_hot(states, n_state))
        with autograd.train_section():
            h = nd.maximum(nd.dot(X, W1), nd.zeros((batch, hidden)))
            probs = nd.softmax(nd.dot(h, W2))
            p = probs.asnumpy()
            actions = np.array([rng.choice(n_arm, p=pi / pi.sum())
                                for pi in p])
            rewards = (actions == (states % n_arm)).astype(np.float32)
            adv = rewards - baseline
            picked = nd.sum(probs * nd.array(one_hot(actions, n_arm)),
                            axis=1)
            loss = nd.sum(nd.log(picked + 1e-8) * nd.array(-adv / batch))
        autograd.compute_gradient([loss])
        W1[:] = W1.asnumpy() - lr * G1.asnumpy()
        W2[:] = W2.asnumpy() - lr * G2.asnumpy()
        baseline = 0.9 * baseline + 0.1 * rewards.mean()
        losses.append(float(loss.asnumpy()))
    states = np.arange(n_state).repeat(8)
    X = nd.array(one_hot(states, n_state))
    h = nd.maximum(nd.dot(X, W1), nd.zeros((len(states), hidden)))
    greedy = nd.dot(h, W2).asnumpy().argmax(1)
    return (losses, float(rewards.mean()),
            float((greedy == (states % n_arm)).mean()))


def test_numpy_softmax_matches_jax_and_passes():
    (jl, jacc), (tl, tacc) = numpy_softmax(mx), numpy_softmax(mt)
    assert len(tl) == len(jl) == 10
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tacc >= 0.95 and jacc >= 0.95


def test_multi_task_matches_jax_and_passes():
    (jl, jaccs), (tl, taccs) = multi_task(mx), multi_task(mt)
    assert len(tl) == len(jl) == 12
    np.testing.assert_allclose(tl, jl, **TOL)
    assert min(taccs) >= 0.95 and min(jaccs) >= 0.95


def test_text_cnn_matches_jax_and_passes():
    """Dropout draws its masks from each package's generator, so the
    losses are held with the example's dropout at 0 (its graph otherwise
    as it is); the example itself (dropout 0.25) must pass its check in
    both packages."""
    (jl, _), (tl, _) = text_cnn(mx, dropout=0.0), text_cnn(mt, dropout=0.0)
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, **TOL)
    (jl, jacc), (tl, tacc) = text_cnn(mx), text_cnn(mt)
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    assert tacc >= 0.9 and jacc >= 0.9


def test_fgsm_matches_jax_and_passes():
    (jl, jclean, jadv), (tl, tclean, tadv) = fgsm(mx), fgsm(mt)
    assert len(tl) == len(jl) == 4
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tclean >= 0.95 and tadv <= tclean - 0.3
    assert jclean >= 0.95 and jadv <= jclean - 0.3
    assert (tclean, tadv) == (jclean, jadv)


def test_reinforce_matches_jax_and_passes():
    (jl, jr, jacc), (tl, tr, tacc) = reinforce(mx), reinforce(mt)
    assert len(tl) == len(jl) == 300
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tr == jr
    assert tacc >= 0.9 and jacc >= 0.9


# example/image-classification/train_imagenet.py ---------------------------

_IMNET_NORM = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94,
                   std_r=58.395, std_g=57.12, std_b=57.375)


def imagenet_records(path, n=24, classes=4, h=40, w=48):
    """An indexed .rec of ``n`` JPEGs, written with Pillow from a numpy
    seed (the example reads tools/im2rec.py's records): a smooth random
    field on an 8-pixel grid whose mean colour is the class's."""
    import io as _bio
    from PIL import Image
    rng = np.random.RandomState(11)
    colors = rng.uniform(70, 185, (classes, 3))
    rec = mt.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        coarse = np.clip(colors[i % classes] + rng.normal(
            0, 50, (h // 8 + 2, w // 8 + 2, 3)), 0, 255).astype(np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        buf = _bio.BytesIO()
        img.save(buf, format="JPEG", quality=90)
        rec.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(i % classes), i, 0),
            buf.getvalue()))
    rec.close()
    return path


def _he_params(pkg, sym, dshape, seed):
    """The example's Xavier(rnd_type="gaussian", factor_type="in",
    magnitude=2) drawn with numpy from ``seed`` (BatchNorm gamma 1, beta
    and biases 0, moving mean 0 and variance 1), the same for both
    packages."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=dshape)
    rng = np.random.RandomState(seed)
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            v = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            v = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(
                np.float32)
        args[name] = pkg.nd.array(v, ctx=pkg.cpu())
    aux = {name: pkg.nd.array(np.ones(shape, np.float32) if
                              name.endswith("_var") else
                              np.zeros(shape, np.float32), ctx=pkg.cpu())
           for name, shape in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


@_on_cpu
def train_imagenet(pkg, rec, num_epochs=3, batch=8, epoch_size=3):
    """The example's training loop at a small size: resnet (18 layers,
    3x32x32, 4 classes) from ``ImageRecordIter(shuffle, rand_crop,
    rand_mirror, resize)`` with its mean/std, SGD with momentum 0.9, wd
    1e-4 and a MultiFactorScheduler, metrics acc and top-2, Speedometer;
    returns each epoch's training loss over the records' center crops and
    the bytes of every batch the fit took."""
    image_shape = (3, 32, 32)
    net = pkg.models.get_symbol("resnet", num_classes=4, num_layers=18,
                                image_shape="3,32,32")
    kvstore = pkg.kv.create("local")
    host = {"device": "cpu"} if pkg is mt else {}
    train = pkg.image.ImageRecordIter(
        path_imgrec=rec, data_shape=image_shape, batch_size=batch,
        shuffle=True, rand_crop=True, rand_mirror=True, resize=36,
        part_index=kvstore.rank, num_parts=kvstore.num_workers, seed=3,
        **_IMNET_NORM, **host)
    fed = []
    take = train.next

    def next_batch():
        b = take()
        fed.append(b.data[0].asnumpy().tobytes()
                   + b.label[0].asnumpy().tobytes())
        return b
    train.next = next_batch
    evals = pkg.image.ImageRecordIter(
        path_imgrec=rec, data_shape=image_shape, batch_size=24, resize=36,
        **_IMNET_NORM, **host)
    b = evals.next()
    X, y = b.data[0].asnumpy(), b.label[0].asnumpy()
    evals.close()
    steps = [int(e) * epoch_size for e in "2,4".split(",")]
    lr_sched = pkg.lr_scheduler.MultiFactorScheduler(step=steps, factor=0.1)
    args, aux = _he_params(pkg, net, (batch,) + image_shape, 17)
    losses = []
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.fit(train, num_epoch=num_epochs,
            eval_metric=["acc", pkg.metric.TopKAccuracy(top_k=2)],
            initializer=pkg.initializer.Xavier(
                rnd_type="gaussian", factor_type="in", magnitude=2),
            arg_params=args, aux_params=aux, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4, "lr_scheduler": lr_sched},
            kvstore=kvstore,
            batch_end_callback=pkg.callback.Speedometer(batch, 20),
            epoch_end_callback=lambda e, s, a, x: losses.append(
                _batch_stats_ce(pkg, net, a, x, X, y)))
    train.close()
    return losses, fed


def _batch_stats_ce(pkg, net, args, aux, X, y):
    """The mean cross-entropy over ``X`` at ``args`` with BatchNorm on the
    batch's own statistics (a few steps leave the moving statistics near
    their initial values)."""
    exe = net.simple_bind(pkg.cpu(), grad_req="null", data=X.shape,
                          softmax_label=y.shape)
    exe.copy_params_from(args, aux)
    exe.forward(is_train=True, data=pkg.nd.array(X),
                softmax_label=pkg.nd.array(y))
    p = exe.outputs[0].asnumpy()
    return float(-np.log(np.maximum(p[np.arange(len(y)), y.astype(int)],
                                    1e-30)).mean())


def test_train_imagenet_matches_jax_and_passes(tmp_path):
    """Both fits take the same batches, bit for bit (the port's host route
    of ImageRecordIter; tests/test_torch_image.py holds it across
    options), from the same initial parameters. The epoch losses are held
    within ``IMNET_TOL``: on such JPEG batches a ReLU input rounds to the
    other side of 0 in one package's float32 and not in the other's (on a
    batch of 8 of these records: one element of stage4_unit2_1's
    BatchNorm output, which moves that unit's conv-weight gradient by 17%
    of its largest value in the port, while the JAX package flips others
    in stage1; each package's gradients are otherwise within 1e-5 of a
    float64 run), and nine steps at lr 0.1 with momentum carry that on: the
    losses measured here differ by at most 1.0%."""
    rec = imagenet_records(str(tmp_path / "train.rec"))
    (jl, jfed), (tl, tfed) = train_imagenet(mx, rec), train_imagenet(mt, rec)
    assert len(tfed) == len(jfed) == 9 and tfed == jfed
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, **IMNET_TOL)
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
