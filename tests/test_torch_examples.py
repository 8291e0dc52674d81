"""The three examples that wait on this slice's ops, rebuilt in the port:
``example/autograd/mnist_autograd.py`` (``nd.log_softmax``),
``example/nce-loss/nce_lm.py`` (``sym.LogisticRegressionOutput``) and
``example/recommenders/matrix_fact.py`` (``sym.LinearRegressionOutput``).

Each example's graph and loop are rebuilt here with ``pkg`` standing for
either package, at the example's own sizes, and run through both on the
CPU from the same data and initial parameters: per-epoch losses are held
against the JAX package's run, and each run must pass the example's own
check (accuracy above 0.95; ranking accuracy of at least 0.95; holdout
RMSE below 0.35 of the label spread).

The JAX package's trained matrix-factorization parameters, carried across
by ``convert``, score the holdout in the port's module as in the JAX
package's.

Two things are fixed that the examples leave to each package's generator:
the iterators' one shuffle (``NDArrayIter(shuffle=True)`` draws from the
package's ``random.np_rng``, which differs between them) is taken as a
seeded permutation of the data, and the initial parameters (the examples'
``Normal(0.1)``) are drawn with numpy from a seed and given to both fits.

Tolerance: each epoch's loss (and the holdout RMSE) within
``rtol=1e-5``, the float32 bound of ``tests/test_torch_ops.py`` less the
atol: after 80 SGD steps and 750-768 Adam steps the two packages' losses
differ by at most 3.3e-7 of their value on this CPU.
"""
import numpy as np

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert

TOL = dict(rtol=1e-5, atol=0)


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
