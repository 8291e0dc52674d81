"""Two-process ``Module.fit(kvstore="dist_sync")`` in the port against the
JAX package, and a three-process elastic drill of the port, on the CPU.

The port's ranks start through its own launcher (``python -m
mxnet_tpu_torch.tools.launch``), the JAX package's through
``tools/launch.py``, each run on a free port. Both fit the same symbol
from the same numpy initial parameters on the same per-rank shards
(``X[rank::2]``), with SGD and momentum at ``steps_per_dispatch`` 1 and 2.
Each package's ranks end with parameters bit for bit equal to each other
(the ring sums in member order; BatchNorm's moving statistics stay per
rank), and each rank's parameters and statistics in the port are held to
the JAX package's:
an MLP at ``rtol=1e-5``, a narrow conv net with BatchNorm (statistics per
rank, as in MXNet) at ``rtol=1e-4`` (``atol`` 1e-6 and 1e-5 for the values
near zero). A dist fit with no launcher environment equals the local fit
(``tests/test_torch_module.py``).

In one process, ``TrainStep.dist_reduce`` (the hook the dist kvstore's
``grad_reduce`` fills) takes the update set's gradients as one float32
vector a step: a reduce that doubles it equals doubling ``rescale_grad``
(``rtol=1e-6``), and a reduce that raises part-way through a K-step
dispatch leaves the pre-dispatch state bit for bit and raises its error.

The elastic drill kills rank 2 at its tenth ring collective
(``kv.worker_die``), with ``MXTPU_DIST_DEAD_FOR=5`` (2.5 heartbeats) and
``MXTPU_DIST_GRACE=10``: the two survivors re-form once and end with equal
parameter hashes. This file is also the worker (``python
tests/test_torch_dist_fit.py PKG MODEL K OUT``, ``PKG`` jax or torch, and
``elastic OUT``).
"""
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8     # per rank
N = 64        # samples


def _symbol(mx, model):
    data = mx.sym.Variable("data")
    if model == "mlp":
        net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
        net = mx.sym.Activation(net, act_type="relu", name="relu1")
        net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    else:
        net = mx.sym.Convolution(data, kernel=(3, 3), pad=(1, 1),
                                 num_filter=6, name="conv1")
        net = mx.sym.BatchNorm(net, name="bn1", fix_gamma=False)
        net = mx.sym.Activation(net, act_type="relu", name="relu1")
        net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                             pool_type="max", name="pool1")
        net = mx.sym.Flatten(net, name="flat")
        net = mx.sym.FullyConnected(net, num_hidden=4, name="fc1")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _data(model):
    rs = np.random.RandomState(3)
    shape = (N, 10) if model == "mlp" else (N, 3, 6, 6)
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(int(np.prod(shape[1:])), 4).astype(np.float32)
    y = np.argmax(x.reshape(N, -1) @ w, axis=1).astype(np.float32)
    return x, y


def _init(arg_shapes, aux_names):
    rs = np.random.RandomState(7)
    args = {n: (rs.randn(*s) * 0.3).astype(np.float32)
            for n, s in sorted(arg_shapes.items())}
    aux = {}
    for n in aux_names:
        c = arg_shapes[n.replace("moving_mean", "gamma").replace(
            "moving_var", "gamma")][0]
        aux[n] = (np.zeros(c) if "mean" in n else np.ones(c)).astype(
            np.float32)
    return args, aux


def _fit_worker(pkg, model, k, out_dir):
    sys.path.insert(0, ROOT)
    if pkg == "jax":
        os.environ.pop("XLA_FLAGS", None)
        import jax
        jax.config.update("jax_platforms", "cpu")
        import mxnet_tpu as mx
        assert mx.tools_init_distributed()
        rank = jax.process_index()
        ctx, wrap = mx.cpu(), mx.nd.array
    else:
        import mxnet_tpu_torch as mx
        assert mx.tools_init_distributed()
        rank = mx.kvstore_server.plane()["rank"]
        ctx = mx.cpu()

        def wrap(a):
            return mx.nd.array(a, ctx=mx.cpu())
    sym = _symbol(mx, model)
    x, y = _data(model)
    dshape = (BATCH,) + x.shape[1:]
    arg_shapes, _, aux_shapes = sym.infer_shape(data=dshape)
    shapes = dict(zip(sym.list_arguments(), arg_shapes))
    params = {n: s for n, s in shapes.items()
              if n not in ("data", "softmax_label")}
    args, aux = _init(params, sym.list_auxiliary_states())
    mod = mx.mod.Module(sym, context=ctx)
    it = mx.io.NDArrayIter(x[rank::2], y[rank::2], batch_size=BATCH)
    mod.fit(it, num_epoch=2, kvstore="dist_sync", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={n: wrap(v) for n, v in args.items()},
            aux_params={n: wrap(v) for n, v in aux.items()},
            steps_per_dispatch=k)
    a, b = mod.get_params()
    out = {"arg:" + n: v.asnumpy() for n, v in a.items()}
    out.update({"aux:" + n: v.asnumpy() for n, v in b.items()})
    np.savez(os.path.join(out_dir, "%s_r%d.npz" % (pkg, rank)), **out)


def _elastic_worker(out_dir):
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx
    assert mx.tools_init_distributed()
    rank = mx.kvstore_server.plane()["rank"]
    if rank == 2:
        mx.faults.inject("kv.worker_die", nth=10, kind="die")
    x, y = _data("mlp")

    class Shards(mx.io.NDArrayIter):
        def reshard_workers(self, index, size):
            Shards.__init__(self, x[index::size], y[index::size],
                            batch_size=BATCH)

    mod = mx.mod.Module(_symbol(mx, "mlp"), context=mx.cpu())
    mod.fit(Shards(x[rank::3], y[rank::3], batch_size=BATCH), num_epoch=4,
            kvstore="dist_sync", initializer=mx.initializer.Xavier(),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            checkpoint_prefix=os.path.join(out_dir, "r%d" % rank, "ck"))
    a, b = mod.get_params()
    h = hashlib.sha256()
    for n in sorted(a):
        h.update(n.encode() + a[n].asnumpy().tobytes())
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump({"hash": h.hexdigest(), "reforms": mod._kvstore.reforms,
                   "workers": mod._kvstore.num_workers}, f)
    # rank 0 hosts the store: its exit waits for the live peers'
    mx.kvstore_server._exit_sync()
    os._exit(0)


if __name__ == "__main__" and len(sys.argv) > 1:
    if sys.argv[1] == "elastic":
        _elastic_worker(sys.argv[2])
    else:
        _fit_worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
    sys.exit(0)

import pytest  # noqa: E402


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(pkg, args, n=2, env=None, timeout=240, check_rc=True):
    e = dict(os.environ)
    e.pop("XLA_FLAGS", None)
    e["JAX_PLATFORMS"] = "cpu"
    e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
    e.update(env or {})
    launcher = (["-m", "mxnet_tpu_torch.tools.launch"] if pkg == "torch"
                else [os.path.join(ROOT, "tools", "launch.py")])
    cmd = [sys.executable] + launcher + [
        "-n", str(n), "--coord-port", str(_free_port()),
        " ".join([sys.executable, os.path.abspath(__file__)] + args)]
    r = subprocess.run(cmd, env=e, capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT)
    if check_rc:
        assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return r


@pytest.mark.parametrize("model,k,tol", [
    ("mlp", 1, dict(rtol=1e-5, atol=1e-6)),
    ("mlp", 2, dict(rtol=1e-5, atol=1e-6)),
    ("bn", 1, dict(rtol=1e-4, atol=1e-5)),
])
def test_two_process_dist_sync_fit_matches_jax(model, k, tol, tmp_path):
    out = str(tmp_path)
    for pkg in ("torch", "jax"):
        _launch(pkg, [pkg, model, str(k), out])
    got = {(pkg, r): dict(np.load(os.path.join(out, "%s_r%d.npz"
                                               % (pkg, r))))
           for pkg in ("torch", "jax") for r in (0, 1)}
    for pkg in ("torch", "jax"):
        a, b = got[(pkg, 0)], got[(pkg, 1)]
        assert sorted(a) == sorted(b)
        for n in a:
            if n.startswith("arg:"):     # the moving statistics are per rank
                assert a[n].tobytes() == b[n].tobytes(), (pkg, n)
    for r in (0, 1):
        t, j = got[("torch", r)], got[("jax", r)]
        assert sorted(t) == sorted(j)
        for n in t:
            np.testing.assert_allclose(t[n], j[n], err_msg=n, **tol)
    assert sum(n.startswith("arg:") for n in t) >= 4


def test_three_process_elastic_drill_reforms_once(tmp_path):
    out = str(tmp_path)
    # the launcher exits with the killed rank's code (SIGKILL)
    r = _launch("torch", ["elastic", out], n=3, timeout=240, check_rc=False,
            env={"MXTPU_DIST_DEAD_FOR": "5", "MXTPU_DIST_GRACE": "10",
                 "MXTPU_KV_HEALTH_INTERVAL": "0.5"})
    assert r.returncode == 137, r.stdout[-4000:] + r.stderr[-4000:]
    res = {r: json.load(open(os.path.join(out, "rank%d.json" % r)))
           for r in (0, 1)}
    assert not os.path.exists(os.path.join(out, "rank2.json"))
    assert res[0]["hash"] == res[1]["hash"]
    assert res[0]["reforms"] == res[1]["reforms"] == 1
    assert res[0]["workers"] == res[1]["workers"] == 2


def _step_and_state():
    import mxnet_tpu_torch as mt
    sym = _symbol(mt, "mlp")
    x, y = _data("mlp")
    ts = mt.TrainStep(sym, learning_rate=0.1, momentum=0.9, device="cpu",
                      rescale_grad=1.0 / BATCH)
    st = ts.init({"data": (BATCH, 10)}, {"softmax_label": (BATCH,)},
                 seed=3)
    sb = {"data": x[:2 * BATCH].reshape(2, BATCH, 10),
          "softmax_label": y[:2 * BATCH].reshape(2, BATCH)}
    return mt, sym, ts, st, sb


def test_dist_reduce_takes_one_vector_a_step_before_the_update():
    mt, sym, ts, st, sb = _step_and_state()
    seen = []

    def double(vec):
        seen.append((vec.dtype, vec.shape))
        return vec * 2
    ts.dist_reduce = double
    ts.run_steps(st, sb)
    ref = mt.TrainStep(sym, learning_rate=0.1, momentum=0.9, device="cpu",
                       rescale_grad=2.0 / BATCH)
    st2 = ref.init({"data": (BATCH, 10)}, {"softmax_label": (BATCH,)},
                   seed=3)
    ref.run_steps(st2, sb)
    n = sum(int(np.prod(v.shape)) for v in st["params"].values())
    assert seen == [(np.float32, (n,))] * 2
    assert ts.dist_exchange["count"] == 2
    assert ts.dist_exchange["bytes"] == 2 * 4 * n
    for k in st["params"]:
        np.testing.assert_allclose(st["params"][k].numpy(),
                                   st2["params"][k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_ring_error_leaves_the_pre_dispatch_state():
    import torch
    mt, sym, ts, st, sb = _step_and_state()
    ts.run_steps(st, sb)              # momentum states that are not zero
    before = {k: v.clone() for k, v in st["params"].items()}
    opt_before = [t.clone() for t in st["opt"].values()
                  if isinstance(t, torch.Tensor)]
    step_before = int(st["step"])
    calls = []

    def fail_second(vec):
        calls.append(1)
        if len(calls) == 2:
            raise mt.kvstore.WorkerLostError("worker(s) [1] lost")
        return vec
    ts.dist_reduce = fail_second
    with pytest.raises(mt.kvstore.WorkerLostError, match=r"\[1\] lost"):
        ts.run_steps(st, sb)
    assert len(calls) == 2
    for k, v in st["params"].items():
        assert torch.equal(v, before[k]), k
    assert all(torch.equal(a, b) for a, b in zip(
        [t for t in st["opt"].values() if isinstance(t, torch.Tensor)],
        opt_before))
    assert int(st["step"]) == step_before
    calls.clear()
    ts.dist_reduce = lambda vec: (_ for _ in ()).throw(
        mt.kvstore.WorkerLostError("worker(s) [2] lost"))
    batch = {k: v[0] for k, v in sb.items()}
    with pytest.raises(mt.kvstore.WorkerLostError):
        ts.step(st, batch)
    for k, v in st["params"].items():
        assert torch.equal(v, before[k]), k
    assert int(st["step"]) == step_before
