"""group2ctx model parallelism and ``param_shardings`` in the port
(``parallel.placement``, the executor's walk by partition spec,
``TrainStep(group2ctx=, param_shardings=)``) against the JAX package's
(``tests/test_model_parallel.py``) on the conftest's 8 virtual CPU
devices, the port over a CPU mesh of as many positions.

The same numpy inputs and weights (from a seed) go through both packages.
Tolerances, as the JAX package's own tests state them:
- forward outputs: ``rtol=1e-5, atol=1e-6``;
- gradients and 5 SGD steps: ``rtol=1e-4, atol=1e-5``;
- placement, specs, shard shapes and error messages: exact.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.parallel import MeshScope as JMeshScope
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.placement import param_groups as jparam_groups
from mxnet_tpu.symbol import _topo as jtopo
from mxnet_tpu.train_step import TrainStep as JTrainStep
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel.mesh import MeshScope, NamedSharding, P
from mxnet_tpu_torch.parallel.placement import param_groups
from mxnet_tpu_torch.symbol import _topo
from mxnet_tpu_torch.train_step import TrainStep

JP = jax.sharding.PartitionSpec
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _mesh(shape):
    return tmesh.make_mesh(shape, ["cpu"] * int(np.prod(list(
        shape.values()))))


def _two_group_mlp(pkg):
    """Front half in group 'dev1', classifier in group 'dev2'."""
    with pkg.symbol.NameManager():
        data = pkg.sym.Variable("data")
        with pkg.AttrScope(ctx_group="dev1"):
            h = pkg.sym.FullyConnected(data, name="fc1", num_hidden=64)
            h = pkg.sym.Activation(h, name="relu1", act_type="relu")
        with pkg.AttrScope(ctx_group="dev2"):
            h = pkg.sym.FullyConnected(h, name="fc2", num_hidden=32)
            return pkg.sym.SoftmaxOutput(h, name="softmax")


def _params(exe, seed):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*a.shape) * 0.1).astype(np.float32)
            for n, a in sorted(exe.arg_dict.items())
            if n not in ("data", "softmax_label")}


def test_attr_scope_nests_and_round_trips_ctx_group():
    """Nested scopes merge (the inner value wins), and a scope-built
    symbol's ``ctx_group`` survives the JSON round trip, in both
    packages alike."""
    out = {}
    for pkg in (mx, mt):
        with pkg.symbol.NameManager():
            with pkg.AttrScope(ctx_group="a", lr_mult="2"):
                with pkg.AttrScope(ctx_group="b"):
                    fc = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                                num_hidden=4, name="fc")
        back = pkg.sym.load_json(fc.tojson())
        out[pkg.__name__] = (fc.attr("ctx_group"), fc.attr("lr_mult"),
                             back.attr_dict()["fc"]["ctx_group"])
    assert out["mxnet_tpu_torch"] == out["mxnet_tpu"] == ("b", "2", "b")


def test_param_groups_propagate():
    jg = jparam_groups(jtopo(_two_group_mlp(mx)._out_nodes()))
    tg = param_groups(_topo(_two_group_mlp(mt)._out_nodes()))
    assert tg == jg
    assert tg["fc1_weight"] == "dev1" and tg["fc2_weight"] == "dev2"
    assert tg.get("data") == "dev1"


def test_group2ctx_numerics_match_single_device():
    np.random.seed(0)
    x = np.random.randn(16, 48).astype(np.float32)
    y = np.random.randint(0, 32, (16,)).astype(np.float32)
    outs = {}
    for tag, pkg, mesh, scope in (
            ("jax", mx, jmake_mesh({"model": 8}), JMeshScope),
            ("port", mt, _mesh({"model": 8}), MeshScope)):
        sym = _two_group_mlp(pkg)
        with scope(mesh):
            exe = sym.simple_bind(pkg.cpu(), data=(16, 48),
                                  softmax_label=(16,),
                                  group2ctx={"dev1": "model",
                                             "dev2": "model"})
        ref = sym.simple_bind(pkg.cpu(), data=(16, 48), softmax_label=(16,))
        params = _params(ref, 1)
        for e in (exe, ref):
            for n, v in params.items():
                e.arg_dict[n][:] = v
        outs[tag] = [e.forward(is_train=False, data=x, softmax_label=y)[0]
                     .asnumpy() for e in (exe, ref)]
    np.testing.assert_allclose(outs["port"][0], outs["port"][1], **FWD)
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], **FWD)


def test_group2ctx_backward_matches():
    np.random.seed(2)
    x = np.random.randn(8, 48).astype(np.float32)
    y = np.random.randint(0, 32, (8,)).astype(np.float32)
    grads = {}
    for tag, pkg, mesh, scope, spec in (
            ("jax", mx, jmake_mesh({"model": 8}), JMeshScope, JP),
            ("port", mt, _mesh({"model": 8}), MeshScope, P)):
        for mode, g2c in (("ref", None),
                          ("mp", {"dev1": "model",
                                  "dev2": spec(None, "model")})):
            sym = _two_group_mlp(pkg)
            with scope(mesh):
                exe = sym.simple_bind(pkg.cpu(), data=(8, 48),
                                      softmax_label=(8,), grad_req="write",
                                      group2ctx=g2c)
            for n, v in _params(exe, 3).items():
                exe.arg_dict[n][:] = v
            exe.forward(is_train=True, data=x, softmax_label=y)
            exe.backward()
            grads[tag, mode] = {n: exe.grad_dict[n].asnumpy()
                                for n in ("fc1_weight", "fc1_bias",
                                          "fc2_weight", "fc2_bias")}
    for n in grads["port", "ref"]:
        np.testing.assert_allclose(grads["port", "mp"][n],
                                   grads["port", "ref"][n], **GRAD)
        np.testing.assert_allclose(grads["port", "mp"][n],
                                   grads["jax", "mp"][n], **GRAD)


def test_fully_connected_runs_on_its_weight_shard():
    """The 'model' rule: a FullyConnected whose weight and bias split along
    the output dimension runs per position on the shard (its output split
    along the features); fed data split along the contraction dimension, it
    gathers the data only; a bias left whole sends it to the whole value."""
    from mxnet_tpu_torch.executor import spec_plan
    mesh = _mesh({"model": 8})
    net = _two_group_mlp(mt)
    fc1, fc2 = [n for n in _topo(net._out_nodes())
                if not n.is_variable and n.op.name == "FullyConnected"]

    def arr(shape, spec):
        return tmesh.split_spec(torch.zeros(shape), mesh, spec)
    x = arr((16, 48), ())
    w1, b1 = arr((64, 48), ("model",)), arr((64,), ("model",))
    assert spec_plan(fc1, [x, w1, b1], mesh) == (
        [[], [], []], [(None, "model")], [])
    h = arr((16, 64), (None, "model"))
    w2, b2 = arr((32, 64), ("model",)), arr((32,), ("model",))
    assert spec_plan(fc2, [h, w2, b2], mesh) == (
        [["model"], [], []], [(None, "model")], [])
    whole_bias = arr((32,), ())
    assert spec_plan(fc2, [h, w2, whole_bias], mesh) == (
        [["model"], ["model"], []], [(None, None)], [(0, "model", 1)])


def test_legacy_context_group2ctx_accepted():
    """Reference-style group2ctx={'dev1': cpu(0)} binds and runs on the
    bind device in both packages."""
    shapes = []
    for pkg in (mx, mt):
        exe = _two_group_mlp(pkg).simple_bind(
            pkg.cpu(), data=(4, 48), softmax_label=(4,),
            group2ctx={"dev1": pkg.cpu(0), "dev2": pkg.cpu(1)})
        exe.forward(is_train=False, data=np.zeros((4, 48), np.float32),
                    softmax_label=np.zeros((4,), np.float32))
        shapes.append(exe.outputs[0].shape)
    assert shapes[0] == shapes[1] == (4, 32)


def test_trainstep_group2ctx_trains():
    """TrainStep(group2ctx=) over model=8: grouped parameters shard, and 5
    SGD steps from the JAX package's initial state track the unsharded
    port step and the JAX package's sharded step."""
    np.random.seed(4)
    x = np.random.randn(32, 48).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    g2c = {"dev1": "model", "dev2": "model"}
    batch = {"data": x, "softmax_label": y}
    shapes = ({"data": (32, 48)}, {"softmax_label": (32,)})
    kw = dict(optimizer="sgd", learning_rate=0.1, momentum=0.0)
    jstep = JTrainStep(_two_group_mlp(mx), mesh=jmake_mesh({"model": 8}),
                       group2ctx=g2c, **kw)
    jst = jstep.init(*shapes, seed=7)
    start = convert.to_reference_state(convert.from_reference_state(jst))
    ts = TrainStep(_two_group_mlp(mt), mesh=_mesh({"model": 8}),
                   group2ctx=g2c, device="cpu", **kw)
    one = TrainStep(_two_group_mlp(mt), device="cpu", **kw)
    ts.init(*shapes)
    st = ts.replicate_state(convert.from_reference_state(start))
    ref = convert.from_reference_state(start)
    for _ in range(5):
        jst, _ = jstep.step(jst, batch)
        ts.step(st, batch)
        one.step(ref, batch)
    assert tuple(st["params"]["fc1_weight"].shape) == (8, 48)
    whole = ts.whole_state(st)
    for n in ref["params"]:
        got = whole["params"][n].numpy()
        np.testing.assert_allclose(got, ref["params"][n].numpy(), **GRAD)
        np.testing.assert_allclose(got, np.asarray(jst["params"][n]),
                                   **GRAD)


def test_grouped_parameter_and_its_optimizer_state_live_as_shards():
    """Each position holds its shard of a grouped parameter (first
    divisible dimension) and of its momentum; ``whole_state`` assembles
    them, and ``replicate_state`` of the whole state cuts them again."""
    ts = TrainStep(_two_group_mlp(mt), optimizer="sgd", momentum=0.9,
                   learning_rate=0.1, mesh=_mesh({"model": 8}),
                   group2ctx={"dev1": "model", "dev2": "model"},
                   device="cpu")
    st = ts.init({"data": (32, 48)}, {"softmax_label": (32,)}, seed=7)
    rng = np.random.RandomState(0)
    ts.step(st, {"data": rng.randn(32, 48).astype(np.float32),
                 "softmax_label": rng.randint(0, 32, 32).astype(np.float32)})
    reps = ts.replica_states(st)
    assert len(reps) == 8
    for n, shard in (("fc1_weight", (8, 48)), ("fc1_bias", (8,)),
                     ("fc2_weight", (4, 64)), ("fc2_bias", (4,))):
        for rep in reps:
            assert tuple(rep["params"][n].shape) == shard
            assert tuple(rep["opt"][n].shape) == shard
    assert ts.param_spec("fc1_weight") == ("model", None)
    whole = ts.whole_state(st)
    assert tuple(whole["params"]["fc1_weight"].shape) == (64, 48)
    assert tuple(whole["opt"]["fc1_weight"].shape) == (64, 48)
    for r, rep in enumerate(reps):
        np.testing.assert_array_equal(
            rep["opt"]["fc2_weight"].numpy(),
            whole["opt"]["fc2_weight"].numpy()[4 * r:4 * (r + 1)])
    again = ts.replicate_state({k: v for k, v in whole.items()})
    for a, b in zip(ts.replica_states(again), reps):
        for n in ("fc1_weight", "fc2_bias"):
            assert torch.equal(a["params"][n], b["params"][n])
            assert torch.equal(a["opt"][n], b["opt"][n])


def test_param_shardings_beat_the_group_spec():
    """An explicit ``param_shardings`` entry wins over the group's spec
    (here: replicated), as ``TrainStep._param_spec`` of the JAX package."""
    ts = TrainStep(_two_group_mlp(mt), learning_rate=0.1, device="cpu",
                   mesh=_mesh({"model": 8}),
                   group2ctx={"dev1": "model", "dev2": "model"},
                   param_shardings={"fc1_weight": P(),
                                    "fc2_weight": P(None, "model")})
    st = ts.init({"data": (32, 48)}, {"softmax_label": (32,)}, seed=7)
    assert tuple(st["params"]["fc1_weight"].shape) == (64, 48)
    assert tuple(st["params"]["fc2_weight"].shape) == (32, 8)
    assert tuple(st["params"]["fc1_bias"].shape) == (8,)
    with pytest.raises(MXNetError, match="names axis 'seq'"):
        TrainStep(_two_group_mlp(mt), device="cpu", mesh=_mesh({"model": 2}),
                  param_shardings={"fc1_weight": P("seq")})


def _seq_lm_step(sum_fn=None):
    """Two SGD steps of a small LM over data=2 x seq=2 (ring attention,
    every weight replicated) and on one device; with ``sum_fn`` the mesh
    step sums gradients with it instead."""
    import mxnet_tpu_torch.train_step as tsmod
    V, E, H, S, B = 32, 16, 2, 8, 4
    rng = np.random.RandomState(9)
    batch = {"data": rng.randint(0, V, (B, S)).astype(np.float32),
             "softmax_label": rng.randint(0, V, (B, S)).astype(np.float32)}
    out = []
    for mesh in (None, _mesh({"data": 2, "seq": 2})):
        sym = mt.models.transformer(vocab_size=V, embed=E, num_heads=H,
                                    num_layers=1, seq_len=S,
                                    seq_parallel="ring" if mesh else "",
                                    preserve_shape=True)
        ts = TrainStep(sym, learning_rate=0.1, momentum=0.0, mesh=mesh,
                       device="cpu")
        st = ts.init({"data": (B, S)}, {"softmax_label": (B, S)}, seed=2)
        saved = tsmod.shard_grad_sums
        if mesh is not None and sum_fn is not None:
            tsmod.shard_grad_sums = sum_fn
        try:
            for _ in range(2):
                ts.step(st, batch)
        finally:
            tsmod.shard_grad_sums = saved
        out.append({n: v.numpy() for n, v in
                    ts.whole_state(st)["params"].items()})
    return out


def _data_only_sums(grads, mesh, spec):
    """The mistake the parity check must catch: each parameter's gradient
    summed over the 'data' axis only (as a 'data' mesh alone would)."""
    devs = mesh.replica_devices()
    out = list(grads)
    for grp in tmesh.axis_groups(mesh, "data"):
        summed = tmesh.all_reduce([grads[r] for r in grp],
                                  [devs[r] for r in grp])
        for r, g in zip(grp, summed):
            out[r] = g
    return out


def test_replicated_parameters_sum_over_every_axis():
    """Under 'seq', each sequence shard adds a partial gradient for every
    replicated weight: the step sums over 'data' and 'seq' and equals the
    one-device step (``rtol=1e-4``); summing over 'data' only leaves the
    replicated weights' updates off by the 'seq' size, which the same
    check catches."""
    ref, got = _seq_lm_step()
    for n in ref:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)
    ref, bad = _seq_lm_step(_data_only_sums)
    with pytest.raises(AssertionError):
        for n in ref:
            np.testing.assert_allclose(bad[n], ref[n], rtol=1e-4, atol=1e-6)


def test_group2ctx_bad_axis_raises_clearly():
    with MeshScope(_mesh({"data": 8})):
        with pytest.raises(MXNetError, match="model.*not in mesh"):
            _two_group_mlp(mt).simple_bind(
                mt.cpu(), data=(4, 48), softmax_label=(4,),
                group2ctx={"dev1": "model"})


def test_group2ctx_no_mesh_raises_clearly():
    with pytest.raises(mx.MXNetError) as jerr:
        JTrainStep(_two_group_mlp(mx), group2ctx={"dev1": "model"})
    with pytest.raises(MXNetError) as terr:
        TrainStep(_two_group_mlp(mt), group2ctx={"dev1": "model"},
                  device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "needs a device mesh" in str(terr.value)


def test_group2ctx_conflicting_meshes_rejected():
    ns = NamedSharding(_mesh({"data": 8}), P("data"))
    with MeshScope(_mesh({"model": 8})):
        with pytest.raises(MXNetError, match="share one mesh"):
            _two_group_mlp(mt).simple_bind(
                mt.cpu(), data=(16, 48), softmax_label=(16,),
                group2ctx={"dev1": "model", "dev2": ns})


def test_group2ctx_namedsharding_sets_mesh():
    """With no ambient mesh, NamedSharding values supply the mesh."""
    ns = NamedSharding(_mesh({"model": 8}), P("model"))
    exe = _two_group_mlp(mt).simple_bind(
        mt.cpu(), data=(16, 48), softmax_label=(16,),
        group2ctx={"dev1": ns, "dev2": ns})
    exe.forward(is_train=False, data=np.zeros((16, 48), np.float32),
                softmax_label=np.zeros((16,), np.float32))
    assert exe.outputs[0].shape == (16, 32)
    assert exe._mesh is ns.mesh
    assert exe._param_specs["fc1_weight"] == P("model")


def test_fusion_leaves_a_model_sharded_pair_unfused(monkeypatch):
    """``MXTPU_FUSE_CONV_BN=1`` under group2ctx: the Conv1x1->BatchNorm
    pair whose weight is split over 'model' stays unfused (the kernel
    never runs on a partial weight, as the JAX package disables the pass
    under placement); the training forward and gradients equal the JAX
    package's (``rtol=1e-4``)."""
    from mxnet_tpu_torch.ops import matmul_stats
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    calls = []
    real = matmul_stats.apply_conv1x1_stats
    monkeypatch.setattr(matmul_stats, "apply_conv1x1_stats",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.RandomState(8)
    x = rng.randn(4, 6, 6, 16).astype(np.float32)
    res = {}
    for tag, pkg, mesh, scope in (
            ("jax", mx, jmake_mesh({"model": 8}), JMeshScope),
            ("port", mt, _mesh({"model": 8}), MeshScope)):
        with pkg.symbol.NameManager():
            d = pkg.sym.Variable("data")
            with pkg.AttrScope(ctx_group="g"):
                c = pkg.sym.Convolution(d, num_filter=32, kernel=(1, 1),
                                        no_bias=True, layout="NHWC",
                                        name="conv")
                b = pkg.sym.BatchNorm(c, axis=3, fix_gamma=False, name="bn")
            net = pkg.sym.MakeLoss(pkg.sym.sum(pkg.sym.square(b)))
        with scope(mesh):
            exe = net.simple_bind(pkg.cpu(), data=x.shape,
                                  group2ctx={"g": "model"})
        exe.arg_dict["conv_weight"][:] = rng.randn(
            *exe.arg_dict["conv_weight"].shape).astype(np.float32) * 0.2
        exe.arg_dict["bn_gamma"][:] = np.ones(32, np.float32)
        exe.arg_dict["bn_beta"][:] = np.zeros(32, np.float32)
        out = exe.forward(is_train=True, data=x)[0].asnumpy()
        exe.backward()
        res[tag] = (out, exe.grad_dict["conv_weight"].asnumpy())
        rng = np.random.RandomState(8)
        rng.randn(*x.shape)
    assert calls == []
    np.testing.assert_allclose(res["port"][0], res["jax"][0], **GRAD)
    np.testing.assert_allclose(res["port"][1], res["jax"][1], rtol=1e-4,
                               atol=1e-4 * np.abs(res["jax"][1]).max())


def _conv_bn_net(pkg):
    with pkg.symbol.NameManager():
        d = pkg.sym.Variable("data")
        c = pkg.sym.Convolution(d, num_filter=16, kernel=(1, 1),
                                no_bias=True, layout="NHWC", name="conv")
        b = pkg.sym.BatchNorm(c, axis=3, fix_gamma=False, name="bn")
        f = pkg.sym.FullyConnected(pkg.sym.Flatten(b), num_hidden=8,
                                   name="fc")
        return pkg.sym.SoftmaxOutput(f, name="softmax")


@pytest.mark.parametrize("shard", [None, "conv_weight", "fc_weight"])
def test_fusion_runs_per_pair_over_a_multi_axis_mesh(monkeypatch, shard):
    """``MXTPU_FUSE_CONV_BN=1`` over a data=2,model=2 mesh without
    placement: the Conv1x1->BatchNorm pair runs its kernel on every
    position's shard (4 launches a step) unless its own weight is split
    over 'model'; a split classifier weight leaves it fused. Two SGD steps
    equal the JAX package's over the same mesh and shardings
    (``rtol=1e-4, atol=1e-5``)."""
    from mxnet_tpu_torch.ops import matmul_stats
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    calls = []
    real = matmul_stats.apply_conv1x1_stats
    monkeypatch.setattr(matmul_stats, "apply_conv1x1_stats",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 4, 4, 6).astype(np.float32)
    y = rng.randint(0, 8, (2, 8)).astype(np.float32)
    axes = {"data": 2, "model": 2}
    shards = {} if shard is None else {shard: P("model")}
    jstep = JTrainStep(_conv_bn_net(mx), learning_rate=0.1,
                       mesh=jmake_mesh(axes),
                       param_shardings={k: JP("model") for k in shards})
    jst = jstep.init({"data": (8, 4, 4, 6)}, {"softmax_label": (8,)},
                     seed=3)
    ts = TrainStep(_conv_bn_net(mt), learning_rate=0.1, device="cpu",
                   mesh=_mesh(axes), param_shardings=shards)
    ts.init({"data": (8, 4, 4, 6)}, {"softmax_label": (8,)}, seed=0)
    st = ts.replicate_state(convert.from_reference_state(jst, "cpu"))
    for i in range(2):
        batch = {"data": x[i], "softmax_label": y[i]}
        jst, _ = jstep.step(jst, batch)
        ts.step(st, batch)
    assert len(calls) == (0 if shard == "conv_weight" else 2 * 4)
    whole = ts.whole_state(st)
    for n in whole["params"]:
        np.testing.assert_allclose(whole["params"][n].numpy(),
                                   np.asarray(jst["params"][n]), **GRAD)


def test_jax_parameters_carry_into_a_sharded_state_and_back(tmp_path):
    """JAX parameters go into a sharded port state through
    ``convert.from_reference_state`` and ``replicate_state``; after a step,
    the port's ``whole_state`` saved as a checkpoint opens in the JAX
    package and gives the port's forward (``rtol=1e-5``)."""
    np.random.seed(5)
    x = np.random.randn(32, 48).astype(np.float32)
    y = (x[:, 1] > 0).astype(np.float32)
    g2c = {"dev1": "model", "dev2": "model"}
    jstep = JTrainStep(_two_group_mlp(mx), learning_rate=0.1,
                       mesh=jmake_mesh({"model": 8}), group2ctx=g2c)
    jst = jstep.init({"data": (32, 48)}, {"softmax_label": (32,)}, seed=3)
    ts = TrainStep(_two_group_mlp(mt), learning_rate=0.1, device="cpu",
                   mesh=_mesh({"model": 8}), group2ctx=g2c)
    ts.init({"data": (32, 48)}, {"softmax_label": (32,)}, seed=0)
    st = ts.replicate_state(convert.from_reference_state(jst, "cpu"))
    assert tuple(st["params"]["fc1_weight"].shape) == (8, 48)
    batch = {"data": x, "softmax_label": y}
    jst, _ = jstep.step(jst, batch)
    ts.step(st, batch)
    whole = ts.whole_state(st)
    for n in whole["params"]:
        np.testing.assert_allclose(whole["params"][n].numpy(),
                                   np.asarray(jst["params"][n]), **GRAD)
    mod = mt.mod.Module(_two_group_mlp(mt), context=mt.cpu())
    mod.bind(data_shapes=[("data", (32, 48))],
             label_shapes=[("softmax_label", (32,))])
    mod.set_params({n: mt.nd.array(v.numpy(), ctx=mt.cpu())
                    for n, v in whole["params"].items()}, {})
    prefix = str(tmp_path / "mp")
    mod.save_checkpoint(prefix, 1)
    jmod = mx.mod.Module.load(prefix, 1, context=mx.cpu())
    jmod.bind(data_shapes=[("data", (32, 48))],
              label_shapes=[("softmax_label", (32,))], for_training=False)
    it = mx.io.NDArrayIter(x, y, batch_size=32)
    jout = jmod.predict(it).asnumpy()
    tout = mod.predict(mt.io.NDArrayIter(x, y, batch_size=32)).asnumpy()
    np.testing.assert_allclose(tout, jout, **FWD)
