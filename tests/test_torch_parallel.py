"""The port's mesh of replicas (``mxnet_tpu_torch.parallel``) against the
JAX package's ``parallel.mesh`` on the conftest's 8 virtual CPU devices,
and the port's lock-step graph walk over a 'data' mesh against its own
single-device walk, on the CPU.

Tolerances: the collectives' sums and the mesh walk's outputs and
gradients ``rtol=1e-5, atol=1e-6`` (float32 sums in other orders); the
placement and plan checks are exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.parallel import mesh as jmesh
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import mesh_plan, simple_bind
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel.mesh import P

TOL = dict(rtol=1e-5, atol=1e-6)
#: the CPU positions a mesh of the port is built over here (without CUDA a
#: mesh has no default devices)
CPUS = ["cpu"] * 8


def test_mesh_helpers_match_jax():
    for pkg, devs in ((jmesh, {}), (tmesh, {"devices": CPUS})):
        mesh = pkg.data_parallel_mesh(8, **devs)
        assert pkg.data_axis_size(mesh) == 8
        assert pkg.data_axis_size(None) == 1
        assert tuple(pkg.superbatch_sharding(mesh).spec) == (None, "data")
        assert pkg.superbatch_sharding(None) is None
        assert dict(pkg.make_mesh({"data": 4, "model": 2}, **devs).shape) \
            == {"data": 4, "model": 2}
        with pkg.MeshScope(mesh):
            assert pkg.current_mesh() is mesh
        assert pkg.current_mesh() is None
        assert pkg.is_multiprocess(mesh) is False
    from mxnet_tpu.train_step import data_parallel_spec as jspec
    from mxnet_tpu_torch.train_step import data_parallel_spec as tspec
    assert dict(tspec({"data": 4}, devices=CPUS).shape) == dict(
        jspec({"data": 4}).shape)
    with pytest.raises(mx.MXNetError):
        jmesh.make_mesh({"data": 16})
    with pytest.raises(MXNetError, match="needs 16 devices, have 8"):
        tmesh.make_mesh({"data": 16}, CPUS)


def test_default_devices_raise_without_cuda(monkeypatch):
    """Without CUDA a mesh has no default devices: ``devices()`` and the
    builders that default to it raise, naming ``devices=["cpu"] * n``, as
    ``context.resolve_device`` refuses a CUDA default (no quiet CPU
    fallback); with CPU positions passed they build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tmesh.devices, lambda: tmesh.make_mesh({"data": 2}),
                 lambda: tmesh.data_parallel_mesh(2),
                 lambda: tmesh.model_parallel_mesh(2),
                 lambda: tmesh.mesh_from_spec("data=2"),
                 tmesh.global_data_mesh):
        with pytest.raises(MXNetError, match=r'devices=\["cpu"\] \* n'):
            call()
    mesh = tmesh.data_parallel_mesh(2, devices=CPUS)
    assert mesh.replica_devices() == [torch.device("cpu")] * 2
    assert tmesh.global_data_mesh(local_devices=["cpu"]).nproc == 1


@pytest.mark.parametrize("value,n", [(32, 8), (36, 8), (6, 4), (5, 1)])
def test_check_axis_divides_matches_jax(value, n):
    def call(pkg, mesh):
        try:
            pkg.check_axis_divides(mesh, "data", value, "batch dim")
            return None
        except Exception as e:      # noqa: BLE001 -- the message compared
            return str(e)
    assert call(tmesh, tmesh.data_parallel_mesh(n, devices=CPUS)) == \
        call(jmesh, jmesh.data_parallel_mesh(n))


def test_grad_sync_matches_jax_psum():
    """The explicit gradient all-reduce: every replica holds the sum of
    the shards, as the JAX package's psum inside shard_map gives."""
    from jax.experimental.shard_map import shard_map
    dp = jmesh.data_parallel_mesh(4)
    fn = shard_map(lambda g: jmesh.grad_sync({"w": g}, "data")["w"],
                   mesh=dp, in_specs=jax.sharding.PartitionSpec("data"),
                   out_specs=jax.sharding.PartitionSpec("data"))
    want = np.asarray(fn(jnp.arange(8.0)))
    g = tmesh.shard_batch(torch.arange(8.0),
                          tmesh.data_parallel_mesh(4, devices=CPUS))
    got = tmesh.grad_sync({"w": g})["w"]
    assert got.axis is None
    np.testing.assert_array_equal(torch.cat(got.parts).numpy(), want)


def test_mesh_array_split_replicate_gather():
    mesh = tmesh.data_parallel_mesh(4, devices=CPUS)
    t = torch.arange(24.0).reshape(2, 4, 3)
    a = tmesh.split(t, mesh, 1)
    assert a.shape == (2, 4, 3) and a.axis == 1
    assert [tuple(p.shape) for p in a.parts] == [(2, 1, 3)] * 4
    assert a.sharding.spec == P(None, "data")
    assert torch.equal(a.gather(), t)
    r = tmesh.replicate(t, mesh)
    assert r.axis is None and r.sharding.spec == P()
    assert len({p.data_ptr() for p in r.parts}) == 4
    assert all(torch.equal(p, t) for p in r.parts)
    with pytest.raises(MXNetError, match="does not divide"):
        tmesh.split(torch.zeros(6), mesh, 0)
    assert tmesh.batch_axis((2, 8, 5), 8) == 1
    assert tmesh.batch_axis((8, 8), 8) == 0
    assert tmesh.batch_axis((3,), 8) is None


def test_batch_axes_follow_the_layouts_n():
    """The batch axis of each input is its layout's 'N' (TN: dim 1, also
    where time and batch have one size), the batch size the first input's
    size along it; an input without a layout, or whose 'N' axis lacks the
    batch's size (a begin state ``(layers, batch, hidden)`` in the default
    layout), takes the axis of the batch's size."""
    D = mt.io.DataDesc
    descs = [D("data", (5, 4), layout="TN"), D("state", (2, 4, 3)),
             ("extra", (4, 7)), D("label", (5, 4), layout="TN"),
             D("nolayout", (4,), layout=None)]
    axes = tmesh.layout_axes(descs)
    assert axes == {"data": 1, "state": 0, "extra": None, "label": 1,
                    "nolayout": 0}
    shapes = {d[0]: d[1] for d in descs}
    assert tmesh.batch_axes(shapes, axes) == (4, {
        "data": 1, "state": 1, "extra": 0, "label": 1, "nolayout": 0})
    assert tmesh.batch_axes({"data": (4, 4)}, {"data": 1}) == (
        4, {"data": 1})
    assert tmesh.batch_axes({"data": (5, 4)}) == (5, {"data": 0})
    mesh = tmesh.data_parallel_mesh(2, devices=CPUS)
    assert tmesh.shard_shape((5, 4), mesh, 1) == (5, 2)
    assert tmesh.shard_shape((5, 4), mesh, None) == (5, 4)


def test_all_reduce_is_the_same_on_every_replica_and_differentiable():
    mesh = tmesh.data_parallel_mesh(4, devices=CPUS)
    devs = mesh.replica_devices()
    xs = [torch.full((3,), float(i + 1), requires_grad=True)
          for i in range(4)]
    tmesh.reset_counters()
    out = tmesh.all_reduce(xs, devs)
    assert tmesh.COUNTERS["all_reduce"] == 1
    assert all(torch.equal(o, out[0]) for o in out)
    np.testing.assert_array_equal(out[0].detach().numpy(), [10.0] * 3)
    out[0].sum().backward()
    assert all(torch.equal(x.grad, torch.ones(3)) for x in xs)


@pytest.mark.parametrize("what,call", [
    ("no counterpart", lambda: tmesh.shard_map_compat(None)),
    ("no counterpart", lambda: tmesh.axis_size("seq")),
])
def test_axes_still_to_port_raise_naming_their_item(what, call):
    """``shard_map_compat`` and ``axis_size`` raise for good, naming the
    explicit functions that replace them."""
    with pytest.raises(MXNetError, match=what):
        call()


@pytest.mark.parametrize("helper", ["global_data_mesh", "host_to_global",
                                    "host_broadcast0", "local_view"])
def test_multiprocess_helpers_match_jax_in_one_process(helper):
    """The multi-process helpers in one process, against the JAX package's
    on the conftest's devices: the mesh spans one process, a value built
    over it is the local value, rank 0's broadcast is the value itself,
    and the local view of a global value is the value (exact). Across two
    processes over gloo: ``tests/test_torch_kvstore_dist.py``."""
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    jm = jmesh.global_data_mesh()
    tm = tmesh.global_data_mesh(local_devices=["cpu"])
    if helper == "global_data_mesh":
        assert jmesh.is_multiprocess(jm) is tmesh.is_multiprocess(tm) \
            is False
        assert jm.axis_names == tm.axis_names == ("data",)
        assert tm.nproc == 1 and tm.rank == 0
        assert tmesh.global_data_mesh("worker", ["cpu"]).axis_names == (
            "worker",)
    elif helper == "host_to_global":
        for spec in (jmesh.P("data"), jmesh.P()):
            j = np.asarray(jmesh.host_to_global(jm, spec, x))
            t = tmesh.host_to_global(tm, tmesh.P(*spec), x)
            np.testing.assert_array_equal(t.data.numpy(), j)
            assert t.shape == j.shape
    elif helper == "host_broadcast0":
        for v in (x, np.array([3, -4], np.int32)):
            j = jmesh.host_broadcast0(jm, v)
            t = tmesh.host_broadcast0(tm, v)
            np.testing.assert_array_equal(t, j)
            assert t.dtype == j.dtype
    else:
        j = np.asarray(jmesh.local_view(
            jmesh.host_to_global(jm, jmesh.P("data"), x)))
        t = tmesh.local_view(tmesh.host_to_global(tm, tmesh.P("data"), x))
        np.testing.assert_array_equal(t.numpy(), j)
        assert tmesh.local_view(x) is x


def _ported_case(case):
    """One formerly-raising multi-axis surface, as the port runs it and as
    the JAX package does: ``(port result, JAX result)``."""
    if case == "model_parallel_mesh":
        return (dict(tmesh.model_parallel_mesh(2, CPUS).shape),
                {k: v for k, v in zip(
                    jmesh.model_parallel_mesh(2).axis_names,
                    jmesh.model_parallel_mesh(2).devices.shape)})
    if case == "parse_mesh_axes":
        return (tmesh.parse_mesh_axes("data=2,seq=2"),
                jmesh.parse_mesh_axes("data=2,seq=2"))
    if case == "mesh_from_spec":
        t, j = tmesh.mesh_from_spec("data=2,pipe=4", CPUS), \
            jmesh.mesh_from_spec("data=2,pipe=4")
        return dict(t.shape), dict(zip(j.axis_names, j.devices.shape))
    if case == "superbatch_seq":
        t = tmesh.superbatch_sharding(
            tmesh.make_mesh({"data": 2, "seq": 2}, CPUS), seq=True)
        j = jmesh.superbatch_sharding(jmesh.make_mesh({"data": 2, "seq": 2}),
                                      seq=True)
        return tuple(t.spec), tuple(j.spec)
    # a TrainStep over a data x model mesh, with a parameter sharded over
    # 'model' by param_shardings: its state holds the shards, and a step
    # equals the one-device step
    net = mt.models.mlp(num_classes=4, hidden=(8,))
    kw = {}
    if case == "param_shardings":
        mesh = tmesh.make_mesh({"model": 2}, ["cpu"] * 2)
        kw["param_shardings"] = {"fc1_weight": P("model")}
    else:
        mesh = tmesh.make_mesh({"data": 2, "model": 2}, ["cpu"] * 4)
    ts = mt.TrainStep(net, device="cpu", mesh=mesh, learning_rate=0.1, **kw)
    one = mt.TrainStep(net, device="cpu", learning_rate=0.1)
    shapes = ({"data": (8, 6)}, {"softmax_label": (8,)})
    st, ref = ts.init(*shapes, seed=1), one.init(*shapes, seed=1)
    rng = np.random.RandomState(0)
    batch = {"data": rng.randn(8, 6).astype(np.float32),
             "softmax_label": rng.randint(0, 4, 8).astype(np.float32)}
    ts.step(st, batch)
    one.step(ref, batch)
    whole = ts.whole_state(st)
    shard = tuple(st["params"]["fc1_weight"].shape)
    return ([shard] + [whole["params"][n].numpy() for n in ref["params"]],
            [(4, 6) if kw else (8, 6)]
            + [ref["params"][n].numpy() for n in ref["params"]])


@pytest.mark.parametrize("case", [
    "model_parallel_mesh", "parse_mesh_axes", "mesh_from_spec",
    "data_model_trainstep", "param_shardings", "superbatch_seq"])
def test_multi_axis_surfaces_are_ported(case):
    """The surfaces that raised before the 'model', 'seq' and 'pipe' axes
    were ported: each now gives the JAX package's result (a TrainStep over
    a sharded mesh: the one-device step, ``rtol=1e-5``)."""
    got, want = _ported_case(case)
    if isinstance(got, list):
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, **TOL)
    else:
        assert got == want


def test_module_model_axis_options_raise_citing_a7b(monkeypatch):
    """``mesh_axes``, ``param_shardings`` and ``MXTPU_LM_MESH`` are
    accepted as in the JAX package (the argument winning over the
    environment); a malformed spec raises naming its token."""
    sym = mt.models.mlp(num_classes=4, hidden=(8,))
    mod = mt.mod.Module(sym, context=mt.cpu(), mesh_axes="data=2")
    assert mod._mesh_axes == {"data": 2}
    mod = mt.mod.Module(sym, context=mt.cpu(),
                        param_shardings={"w": P("model")})
    assert mod._param_shardings == {"w": P("model")}
    monkeypatch.setenv("MXTPU_LM_MESH", "data=2,seq=2")
    assert mt.mod.Module(sym, context=mt.cpu())._mesh_axes == {
        "data": 2, "seq": 2}
    assert mt.mod.Module(sym, context=mt.cpu(),
                         mesh_axes="pipe=2")._mesh_axes == {"pipe": 2}
    monkeypatch.setenv("MXTPU_LM_MESH", "data")
    with pytest.raises(MXNetError, match="'data' is not 'axis=N'"):
        mt.mod.Module(sym, context=mt.cpu())


# ---------------------------------------------------------------------------
# the lock-step walk: which nodes run per replica, which on the whole batch
# ---------------------------------------------------------------------------

def _plan(net, shapes, n=4):
    """mesh_plan of every op node of ``net`` with its inputs split along
    their batch axis (``shapes``: the whole batch's, dim 0 the batch)."""
    mesh = tmesh.data_parallel_mesh(n, devices=CPUS)
    ex = simple_bind(net, mt.cpu(), grad_req="null", mesh=mesh,
                     batch_names=list(shapes), **shapes)
    vals, _ = ex._to_mesh({k: v.data for k, v in ex.arg_dict.items()}, {})
    env = {}
    plans = {}
    for node in ex._nodes:
        if node.is_variable:
            env[(id(node), 0)] = vals[node.name]
            continue
        ins = [env[(id(s), i)] for s, i in node.inputs]
        mode, axes = mesh_plan(node, ins, n)
        plans[node.name] = (mode, axes)
        outs, _ = node.op.apply(mt.ops.registry.OpContext(), node.attrs,
                                [v.gather() for v in ins], [])
        for i, o in enumerate(outs):
            ax = None if axes is None else axes[i]
            env[(id(node), i)] = (tmesh.split(o, mesh, ax) if mode ==
                                  "replica" and ax is not None
                                  else tmesh.replicate(o, mesh))
    return plans


def test_mesh_plan_splits_row_ops_and_gathers_batch_reductions():
    sym = mt.sym
    x = sym.Variable("data")
    fc = sym.FullyConnected(x, num_hidden=6, name="fc")
    sw = sym.SwapAxis(sym.Reshape(fc, shape=(0, 2, 3), name="r1"),
                      dim1=0, dim2=1, name="sw")
    flat = sym.Reshape(sw, shape=(-1,), name="r2")
    tot = sym.sum(fc, axis=0, name="s0")
    rows = sym.sum(fc, axis=1, name="s1")
    cat = sym.Concat(fc, fc, dim=0, name="c0")
    net = sym.Group([flat, tot, rows, cat])
    plans = _plan(net, {"data": (8, 5)})
    assert plans["fc"] == ("replica", [0])
    assert plans["r1"] == ("replica", [0])
    assert plans["sw"] == ("replica", [1])
    # a reshape across a batch axis that is not outermost: whole batch
    assert plans["r2"][0] == "whole"
    assert plans["s0"] == ("whole", [None])
    assert plans["s1"] == ("replica", [0])
    assert plans["c0"][0] == "whole"


def test_mesh_plan_whole_batch_shapes_and_inference_errors():
    """A Reshape to the whole batch's literal shape has no shapes at one
    shard's: it runs on the whole batch. Shape inference that fails at the
    whole batch's shapes raises, naming the node, instead of running it on
    the gathered batch."""
    mesh = tmesh.data_parallel_mesh(4, devices=CPUS)
    ins = [tmesh.split(torch.zeros(8, 4), mesh, 0)]
    x = mt.sym.Variable("data")
    fixed = mt.sym.Reshape(x, shape=(8, 4), name="fixed")._out_nodes()[0]
    assert mesh_plan(fixed, ins, 4) == ("whole", [None])
    bad = mt.sym.Reshape(x, shape=(3, -1), name="bad")._out_nodes()[0]
    with pytest.raises(MXNetError, match="'bad' .*Reshape"):
        mesh_plan(bad, ins, 4)


def _walk_both(net, feeds, heads_scale=1.0):
    """Outputs and gradients of one training forward and backward, on one
    device and over a 4-replica mesh."""
    res = []
    for mesh in (None, tmesh.data_parallel_mesh(4, devices=CPUS)):
        ex = simple_bind(net, mt.cpu(), mesh=mesh, batch_names=["data"],
                         data=feeds["data"].shape)
        rng = np.random.default_rng(5)
        for k, a in ex.arg_dict.items():
            if k != "data":
                a[:] = rng.normal(size=a.shape).astype(np.float32)
        ex.forward(is_train=True, data=feeds["data"])
        ex.backward()
        res.append(([o.asnumpy() for o in ex.outputs],
                    {k: g.asnumpy() for k, g in ex.grad_dict.items()}))
    return res


def test_whole_batch_nodes_differentiate_as_one_device():
    """A loss that reduces over the batch (``MakeLoss(sum(axis=0))``, a
    replicated head) and a Concat along the batch axis run on the gathered
    batch; outputs and gradients equal the one-device walk's, the
    replicated head counted once."""
    sym = mt.sym
    x = sym.Variable("data")
    fc = sym.FullyConnected(x, num_hidden=3, name="fc")
    cat = sym.Concat(fc, fc * 2.0, dim=0, name="cat")
    head = sym.MakeLoss(sym.sum(sym.square(cat), axis=0), name="loss")
    rows = sym.MakeLoss(sym.sum(fc, axis=1), name="rows",
                        normalization="batch")
    net = sym.Group([head, rows])
    data = np.random.default_rng(2).normal(size=(8, 5)).astype(np.float32)
    (o1, g1), (o4, g4) = _walk_both(net, {"data": data})
    for a, b in zip(o4, o1):
        np.testing.assert_allclose(a, b, **TOL)
    for k in g1:
        np.testing.assert_allclose(g4[k], g1[k], err_msg=k, **TOL)


@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
def test_softmax_output_normalisation_over_the_whole_batch(norm):
    sym = mt.sym
    x = sym.Variable("data")
    fc = sym.FullyConnected(x, num_hidden=4, name="fc")
    net = sym.SoftmaxOutput(fc, name="softmax", normalization=norm,
                            use_ignore=True, ignore_label=0)
    data = np.random.default_rng(3).normal(size=(8, 5)).astype(np.float32)
    label = np.array([0, 1, 2, 3, 0, 0, 1, 2], np.float32)
    res = []
    for mesh in (None, tmesh.data_parallel_mesh(4, devices=CPUS)):
        ex = simple_bind(net, mt.cpu(), mesh=mesh,
                         batch_names=["data", "softmax_label"],
                         data=(8, 5), softmax_label=(8,))
        ex.arg_dict["fc_weight"][:] = np.ones((4, 5), np.float32) * 0.1
        ex.forward(is_train=True, data=data, softmax_label=label)
        ex.backward()
        res.append(ex.grad_dict["fc_weight"].asnumpy())
    np.testing.assert_allclose(res[1], res[0], **TOL)


def test_local_kvstore_sums_a_device_list_as_jax():
    """``push`` of one value per context sums them (the JAX package's sum
    of a device list), ``pull`` writes each output on its context's device
    (the port's NDArray names the host device ``cpu(0)``). The
    JAX package adds arrays only when they share a device (on two of its
    devices the sum raises), so its values lie on cpu(0) here; the port's
    contexts cpu(0) and cpu(1) are replicas of the one host device."""
    rng = np.random.default_rng(9)
    vals = [rng.normal(size=(2, 3)).astype(np.float32) for _ in range(2)]
    out = {}
    for pkg, ctxs in ((mx, [mx.cpu(0), mx.cpu(0)]),
                      (mt, [mt.cpu(0), mt.cpu(1)])):
        kv = pkg.kv.create("local")
        kv.init(3, pkg.nd.zeros((2, 3), ctx=ctxs[0]))
        kv.push(3, [pkg.nd.array(v, ctx=c) for v, c in zip(vals, ctxs)])
        outs = [pkg.nd.zeros((2, 3), ctx=c) for c in ctxs]
        kv.pull(3, out=outs)
        # each output stays on its context's device
        for o, c in zip(outs, ctxs):
            dev = o.data.device if pkg is mt else list(o.data.devices())[0]
            assert dev == c.to_device()
        out[pkg.__name__] = [o.asnumpy() for o in outs]
    for a, b in zip(out["mxnet_tpu_torch"], out["mxnet_tpu"]):
        np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(a, vals[0] + vals[1], **TOL)
