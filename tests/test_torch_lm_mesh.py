"""The transformer LM over multi-axis meshes in the port
(``Module(mesh_axes=)``, ``MXTPU_LM_MESH``, ``TrainStep`` over 'seq',
'data' x 'seq' and 'pipe' meshes) against the JAX package's
``tests/test_lm_flagship.py`` mesh tests, on the conftest's 8 virtual CPU
devices for the JAX package and a CPU mesh of as many positions for the
port.

Sizes: vocabulary 32, embed 32, 4 heads, 2 layers, sequence 16, batch 8
(``test_lm_flagship.py``'s). Tolerances:
- spec-parsing and precheck messages: the JAX package's, exactly where
  both raise the same check;
- a mesh fit against the one-device fit: ``rtol=2e-3, atol=2e-5`` (the
  JAX test's bound; ring attention sums the softmax in another order);
- a mesh fit against the JAX package's mesh fit from the same initial
  parameters: ``rtol=2e-3, atol=2e-5``.
"""
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.parallel import mesh as jmesh
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel.mesh import P
from mxnet_tpu_torch.train_step import TrainStep

V, E, H, L, S, B = 32, 32, 4, 2, 16, 8
FIT = dict(rtol=2e-3, atol=2e-5)
CPUS4 = [mt.cpu(i) for i in range(4)]


def _sym(pkg, **kw):
    cfg = dict(vocab_size=V, embed=E, num_heads=H, num_layers=L, seq_len=S)
    cfg.update(kw)
    with pkg.symbol.NameManager():
        return pkg.models.transformer(**cfg)


def _iter(pkg, n=4 * B, batch=B, seed=0):
    rng = np.random.RandomState(seed)
    return pkg.io.NDArrayIter(
        data={"data": rng.randint(0, V, (n, S)).astype(np.float32)},
        label={"softmax_label": rng.randint(0, V, (n, S))
               .astype(np.float32)},
        batch_size=batch)


def _init_params(sym, seed=4):
    """Float32 initial parameters from a seed (gains near 1)."""
    shapes, _, _ = sym.infer_shape(data=(B, S), softmax_label=(B, S))
    rng = np.random.RandomState(seed)
    out = {}
    for n, shp in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        base = 1.0 if n.endswith("gamma") else 0.0
        out[n] = (base + 0.1 * rng.randn(*shp)).astype(np.float32)
    return out


def _fit(pkg, sym, params, context, k=1, **kw):
    mod = pkg.mod.Module(sym, context=context, **kw)
    pkg.random.seed(7)
    mod.fit(_iter(pkg), num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05},
            arg_params={n: pkg.nd.array(v, ctx=pkg.cpu())
                        for n, v in params.items()},
            aux_params={}, eval_metric=pkg.metric.Perplexity(
                ignore_label=None), steps_per_dispatch=k)
    return mod


def _snap(mod):
    return {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}


def _err(fn):
    try:
        fn()
    except (MXNetError, JMXNetError) as e:
        return str(e)
    return None


@pytest.mark.parametrize("spec", ["bogus=2", "data=0", "data", "data=x",
                                  "data=2,data=2", "", {"pipe": 2},
                                  "data=2,seq=4"])
def test_parse_mesh_axes_matches_jax(spec):
    jerr = _err(lambda: jmesh.parse_mesh_axes(spec))
    terr = _err(lambda: tmesh.parse_mesh_axes(spec))
    assert terr == jerr
    if jerr is None:
        assert tmesh.parse_mesh_axes(spec) == jmesh.parse_mesh_axes(spec)


def test_mesh_from_spec_device_shortfall_names_the_devices():
    with pytest.raises(MXNetError) as e:
        tmesh.mesh_from_spec("data=64", ["cpu"] * 8)
    msg = str(e.value)
    assert "needs 64 devices but only 8 are visible (cpu)" in msg
    assert "devices=" in msg and "XLA_FLAGS" not in msg
    assert dict(tmesh.mesh_from_spec(
        "data=2,seq=2", ["cpu"] * 4).shape) == {"data": 2, "seq": 2}


@pytest.mark.parametrize("axes,n,batch,what", [
    ("data=3", 4 * B, B, "data"), ("seq=3", 18, 9, "seq"),
    ("data=2,seq=8", 4 * B, B, "seq")])
def test_fit_indivisible_names_the_axis(axes, n, batch, what):
    """batch 8 over 'data'=3 and seq_len 16 over 'seq'=3 (batch 9): the
    Module-level precheck fails naming the axis, in the JAX package's
    words; the composed data=2,seq=8 mesh asks for more positions than the
    8 devices and names the mesh."""
    msgs = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, [mt.cpu(i) for i in range(8)])):
        mod = pkg.mod.Module(_sym(pkg), context=ctx, mesh_axes=axes)
        with pytest.raises((MXNetError, JMXNetError)) as e:
            mod.fit(_iter(pkg, n=n, batch=batch), num_epoch=1,
                    optimizer="sgd", initializer=pkg.initializer.Xavier(),
                    eval_metric=pkg.metric.Perplexity(ignore_label=None),
                    steps_per_dispatch=2)
        msgs.append(str(e.value))
    for m in msgs:
        assert what in m
    if axes == "data=2,seq=8":
        # 16 positions over 8 devices: each package names the shortfall
        # with the mesh (the port without the XLA_FLAGS recipe)
        for m in msgs:
            assert "mesh data=2xseq=8 needs 16 devices" in m
    else:
        assert msgs[1] == msgs[0]


def test_ring_attention_seq_divisibility_precheck():
    """A 3-way 'seq' axis and sequence 16: ``shard_batch`` names the
    sequence dimension, in the JAX package's words."""
    ts = TrainStep(_sym(mt, seq_parallel="ring"), optimizer="sgd",
                   learning_rate=0.1, mesh=tmesh.make_mesh({"seq": 3},
                                                           ["cpu"] * 3),
                   device="cpu")
    batch = {"data": np.zeros((6, S), np.float32),
             "softmax_label": np.zeros((6, S), np.float32)}
    with pytest.raises(MXNetError, match="sequence dim") as e:
        ts.shard_batch(batch)
    from mxnet_tpu.train_step import TrainStep as JTrainStep
    js = JTrainStep(_sym(mx, seq_parallel="ring"), optimizer="sgd",
                    learning_rate=0.1, mesh=jmesh.mesh_from_spec("seq=3"))
    with pytest.raises(JMXNetError) as je:
        js.shard_batch(batch)
    assert str(e.value) == str(je.value)


def test_ulysses_heads_divisibility_precheck():
    """seq 16 divides an 8-way 'seq' axis but 4 heads do not: Ulysses'
    head exchange needs heads % 8 == 0 and says so, as the JAX package."""
    msgs = []
    for pkg, mesh in ((mx, jmesh.mesh_from_spec("seq=8")),
                      (mt, tmesh.mesh_from_spec("seq=8", ["cpu"] * 8))):
        with pkg.cpu():
            x = pkg.nd.array(np.zeros((2, S, E), np.float32))
            wqkv = pkg.nd.array(np.zeros((3 * E, E), np.float32))
            wout = pkg.nd.array(np.zeros((E, E), np.float32))
            scope = (jmesh.MeshScope if pkg is mx else tmesh.MeshScope)
            with scope(mesh):
                with pytest.raises((MXNetError, JMXNetError)) as e:
                    pkg.nd.MultiHeadAttention(x, wqkv, wout, num_heads=H,
                                              no_bias=True, causal=True,
                                              seq_parallel="ulysses")
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and "num_heads" in msgs[1]


def test_ring_block_size_refuses():
    with tmesh.MeshScope(tmesh.make_mesh({"seq": 2}, ["cpu"] * 2)):
        with mt.cpu():
            x = mt.nd.array(np.zeros((2, S, E), np.float32))
            w = mt.nd.array(np.zeros((3 * E, E), np.float32))
            wo = mt.nd.array(np.zeros((E, E), np.float32))
            with pytest.raises(MXNetError, match="block_size is not "
                               "supported with seq_parallel='ring'"):
                mt.nd.MultiHeadAttention(x, w, wo, num_heads=H,
                                         no_bias=True, block_size=4,
                                         seq_parallel="ring")


def test_pipe_stack_layer_divisibility_precheck():
    ts = TrainStep(_sym(mt, num_layers=3, stack_layers=True),
                   optimizer="sgd", learning_rate=0.1, device="cpu",
                   mesh=tmesh.make_mesh({"pipe": 2}, ["cpu"] * 2))
    st = ts.init({"data": (B, S)}, {"softmax_label": (B, S)})
    batch = {"data": np.zeros((B, S), np.float32),
             "softmax_label": np.zeros((B, S), np.float32)}
    with pytest.raises(MXNetError, match="TransformerStack: num_layers 3 "
                       "does not divide the 2-way 'pipe' mesh axis"):
        ts.step(st, batch)


def test_module_mesh_axes_rejects_dist_kvstore():
    msgs = []
    for pkg in (mx, mt):
        mod = pkg.mod.Module(_sym(pkg), context=pkg.cpu(),
                             mesh_axes="data=2")
        mod.bind(data_shapes=[("data", (B, S))],
                 label_shapes=[("softmax_label", (B, S))])
        mod.init_params(pkg.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd")
        mod._kvstore = types.SimpleNamespace(type="dist_sync", num_workers=2)
        with pytest.raises((MXNetError, JMXNetError)) as e:
            mod._build_fused()
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and "dist" in msgs[1]


def test_fit_multi_axis_dp_sp_parity():
    """data=2,seq=2 with ring attention and ``pos_embed_weight`` on
    P('seq', None), K=2 steps a dispatch, against the one-device fit and
    against the JAX package's data=2,seq=2 fit from the same initial
    parameters."""
    params = _init_params(_sym(mt))
    ref = _snap(_fit(mt, _sym(mt), params, mt.cpu()))
    kw = dict(seq_parallel="ring", preserve_shape=True)
    mod = _fit(mt, _sym(mt, **kw), params, CPUS4, k=2,
               mesh_axes="data=2,seq=2",
               param_shardings={"pos_embed_weight": P("seq", None)})
    assert dict(mod._fused.mesh.shape) == {"data": 2, "seq": 2}
    assert tuple(mod._fused_state["params"]["pos_embed_weight"].shape) == (
        S // 2, E)
    got = _snap(mod)
    jmod = _fit(mx, _sym(mx, **kw), params, mx.cpu(), k=2,
                mesh_axes="data=2,seq=2",
                param_shardings={"pos_embed_weight": jmesh.P("seq", None)})
    want = _snap(jmod)
    assert set(got) == set(ref) == set(want)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **FIT)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FIT)


def test_fit_pipe_stack_parity_with_jax():
    """pipe=2 with ``stack_layers=True``, 2 microbatches and the stacked
    weights on P('pipe'), against the JAX package's pipe=2 fit."""
    sym = _sym(mt, stack_layers=True, num_microbatches=2)
    params = _init_params(sym)
    stk = [n for n in params if n.startswith("stack_")]
    got = _snap(_fit(mt, sym, params, [mt.cpu(0), mt.cpu(1)],
                     mesh_axes="pipe=2",
                     param_shardings={n: P("pipe") for n in stk}))
    want = _snap(_fit(mx, _sym(mx, stack_layers=True, num_microbatches=2),
                      params, mx.cpu(), mesh_axes="pipe=2",
                      param_shardings={n: jmesh.P("pipe") for n in stk}))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FIT)


def test_lm_mesh_environment_is_picked_up(monkeypatch):
    """``MXTPU_LM_MESH`` gives Module its mesh when ``mesh_axes`` is not
    passed, and the fit equals the explicit one bit for bit."""
    kw = dict(seq_parallel="ulysses", preserve_shape=True)
    params = _init_params(_sym(mt, **kw))
    explicit = _snap(_fit(mt, _sym(mt, **kw), params, CPUS4,
                          mesh_axes="seq=4"))
    monkeypatch.setenv("MXTPU_LM_MESH", "seq=4")
    mod = _fit(mt, _sym(mt, **kw), params, CPUS4)
    assert dict(mod._fused.mesh.shape) == {"seq": 4}
    got = _snap(mod)
    for k in explicit:
        np.testing.assert_array_equal(got[k], explicit[k])


@pytest.mark.parametrize("axes", [{"seq": 2}, {"data": 2, "seq": 2}])
def test_ring_dispatch_rotates_and_never_gathers(axes):
    """A ``run_steps`` dispatch of the ring LM (``pos_embed_weight`` on
    P('seq', None)) rotates K and V once a layer and shard, and gathers
    nothing along 'seq': the metric sums read the outputs without a
    collective of the step. Its metric sums equal the one-device
    dispatch's (``rtol=2e-3``)."""
    rng = np.random.RandomState(2)
    feed = {"data": rng.randint(0, V, (2, B, S)).astype(np.float32),
            "softmax_label": rng.randint(0, V, (2, B, S)).astype(np.float32)}
    params = _init_params(_sym(mt))
    sums = {}
    for tag, mesh, sym, shard in (
            ("one", None, _sym(mt, preserve_shape=True), {}),
            ("ring", tmesh.make_mesh(axes, ["cpu"] * int(np.prod(list(
                axes.values())))), _sym(mt, seq_parallel="ring",
                                        preserve_shape=True),
             {"pos_embed_weight": P("seq", None)})):
        ts = TrainStep(sym, learning_rate=0.05, device="cpu", mesh=mesh,
                       param_shardings=shard)
        st = ts.whole_state(ts.init({"data": (B, S)},
                                    {"softmax_label": (B, S)}))
        for n, v in params.items():
            st["params"][n].copy_(torch.from_numpy(v))
        st = ts.replicate_state(st)
        tmesh.reset_counters()
        _, metrics = ts.run_steps(st, feed)
        counts = dict(tmesh.COUNTERS)
        sums[tag] = metrics.values()
    # K and V once a layer, shard and step, over each 'data' shard
    assert counts["all_gather"] == 0
    assert counts["ppermute"] == (2 * 2 * L * (axes["seq"] - 1)
                                  * axes.get("data", 1))
    assert sums["ring"].keys() == sums["one"].keys()
    for k, v in sums["one"].items():
        np.testing.assert_allclose(sums["ring"][k], v, rtol=2e-3)
