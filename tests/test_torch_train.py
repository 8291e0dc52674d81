"""The training slice of the PyTorch port against the JAX package, on the
CPU: the ops it adds, the Conv1x1->BatchNorm fusion, the ResNet symbol,
and ``TrainStep`` from a state carried across with ``convert``.

The same numpy inputs go through both packages. The JAX side runs the
fusion as its own CPU tests do (``MXTPU_FUSE_CONV_BN=interpret``, the
Pallas kernel in interpret mode); the port runs ``"1"``, whose CPU tensors
take the kernel's plain version. Tolerances, each with its reason:
- single ops, float32: ``rtol=1e-5, atol=1e-6`` (XLA:CPU and PyTorch sum in
  different orders); gradients ``rtol=1e-4, atol=1e-5``;
- bfloat16 ops: ``rtol=2e-2, atol=2e-2``: XLA keeps elementwise chains in
  f32 between bf16 ops where PyTorch rounds each op to bf16, so results
  differ by a few bf16 ulps (2**-8 relative each);
- one ResNet-18 step, float32: ``rtol=1e-4, atol=1e-5`` on params, momentum
  and BatchNorm statistics, also for each of three steps started from the
  JAX package's previous state; K=3 ``run_steps`` from one state:
  ``rtol=1e-3, atol=1e-5`` at lr 0.003 (batch-2 BatchNorm amplifies a
  step's last-bit differences in the next, see the test);
- one ResNet-18 step, bfloat16 compute: held in norm against the JAX
  package's bf16 and f32 steps, as that test says.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import executor as jexec
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import models as jmodels
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import pallas_fused as jpf
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.train_step import TrainStep as JTrainStep
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert, executor as texec, initializer as tinit
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import current_context, gpu
from mxnet_tpu_torch.ops import matmul_stats as tms
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.train_step import TrainStep

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _np(t):
    return t.detach().float().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _apply_both(op, attrs, ins, aux=(), is_train=True, fused=None,
                dtype="float32"):
    """Run op on the same numpy inputs in both packages -> (jax outs, jax
    aux updates, port outs, port aux updates)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jins = [jnp.asarray(x).astype(jdt) for x in ins]
    tins = [torch.from_numpy(x).to(tdt) for x in ins]
    jaux = [jnp.asarray(a) for a in aux]
    taux = [torch.from_numpy(a) for a in aux]
    jfused = tfused = None
    if fused is not None:
        s1, s2, count = fused
        jfused = (jnp.asarray(s1), jnp.asarray(s2), count)
        tfused = (torch.from_numpy(s1), torch.from_numpy(s2), count)
    jo, ja = jreg.get(op).apply(
        jreg.OpContext(is_train=is_train, fused_stats=jfused), attrs, jins,
        jaux)
    to, ta = treg.get(op).apply(
        treg.OpContext(is_train=is_train, fused_stats=tfused), attrs, tins,
        taux)
    return jo, ja, to, ta


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

FC_CASES = [("fc_flatten", [(3, 2, 4), (5, 8), (5,)], dict(num_hidden=5)),
            ("fc_nobias", [(3, 8), (6, 8)], dict(num_hidden=6,
                                                  no_bias=True)),
            ("fc_noflatten", [(2, 3, 8), (4, 8), (4,)],
             dict(num_hidden=4, flatten=False))]


@pytest.mark.parametrize("case", FC_CASES, ids=[c[0] for c in FC_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_connected(case, dtype):
    name, shapes, attrs = case
    rng = _rng(name)
    ins = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jo, _, to, ta = _apply_both("FullyConnected", attrs, ins, dtype=dtype)
    assert ta is None and to[0].dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(to[0]), _jnp(jo[0]),
                               **(F32 if dtype == "float32" else BF16))
    _, out_shapes, _ = treg.get("FullyConnected").infer_shape(
        attrs, [shapes[0], None, None][:len(shapes)])
    assert tuple(out_shapes[0]) == jo[0].shape


BN_CASES = [("two_pass_f32", "float32", True, None),
            ("one_pass_bf16", "bfloat16", True, None),
            ("fused_stats", "float32", True, "fused"),
            ("eval_moving", "float32", False, None),
            ("eval_moving_bf16", "bfloat16", False, None)]


@pytest.mark.parametrize("case", BN_CASES, ids=[c[0] for c in BN_CASES])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_branches(case, fix_gamma):
    name, dtype, is_train, fused = case
    rng = _rng(name)
    c = 6
    x = (rng.standard_normal((2, 3, 4, c)) * 2 + 0.5).astype(np.float32)
    gamma = (rng.random(c) + 0.5).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    mm = rng.standard_normal(c).astype(np.float32)
    mv = (rng.random(c) + 0.5).astype(np.float32)
    attrs = dict(axis=3, eps=2e-5, momentum=0.9, fix_gamma=fix_gamma)
    stats = None
    if fused:
        x64 = x.reshape(-1, c).astype(np.float64)
        stats = (x64.sum(0).astype(np.float32),
                 (x64 * x64).sum(0).astype(np.float32), float(x64.shape[0]))
    jo, ja, to, ta = _apply_both("BatchNorm", attrs, [x, gamma, beta],
                                 [mm, mv], is_train=is_train, fused=stats,
                                 dtype=dtype)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(to[0]), _jnp(jo[0]), **tol)
    for j, t in zip(ja, ta):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(_np(t), _jnp(j), **F32)


def test_batch_norm_fused_stats_gradient():
    """Gradients through the statistics match the JAX package's, and the
    moving averages carry none."""
    rng = _rng("bn_grad")
    x = (rng.standard_normal((8, 5)) + 1.0).astype(np.float32)
    w = (rng.standard_normal((4, 5)) * 0.5).astype(np.float32)
    t = rng.standard_normal((8, 4)).astype(np.float32)
    gamma = (rng.random(4) + 0.5).astype(np.float32)
    beta = rng.standard_normal(4).astype(np.float32)
    aux = [np.zeros(4, np.float32), np.ones(4, np.float32)]
    attrs = dict(axis=-1, eps=1e-3, fix_gamma=False)

    def jloss(jx, jw, jg):
        y, s1, s2 = jpf.matmul_stats(jx, jw, True)
        outs, _ = jreg.get("BatchNorm").apply(
            jreg.OpContext(is_train=True, fused_stats=(s1, s2, 8.0)), attrs,
            [y, jg, jnp.asarray(beta)], [jnp.asarray(a) for a in aux])
        return jnp.sum(outs[0] * t)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w.T),
                                           jnp.asarray(gamma))
    tx, tw, tg = (torch.from_numpy(a).requires_grad_() for a in (x, w, gamma))
    y, s1, s2 = tms.matmul_stats(tx, tw)
    outs, aux_up = treg.get("BatchNorm").apply(
        treg.OpContext(is_train=True, fused_stats=(s1, s2, 8.0)), attrs,
        [y, tg, torch.from_numpy(beta)], [torch.from_numpy(a) for a in aux])
    (outs[0] * torch.from_numpy(t)).sum().backward()
    assert not any(u.requires_grad for u in aux_up)
    for got, want in zip((tx.grad, tw.grad.t(), tg.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)


SOFTMAX_CASES = [
    ("plain", (4, 7), (4,), {}),
    ("batch_norm_scale", (4, 7), (4,), dict(normalization="batch",
                                            grad_scale=0.5)),
    ("ignore_valid", (5, 6), (5,), dict(use_ignore=True, ignore_label=2,
                                        normalization="valid")),
    ("multi_output", (2, 5, 3), (2, 3), dict(multi_output=True,
                                             use_ignore=True,
                                             ignore_label=1)),
    ("preserve_shape", (2, 3, 6), (2, 3), dict(preserve_shape=True,
                                               normalization="valid")),
    ("label_out_of_range", (3, 4), (3,), {}),
]


@pytest.mark.parametrize("case", SOFTMAX_CASES,
                         ids=[c[0] for c in SOFTMAX_CASES])
def test_softmax_output_forward_and_gradient(case):
    name, dshape, lshape, attrs = case
    rng = _rng(name)
    x = rng.standard_normal(dshape).astype(np.float32)
    ncls = dshape[-1] if attrs.get("preserve_shape") else dshape[1]
    hi = ncls + 1 if name == "label_out_of_range" else ncls
    lab = rng.integers(0, hi, lshape).astype(np.float32)
    if name == "label_out_of_range":
        lab[0] = ncls                  # one_hot gives zeros, as in JAX
    cot = rng.standard_normal(dshape).astype(np.float32)   # ignored

    def jf(jx):
        outs, _ = jreg.get("SoftmaxOutput").apply(
            jreg.OpContext(is_train=True), attrs,
            [jx, jnp.asarray(lab)], [])
        return outs[0]

    jout, vjp = jax.vjp(jf, jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_()
    tout, _ = treg.get("SoftmaxOutput").apply(
        treg.OpContext(is_train=True), attrs, [tx, torch.from_numpy(lab)], [])
    tout[0].backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(tout[0]), np.asarray(jout), **F32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), **F32)


@pytest.mark.parametrize("op,shapes,attrs", [
    ("broadcast_add", [(2, 3, 4), (2, 3, 4)], {}),
    ("broadcast_add", [(2, 3, 4), (1, 3, 1)], {}),
    ("broadcast_mul", [(2, 1, 4), (2, 3, 1)], {}),
    ("elemwise_sub", [(3, 4), (3, 4)], {}),
    ("broadcast_mod", [(3, 4), (3, 4)], {}),
    ("broadcast_greater", [(3, 4), (3, 4)], {}),
    ("_plus_scalar", [(3, 4)], dict(scalar=1.5)),
    ("_rminus_scalar", [(3, 4)], dict(scalar=2.0)),
    ("_rdiv_scalar", [(3, 4)], dict(scalar=2.0)),
    ("_maximum_scalar", [(3, 4)], dict(scalar=0.1)),
    ("_hypot_scalar", [(3, 4)], dict(scalar=0.5)),
    ("_rmod_scalar", [(3, 4)], dict(scalar=2.5)),
    ("negative", [(3, 4)], {}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_binary_ops(op, shapes, attrs):
    rng = _rng(op + str(shapes))
    ins = [(rng.standard_normal(s) + 2.0).astype(np.float32) for s in shapes]
    jo, _, to, _ = _apply_both(op, attrs, ins)
    np.testing.assert_allclose(_np(to[0]), _jnp(jo[0]), **F32)


def test_symbol_arithmetic_builds_the_same_json():
    def build(pkg):
        with pkg.symbol.NameManager():
            a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
            return ((a + b) * 2 - b / a + (-a) + (1 - b) + 2 ** 1 * a
                    ).tojson()
    assert build(mt) == build(mx)


@pytest.mark.parametrize("momentum,clip", [(0.0, None), (0.9, None),
                                           (0.9, 0.05)])
def test_sgd_fused_update(momentum, clip):
    rng = _rng("sgd%s%s" % (momentum, clip))
    w = rng.standard_normal((4, 5)).astype(np.float32)
    g = (rng.standard_normal((4, 5)) * 0.1).astype(np.float32)
    m = rng.standard_normal((4, 5)).astype(np.float32) * 0.01
    kw = dict(momentum=momentum, learning_rate=0.1, wd=1e-4,
              clip_gradient=clip)
    jo = jopt.create("sgd", **kw)
    to = topt.create("sgd", **kw)
    jstate = None if momentum == 0 else jnp.asarray(m)
    tstate = None if momentum == 0 else torch.from_numpy(m.copy())
    jw, jm = jo.fused_update("w", jnp.asarray(w), jnp.asarray(g), jstate,
                             jnp.float32(0.1), 1e-4, jnp.float32(1.0))
    tw = torch.from_numpy(w.copy())
    rw, rm = to.fused_update("w", tw, torch.from_numpy(g), tstate, 0.1, 1e-4,
                             torch.tensor(1.0))
    assert rw is tw and rm is tstate                # in place
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    if momentum:
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jm), rtol=1e-6,
                                   atol=1e-7)


def test_optimizer_multipliers_from_symbol_attrs():
    def build(pkg):
        with pkg.symbol.NameManager():
            w = pkg.sym.Variable("fc_weight", lr_mult=0.5, wd_mult=0.0)
            out = pkg.sym.FullyConnected(data=pkg.sym.Variable("data"),
                                         weight=w, num_hidden=3, name="fc")
        return pkg.optimizer.create("sgd", sym=out, learning_rate=0.1,
                                    param_idx2name={0: "fc_bias"})
    j, t = build(mx), build(mt)
    assert t.lr_mult == j.lr_mult == {"fc_weight": 0.5}
    assert t.wd_mult == j.wd_mult


def test_lr_schedulers_match():
    pairs = [(jsched.FactorScheduler(3, 0.5), tsched.FactorScheduler(3, 0.5)),
             (jsched.MultiFactorScheduler([2, 5, 9], 0.1),
              tsched.MultiFactorScheduler([2, 5, 9], 0.1))]
    for j, t in pairs:
        j.base_lr = t.base_lr = 0.2
        assert [t(n) for n in range(1, 15)] == [j(n) for n in range(1, 15)]
    with pytest.raises(MXNetError):
        tsched.MultiFactorScheduler([3, 2])


# ---------------------------------------------------------------------------
# initializer and random state
# ---------------------------------------------------------------------------

def test_initializer_rules_shapes_and_statistics():
    x = tinit.Xavier()
    w = torch.zeros(256, 128, 3, 3)
    x(tinit.InitDesc("conv_weight"), w)
    bound = np.sqrt(3.0 / ((128 * 9 + 256 * 9) / 2.0))
    assert float(w.abs().max()) <= bound
    assert abs(float(w.std()) - bound / np.sqrt(3)) < 0.01 * bound
    assert abs(float(w.mean())) < 0.01 * bound
    for name, want in (("bn_gamma", 1.0), ("bn_beta", 0.0), ("fc_bias", 0.0),
                       ("bn_moving_mean", 0.0), ("bn_moving_var", 1.0)):
        t = torch.full((4,), 7.0)
        x(tinit.InitDesc(name), t)
        assert torch.equal(t, torch.full((4,), want))
    t = torch.zeros(4000)
    tinit.Xavier()(tinit.InitDesc("w_weight", {"__init__": tinit.Normal(
        0.5).dumps()}), t)
    assert abs(float(t.std()) - 0.5) < 0.03
    nd = mt.nd.array(np.zeros((3, 4), np.float32), ctx=mt.cpu())
    tinit.One()(tinit.InitDesc("anything"), nd)
    assert float(nd.data.sum()) == 12.0


def test_random_state_is_explicit_and_scoped():
    global_before = torch.random.get_rng_state()
    trandom.seed(7)
    a = torch.rand(5, generator=trandom.generator("cpu"))
    saved = trandom.get_state()
    b = torch.rand(5, generator=trandom.generator("cpu"))
    trandom.set_state(saved)
    assert torch.equal(torch.rand(5, generator=trandom.generator("cpu")), b)
    trandom.seed(7)
    assert torch.equal(torch.rand(5, generator=trandom.generator("cpu")), a)
    assert torch.equal(torch.random.get_rng_state(), global_before)


def test_init_state_shapes_match_jax():
    sym_j = _resnet(mx, jmodels, 18)
    sym_t = _resnet(mt, tmodels, 18)
    shapes = ({"data": (2, 16, 16, 3)}, {"softmax_label": (2,)})
    jst = JTrainStep(sym_j).init(*shapes)
    tst = TrainStep(sym_t, device="cpu").init(*shapes)
    for key in ("params", "aux", "opt"):
        assert sorted(tst[key]) == sorted(jst[key])
        for n in jst[key]:
            assert tuple(tst[key][n].shape) == tuple(jst[key][n].shape)
    assert tst["step"].dtype == torch.int32 and int(tst["step"]) == 0
    for n, v in tst["aux"].items():
        assert float(v.sum()) == (v.numel() if n.endswith("var") else 0)


# ---------------------------------------------------------------------------
# the fusion pass, end to end on a tiny graph
# ---------------------------------------------------------------------------

def _tiny(pkg):
    with pkg.symbol.NameManager():
        data = pkg.sym.Variable("data")
        c = pkg.sym.Convolution(data=data, num_filter=8, kernel=(1, 1),
                                no_bias=True, layout="NHWC", name="c")
        bn = pkg.sym.BatchNorm(data=c, axis=3, fix_gamma=False, eps=2e-5,
                               name="bn")
        r = pkg.sym.Activation(data=bn, act_type="relu")
        c2 = pkg.sym.Convolution(data=r, num_filter=6, kernel=(3, 3),
                                 pad=(1, 1), no_bias=True, layout="NHWC",
                                 name="c2")
        bn2 = pkg.sym.BatchNorm(data=c2, axis=3, fix_gamma=True, name="bn2")
        fc = pkg.sym.FullyConnected(data=pkg.sym.Flatten(bn2), num_hidden=3,
                                    name="fc")
        return pkg.sym.SoftmaxOutput(data=fc, name="softmax")


def _jax_fused_names(sym):
    nodes = jexec._topo(sym._out_nodes())
    names = set()
    for node in nodes:
        if (not node.is_variable and node.op.name == "BatchNorm"
                and jpf.bn_fusable(node.attrs)):
            src, idx = node.inputs[0]
            if (idx == 0 and not src.is_variable
                    and src.op.name == "Convolution"
                    and jpf.conv1x1_fusable(src.attrs)):
                names.add(src.name)
    return names


def _port_fused_names(sym):
    convs, _ = texec.fusion_pairs(texec._topo(sym._out_nodes()))
    return {n.name for n in convs.values()}


def test_fusion_end_to_end(monkeypatch):
    rng = _rng("tiny")
    jsym, tsym = _tiny(mx), _tiny(mt)
    assert _port_fused_names(tsym) == _jax_fused_names(jsym) == {"c"}
    arg_shapes, _, aux_shapes = jsym.infer_shape(data=(2, 4, 4, 5),
                                                 softmax_label=(2,))
    args = {}
    for n, s in zip(jsym.list_arguments(), arg_shapes):
        args[n] = (rng.integers(0, 3, s) if n == "softmax_label"
                   else rng.standard_normal(s) * 0.5).astype(np.float32)
    aux = {n: (np.ones(s) if n.endswith("var") else np.zeros(s))
           .astype(np.float32)
           for n, s in zip(jsym.list_auxiliary_states(), aux_shapes)}
    params = [n for n in args if n not in ("data", "softmax_label")]

    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "interpret")
    jrun, _ = jexec._build_graph_runner(jsym)

    def f(p):
        vals = {k: jnp.asarray(v) for k, v in args.items()}
        vals.update(p)
        return jrun(vals, {k: jnp.asarray(v) for k, v in aux.items()}, None,
                    True)

    (jouts, jaux), vjp = jax.vjp(f, {n: jnp.asarray(args[n])
                                     for n in params})
    (jgrads,) = vjp(([jnp.ones_like(o) for o in jouts],
                     {k: jnp.zeros_like(v) for k, v in jaux.items()}))

    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    trun, _ = texec._build_graph_runner(tsym)
    calls = []
    real = tms.apply_conv1x1_stats
    monkeypatch.setattr(tms, "apply_conv1x1_stats",
                        lambda x, w: calls.append(1) or real(x, w))
    leaves = {n: torch.from_numpy(args[n]).requires_grad_() for n in params}
    vals = {k: torch.from_numpy(v) for k, v in args.items()}
    vals.update(leaves)
    touts, taux = trun(vals, {k: torch.from_numpy(v) for k, v in aux.items()},
                       None, True)
    tgrads = torch.autograd.grad(touts, list(leaves.values()),
                                 [torch.ones_like(o) for o in touts],
                                 allow_unused=True)
    assert calls == [1]
    np.testing.assert_allclose(_np(touts[0]), np.asarray(jouts[0]), **F32)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(_np(taux[k]), np.asarray(jaux[k]), **F32)
    for n, g in zip(params, tgrads):
        # bn2's gamma is fixed at 1: unused here, a zero gradient in JAX
        g = torch.zeros_like(leaves[n]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[n]), **GRAD)
    # in eval the pair runs unfused
    calls.clear()
    with torch.no_grad():
        trun(vals, {k: torch.from_numpy(v) for k, v in aux.items()}, None,
             False)
    assert calls == []


def test_fuse_knob_spellings(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "yes")
    with pytest.raises(MXNetError, match="MXTPU_FUSE_CONV_BN"):
        texec._build_graph_runner(_tiny(mt))


# ---------------------------------------------------------------------------
# the ResNet symbol and its fusion pairs
# ---------------------------------------------------------------------------

def _resnet(pkg, models, layers, **kw):
    kw.setdefault("num_classes", 4 if layers == 18 else 1000)
    kw.setdefault("image_shape", "3,16,16" if layers == 18 else "3,224,224")
    with pkg.symbol.NameManager():
        return models.resnet(num_layers=layers, layout="NHWC", **kw)


@pytest.mark.parametrize("layers", [18, 50])
def test_resnet_symbol_json_and_fusion_pairs(layers):
    jsym, tsym = _resnet(mx, jmodels, layers), _resnet(mt, tmodels, layers)
    assert tsym.tojson() == jsym.tojson()
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    names = _port_fused_names(tsym)
    assert names == _jax_fused_names(jsym)
    assert len(names) == {18: 1, 50: 33}[layers]


# ---------------------------------------------------------------------------
# TrainStep against the JAX package from one carried-over state
# ---------------------------------------------------------------------------

B, H = 2, 16


def _batch(k=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    return {"data": rng.random(lead + (B, H, H, 3), dtype=np.float32),
            "softmax_label": rng.integers(0, 4, lead + (B,))
            .astype(np.float32)}


def _steps(monkeypatch, compute_dtype=None, lr=0.01):
    """(JAX TrainStep, port TrainStep, JAX state, port state) from one JAX
    init, fusion on in both."""
    kw = dict(optimizer="sgd", learning_rate=lr, momentum=0.9, wd=1e-4,
              compute_dtype=compute_dtype)
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "interpret")
    jstep = JTrainStep(_resnet(mx, jmodels, 18), **kw)
    jst = jstep.init({"data": (B, H, H, 3)}, {"softmax_label": (B,)}, seed=3)
    tst = convert.from_reference_state(jst, "cpu")
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    tstep = TrainStep(_resnet(mt, tmodels, 18), device="cpu", **kw)
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "interpret")
    return jstep, tstep, jst, tst


def _assert_state_close(tst, jst, tol):
    got = convert.to_reference_state(tst)
    assert int(got["step"]) == int(np.asarray(jst["step"]))
    for key in ("params", "aux", "opt"):
        assert sorted(got[key]) == sorted(jst[key])
        for n, v in jst[key].items():
            np.testing.assert_allclose(got[key][n], np.asarray(v),
                                       err_msg="%s %s" % (key, n), **tol)


def test_one_step_matches_jax(monkeypatch):
    jstep, tstep, jst, tst = _steps(monkeypatch)
    before = tms.LAUNCHES
    batch = _batch()
    jst, jouts = jstep.step(jst, batch)
    tst, touts = tstep.step(tst, batch)
    assert tms.LAUNCHES == before                  # CPU: the plain version
    np.testing.assert_allclose(_np(touts[0]), np.asarray(jouts[0]), **GRAD)
    _assert_state_close(tst, jst, dict(rtol=1e-4, atol=1e-5))


def test_steps_from_a_shared_state_match_jax(monkeypatch):
    """Three steps, each started from the JAX package's state of the step
    before: every step agrees to the one-step tolerance."""
    jstep, tstep, jst, _ = _steps(monkeypatch)
    sb = _batch(k=3, seed=1)
    for i in range(3):
        tst = convert.from_reference_state(jst, "cpu")
        batch = {n: v[i] for n, v in sb.items()}
        jst, _ = jstep.step(jst, batch)
        tst, _ = tstep.step(tst, batch)
        _assert_state_close(tst, jst, dict(rtol=1e-4, atol=1e-5))


def test_run_steps_matches_jax(monkeypatch):
    # lr 0.003: at 0.01 the step-1 differences (~1e-5 of the largest value,
    # as above) grow some 1e4-fold in one step through batch-2 BatchNorm,
    # while each step from a shared state still agrees (the test above)
    jstep, tstep, jst, tst = _steps(monkeypatch, lr=0.003)
    sb = _batch(k=3, seed=1)
    jst, jm = jstep.run_steps(jst, sb)
    tst, tm = tstep.run_steps(tst, sb)
    assert not tm.fetched
    assert tm.num_samples == jm.num_samples == 3 * B
    assert tm.top1_correct == jm.top1_correct
    np.testing.assert_allclose(tm.loss_sum, jm.loss_sum, rtol=1e-4)
    assert tstep._opt.num_update == jstep._opt.num_update == 3
    _assert_state_close(tst, jst, dict(rtol=1e-3, atol=1e-5))


def _update_dist(a, b, init, key):
    """Norm over all of ``key``'s tensors of (a - init) - (b - init)."""
    return np.sqrt(sum(np.sum(((a[key][n] - init[key][n])
                               - (b[key][n] - init[key][n])) ** 2)
                       for n in init[key]))


def test_one_step_bf16_matches_jax(monkeypatch):
    """bfloat16 compute: at batch 2 the gradient itself is mostly bf16
    rounding noise, amplified through BatchNorm over a handful of values
    (the JAX package's bf16 update is some 40% away from its f32 update), so
    the parameters are held in norm: the port's bf16 update is as close to
    the f32 update as the JAX package's bf16 update is (within 10%), the
    BatchNorm statistics agree with JAX's to 2e-2 of their norm, and the
    outputs elementwise to the bf16 tolerance."""
    jstep, tstep, jst, tst = _steps(monkeypatch, compute_dtype="bfloat16")
    j32step, _, _, _ = _steps(monkeypatch)
    init = convert.to_reference_state(tst)
    batch = _batch(seed=2)
    ref, _ = j32step.step(jax.tree_util.tree_map(jnp.asarray, init), batch)
    jst, jouts = jstep.step(jst, batch)
    tst, touts = tstep.step(tst, batch)
    assert touts[0].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in tst["params"].values())
    np.testing.assert_allclose(_np(touts[0]), _jnp(jouts[0]), **BF16)
    got = convert.to_reference_state(tst)
    jax_bf16, f32 = (jax.tree_util.tree_map(np.asarray, s)
                     for s in (jst, ref))
    for key in ("params", "opt"):
        assert _update_dist(got, f32, init, key) <= \
            1.1 * _update_dist(jax_bf16, f32, init, key)
    norm = np.sqrt(sum(np.sum((v - init["aux"][n]) ** 2)
                       for n, v in jax_bf16["aux"].items()))
    assert _update_dist(got, jax_bf16, init, "aux") <= 2e-2 * norm


def test_bf16_compute_keeps_labels_exact():
    """Label 999 rounds to 1000 in bfloat16, a class that does not exist.
    The port does not cast labels: the sample trains towards class 999."""
    assert float(torch.tensor(999.0).to(torch.bfloat16)) == 1000.0
    with mt.symbol.NameManager():
        fc = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=1000,
                                   name="fc")
        out = mt.sym.SoftmaxOutput(fc, name="softmax")
    step = TrainStep(out, optimizer="sgd", learning_rate=1.0, momentum=0.0,
                     compute_dtype="bfloat16", device="cpu")
    st = step.init({"data": (1, 8)}, {"softmax_label": (1,)},
                   initializer=tinit.Zero())
    step.step(st, {"data": np.ones((1, 8), np.float32),
                   "softmax_label": np.array([999.0], np.float32)})
    bias = st["params"]["fc_bias"]
    assert float(bias[999]) > 0 and float(bias.max()) == float(bias[999])


# ---------------------------------------------------------------------------
# device defaults
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card():
    assert current_context() == gpu(0)
    sym = _resnet(mt, tmodels, 18)
    if torch.cuda.is_available():
        assert TrainStep(sym).device == torch.device("cuda", 0)
        return
    with pytest.raises(MXNetError, match="CUDA is not available"):
        TrainStep(sym)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.nd.array(np.zeros(3, np.float32))
    with mt.cpu():
        assert mt.nd.array(np.zeros(3, np.float32)).context == mt.cpu()


@pytest.mark.parametrize("kw,what", [
    (dict(mesh=object()), "mesh"), (dict(param_shardings={"a": 1}),
                                    "param_shardings"),
    (dict(group2ctx={"g": 1}), "group2ctx"),
    (dict(remat="everything"), "remat")])
def test_unported_options_raise(kw, what):
    # every option is ported: a value it cannot take raises, naming it (a
    # mesh that is not a parallel.mesh.Mesh, param_shardings without a
    # mesh, a group2ctx value of no known kind, an unknown remat mode)
    with pytest.raises(MXNetError, match=what):
        TrainStep(_resnet(mt, tmodels, 18), device="cpu", **kw)


# ---------------------------------------------------------------------------
# remat: the forward recomputed in the backward
# ---------------------------------------------------------------------------

def _remat_net(pkg, nhwc):
    """Convolutions (a fused NHWC 1x1 one with nhwc), BatchNorm, a residual
    add that crosses segments, max pooling and Dropout."""
    kw = {"layout": "NHWC"} if nhwc else {}
    axis = {"axis": 3} if nhwc else {}
    with pkg.symbol.NameManager():
        d = pkg.sym.Variable("data")
        x = pkg.sym.Convolution(d, kernel=(3, 3), pad=(1, 1), num_filter=8,
                                name="c1", **kw)
        x = pkg.sym.BatchNorm(x, fix_gamma=False, name="bn1", **axis)
        x = pkg.sym.Activation(x, act_type="relu")
        y = pkg.sym.Convolution(x, kernel=(1, 1), num_filter=8, no_bias=True,
                                name="c2", **kw)
        y = pkg.sym.BatchNorm(y, fix_gamma=False, name="bn2", **axis)
        x = pkg.sym.Activation(y + x, act_type="relu")
        x = pkg.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                            **kw)
        x = pkg.sym.Dropout(pkg.sym.Flatten(x), p=0.3)
        x = pkg.sym.FullyConnected(x, num_hidden=5, name="fc")
        return pkg.sym.SoftmaxOutput(x, name="softmax")


@pytest.mark.parametrize("remat", [True, "conv"])
@pytest.mark.parametrize("nhwc", [False, True])
def test_remat_equals_no_remat_bitwise(monkeypatch, remat, nhwc):
    """Two steps with remat give the parameters, momentum and moving
    statistics of two steps without it, bit for bit on the CPU: the
    recompute runs the same ops on the same values, draws Dropout's mask
    again from the node's generator (the same mask), and its aux updates
    are dropped (the moving statistics move once a step). Under fusion the
    matmul-with-statistics runs twice a step's forward."""
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1" if nhwc else "0")
    shape = (4, 8, 8, 3) if nhwc else (4, 3, 8, 8)
    rng = _rng("remat%s" % nhwc)
    xs = rng.standard_normal((2,) + shape).astype(np.float32)
    ys = rng.integers(0, 5, (2, 4)).astype(np.float32)
    calls = []
    real = tms._forward
    monkeypatch.setattr(tms, "_forward",
                        lambda x, w: calls.append(1) or real(x, w))
    states, counts = {}, {}
    for mode in (False, remat):
        trandom.seed(1)
        step = TrainStep(_remat_net(mt, nhwc), optimizer="sgd",
                         learning_rate=0.1, momentum=0.9, wd=1e-4,
                         remat=mode, device="cpu")
        st = step.init({"data": shape}, {"softmax_label": (4,)}, seed=0)
        del calls[:]
        for i in range(2):
            st, _ = step.step(st, {"data": xs[i], "softmax_label": ys[i]})
        states[mode], counts[mode] = st, len(calls)
    for key in ("params", "aux", "opt"):
        for n, v in states[False][key].items():
            assert torch.equal(v, states[remat][key][n]), (key, n)
    # the moving statistics moved once a step: not twice
    assert not torch.equal(states[False]["aux"]["bn1_moving_mean"],
                           torch.zeros(8))
    assert counts[False] == (2 if nhwc else 0)
    assert counts[remat] == 2 * counts[False]


def test_remat_dropout_mask_is_the_forwards():
    """The gradient under remat is the gradient through the forward's own
    Dropout mask: zero exactly where the forward dropped."""
    with mt.symbol.NameManager():
        d = mt.sym.Variable("data")
        x = mt.sym.Dropout(mt.sym.FullyConnected(d, num_hidden=64,
                                                 name="fc1"), p=0.5)
        out = mt.sym.MakeLoss(mt.sym.sum(x))
    for mode in (False, True, "conv"):
        trandom.seed(5)
        step = TrainStep(out, label_names=(), optimizer="sgd",
                         learning_rate=1.0, momentum=0.0, remat=mode,
                         device="cpu", rescale_grad=1.0)
        st = step.init({"data": (2, 3)}, seed=0)
        b0 = st["params"]["fc1_bias"].clone()
        step.step(st, {"data": np.ones((2, 3), np.float32)})
        # d(sum)/d(bias) is the sum over the batch of mask / keep
        g = (b0 - st["params"]["fc1_bias"]).numpy()
        assert set(np.unique(g)) <= {0.0, 2.0, 4.0}, (mode, np.unique(g))
        if mode is False:
            want = g
        np.testing.assert_array_equal(g, want, err_msg=str(mode))


def test_remat_matches_jax(monkeypatch):
    """remat=True and "conv" in the port against the JAX package's step
    under the same remat (jax.checkpoint) from one state, ResNet-18 NHWC
    with the fusion, no Dropout (its masks cannot match): the one-step
    tolerance."""
    batch = _batch(seed=4)
    kw = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9, wd=1e-4)
    for mode in (True, "conv"):
        monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "interpret")
        jstep = JTrainStep(_resnet(mx, jmodels, 18), remat=mode, **kw)
        jst = jstep.init({"data": (B, H, H, 3)}, {"softmax_label": (B,)},
                         seed=3)
        tst = convert.from_reference_state(jst, "cpu")
        monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
        tstep = TrainStep(_resnet(mt, tmodels, 18), remat=mode,
                          device="cpu", **kw)
        monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "interpret")
        jst, _ = jstep.step(jst, batch)
        tst, _ = tstep.step(tst, batch)
        _assert_state_close(tst, jst, dict(rtol=1e-4, atol=1e-5))


# ---------------------------------------------------------------------------
# MXTPU_BF16_STATS: bfloat16 storage of the aux and optimizer states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "opt"])
@pytest.mark.parametrize("fuse", ["0", "1"])
def test_bf16_stats_match_jax(monkeypatch, mode, fuse):
    """The storage dtypes are the JAX package's, and after one step from a
    shared state (moving statistics drawn away from their init) the
    bfloat16 moving statistics equal the JAX package's bit for bit: the
    momentum factors are rounded to bfloat16 as JAX's weak-typed Python
    floats are, and the update rounds after each operation. The parameters
    (float32 masters) and optimizer states hold the one-step tolerance."""
    monkeypatch.setenv("MXTPU_BF16_STATS", mode)
    kw = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN",
                       "interpret" if fuse == "1" else "0")
    jstep = JTrainStep(_tiny(mx), **kw)
    jst = jstep.init({"data": (4, 5, 5, 6)}, {"softmax_label": (4,)},
                     seed=1)
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", fuse)
    tstep = TrainStep(_tiny(mt), device="cpu", **kw)
    assert tstep.bf16_stats and tstep.bf16_opt == (mode == "opt")
    tinit_st = tstep.init({"data": (4, 5, 5, 6)}, {"softmax_label": (4,)})
    rng = _rng("bf16 stats " + mode + fuse)
    jst["aux"] = {n: jnp.asarray(rng.uniform(0.5, 1.5, v.shape))
                  .astype(jnp.bfloat16) for n, v in jst["aux"].items()}
    tst = convert.from_reference_state(jst, "cpu")
    for key in ("aux", "opt"):
        for n, v in jst[key].items():
            assert tst[key][n].dtype == tinit_st[key][n].dtype == \
                getattr(torch, str(v.dtype)), (key, n)
    assert all(v.dtype == torch.float32 for v in tst["params"].values())
    batch = {"data": rng.standard_normal((4, 5, 5, 6)).astype(np.float32),
             "softmax_label": rng.integers(0, 3, 4).astype(np.float32)}
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN",
                       "interpret" if fuse == "1" else "0")
    jst, _ = jstep.step(jst, batch)
    tst, _ = tstep.step(tst, batch)
    for n, v in jst["aux"].items():
        assert tst["aux"][n].dtype == torch.bfloat16
        np.testing.assert_array_equal(tst["aux"][n].float().numpy(),
                                      _jnp(v), err_msg=n)
    for key in ("params", "opt"):
        for n, v in jst[key].items():
            np.testing.assert_allclose(_np(tst[key][n]), _jnp(v), rtol=1e-4,
                                       atol=1e-5, err_msg="%s %s" % (key, n))


def test_bf16_stats_checkpoint_writes_float32(monkeypatch, tmp_path):
    """Module.fit under MXTPU_BF16_STATS=opt: the fused state stores
    bfloat16, the executor and the checkpoint float32, and a float32 -> bf16
    -> float32 round trip is exact, so resume is bit for bit."""
    monkeypatch.setenv("MXTPU_BF16_STATS", "opt")
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    rng = _rng("bf16 fit")
    X = rng.standard_normal((32, 5, 5, 6)).astype(np.float32)
    y = rng.integers(0, 3, 32).astype(np.float32)

    def run(prefix, stop=None, resume=None):
        trandom.seed(0)
        mod = mt.mod.Module(_tiny(mt), context=mt.cpu())

        def cb(p):
            if stop is not None and p.nbatch + 1 >= stop:
                raise KeyboardInterrupt
        try:
            mod.fit(mt.io.NDArrayIter(X, y, batch_size=8), num_epoch=2,
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9},
                    initializer=tinit.Xavier(), batch_end_callback=cb,
                    checkpoint_prefix=prefix, checkpoint_every_n_batches=2,
                    resume=resume)
        except KeyboardInterrupt:
            pass
        return mod

    mod = run(str(tmp_path / "ref"))
    st = mod._fused_state
    assert all(v.dtype == torch.bfloat16 for v in st["aux"].values())
    assert all(v.dtype == torch.bfloat16 for v in st["opt"].values()
               if v is not None)
    arg, aux = mod.get_params()
    assert all(v.dtype == np.float32 for v in aux.values())
    ck = mt.model.CheckpointManager(str(tmp_path / "ref")).load_latest()
    for n, v in ck.aux_params.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v.asnumpy(), st["aux"][n].float()
                                      .numpy())
    import pickle
    states = pickle.loads(open(ck.opt_states_file, "rb").read())
    assert all(np.asarray(s).dtype == np.float32 for s in states.values())
    run(str(tmp_path / "vic"), stop=3)
    got = run(str(tmp_path / "vic"), resume="auto")
    for n, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(got.get_params()[0][n].asnumpy(),
                                      v.asnumpy(), err_msg=n)
