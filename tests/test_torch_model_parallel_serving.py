"""Model-parallel serving in the port (``ServingEngine(contexts=)``,
``DecodeLoop(contexts=)``, the executor's ``node_constraint``,
``simple_bind(shared_exec=)`` across contexts) against the JAX package's,
on the CPU.

The JAX package runs its sharded engines and loops on the conftest's 8
virtual CPU devices; the port runs 2 and 4 mesh positions that all share
the host CPU (a divergence kept on purpose: the JAX package wants a device
a position). Inputs are numpy arrays from seeds: the MLP and LM weights of
``tests/test_fleet.py`` and a narrow SSD (``width=8``, 64x64) from
``default_rng(0)``.

Tolerances:

- the MLP (FullyConnected stacks): ``rtol 1e-6`` against the port's own
  single-device engine (the per-position products of half the output
  width read up to 5.96e-8 apart on values up to 0.44: torch's CPU matmul
  picks its kernel by the shape) and against both JAX engines, single and
  sharded (which differ from each other by 2.98e-8);
- the SSD: bit for bit against the port's single-device engine, heads and
  detections (each convolution's output channels are computed alike), and
  its heads within ``atol 1e-5`` of both JAX engines (convolutions of
  another library);
- decoding: token for token, greedy and sampled, against the JAX sharded
  loop and the port's single-device loop; shard shapes exactly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.models import ssd as jssd
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert, serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import multibox_nms
from mxnet_tpu_torch.parallel import mesh as pm
from mxnet_tpu_torch.serving import quantize as tq

RTOL_FC = 1e-6
ATOL_CONV = 1e-5
SSD_SHAPE = (3, 64, 64)
HEADS = ["cls_prob", "multibox_loc_pred", "multibox_anchors"]


def _ctx(pkg, n, as_list):
    return [pkg.cpu(i) for i in range(n)] if as_list else n


# ---------------------------------------------------------------------------
# the MLP of tests/test_fleet.py
# ---------------------------------------------------------------------------

def _mlp_sym(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                                 name="fc1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _mlp_params(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "arg:fc1_weight": rs.randn(8, 6).astype(np.float32) * 0.5,
        "arg:fc1_bias": rs.randn(8).astype(np.float32) * 0.1,
        "arg:fc2_weight": rs.randn(4, 8).astype(np.float32) * 0.5,
        "arg:fc2_bias": rs.randn(4).astype(np.float32) * 0.1,
    }


def _engine(params=None, **kw):
    return serving.ServingEngine(_mlp_sym(mt), params or _mlp_params(),
                                 {"data": (6,)}, buckets=(4, 8),
                                 device="cpu", **kw)


def _jengine(**kw):
    return jserving.ServingEngine(_mlp_sym(mx), _mlp_params(),
                                  {"data": (6,)}, buckets=(4, 8), **kw)


def _x(n, seed=1):
    return np.random.RandomState(seed).rand(n, 6).astype(np.float32)


def _parts(arr):
    return [tuple(p.shape) for p in arr.parts]


def _jparts(arr):
    return [tuple(s.data.shape) for s in arr.addressable_shards]


@pytest.mark.parametrize("n,as_list", [(2, False), (2, True), (4, False),
                                       (4, True)])
def test_sharded_mlp_matches_single_and_both_jax_engines(n, as_list):
    x = _x(3)
    eng = _engine(contexts=_ctx(mt, n, as_list))
    assert eng.model_devices == n
    assert eng.device == torch.device("cpu")
    got = eng.infer({"data": x})[0]
    single = _engine().infer({"data": x})[0]
    np.testing.assert_allclose(got, single, rtol=RTOL_FC, atol=0)
    for jeng in (_jengine(), _jengine(contexts=_ctx(mx, n, True))):
        np.testing.assert_allclose(got, jeng.infer({"data": x})[0],
                                   rtol=RTOL_FC, atol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_param_shards_match_jax_addressable_shards(n):
    """Every leaf, f32 and int8 (payload and scale), is laid out shard for
    shard as the JAX package lays it out; fc1_weight (8, 6) over two
    positions is {(4, 6)}; the weights come across through convert."""
    arg, _ = convert.from_reference_params(
        {k[4:]: mx.nd.array(v) for k, v in _mlp_params().items()}, {},
        "cpu")
    for quant in ("none", "int8"):
        eng = serving.ServingEngine(
            _mlp_sym(mt), {"arg:" + k: v for k, v in arg.items()},
            {"data": (6,)}, buckets=(4,), device="cpu", contexts=n,
            quantize=quant)
        jeng = _jengine(contexts=n, quantize=quant)
        params = eng._state[0]
        assert set(params) == set(jeng._params)
        for name, leaf in params.items():
            jleaf = jeng._params[name]
            if tq.is_quantized_leaf(leaf):
                for k in ("q", "s"):
                    assert _parts(leaf[k]) == _jparts(jleaf[k]), (name, k)
                # the scale rides its payload's split of axis 0
                assert leaf["s"].spec[0] == leaf["q"].spec[0]
            else:
                assert _parts(leaf) == _jparts(jleaf), name
        if n == 2 and quant == "none":
            assert set(_parts(params["fc1_weight"])) == {(4, 6)}
        # weight bytes stay global; a position holds its shards' share
        assert eng.weight_bytes() == _engine(quantize=quant).weight_bytes()
        assert eng.weight_bytes(0) < eng.weight_bytes()


def test_gathers_counted_a_dispatch():
    x = {"data": _x(3)}
    single, sharded = _engine(), _engine(contexts=2)
    pm.reset_counters()
    single.infer(x)
    assert pm.COUNTERS["all_gather"] == 0
    sharded.infer(x)
    # fc1's and fc2's output slices, gathered once each
    assert pm.COUNTERS["all_gather"] == 2
    assert pm.COUNTERS["all_reduce"] == 0


def test_node_constraint_runs_after_every_node():
    """The executor's hook sees every op node, once a walk, with or
    without a mesh, and what it returns is what the next node reads."""
    from mxnet_tpu_torch.executor import _build_graph_runner
    seen = []

    def hook(node, outs):
        seen.append(node.name)
        return [o * 2 if node.name == "relu1" else o for o in outs]
    run, nodes = _build_graph_runner(_mlp_sym(mt), node_constraint=hook)
    args = {k[4:]: torch.from_numpy(v) for k, v in _mlp_params().items()}
    args.update(data=torch.from_numpy(_x(2)),
                softmax_label=torch.zeros(2))
    plain, _ = _build_graph_runner(_mlp_sym(mt))[0](args, {})
    got, _ = run(args, {})
    assert seen == [n.name for n in nodes if not n.is_variable]
    assert not np.allclose(got[0].numpy(), plain[0].numpy())


def test_batcher_and_mixed_fleet_compose():
    single, sharded = _engine(), _engine(contexts=2)
    b = serving.Batcher(sharded, max_latency_ms=1.0)
    try:
        out = b.infer({"data": _x(2)})[0]
        np.testing.assert_array_equal(out,
                                      sharded.infer({"data": _x(2)})[0])
    finally:
        b.close()
    router = serving.FleetRouter({
        "one": serving.Batcher(single, max_latency_ms=1.0),
        "sharded": serving.Batcher(sharded, max_latency_ms=1.0)})
    try:
        outs = [router.infer({"data": _x(1 + i % 3, seed=i)},
                             priority=("interactive", "batch")[i % 2])[0]
                for i in range(12)]
        router.drain("sharded", timeout=30.0)
        router.join("sharded2", lambda: serving.Batcher(
            _engine(contexts=[mt.cpu(0), mt.cpu(1)]), max_latency_ms=1.0))
        outs += [router.infer({"data": _x(2, seed=20 + i)})[0]
                 for i in range(4)]
        rep = router.report()
        devs = {n: r["model_devices"] for n, r in rep["replicas"].items()}
        assert devs == {"one": 1, "sharded": 2, "sharded2": 2}
        assert rep["fleet"]["shed"] == 0 and rep["fleet"]["errors"] == 0
        weights = router.weight_report()
        assert sorted(w["model_devices"] for w in weights.values()) == [1, 2]
    finally:
        router.close()
    seeds = [(1 + i % 3, i) for i in range(12)] + [(2, 20 + i)
                                                   for i in range(4)]
    for (n, s), got in zip(seeds, outs):
        np.testing.assert_allclose(
            got, single.infer({"data": _x(n, seed=s)})[0], rtol=RTOL_FC,
            atol=0)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_update_params_on_a_sharded_engine(quant):
    new = _mlp_params(seed=5)
    eng = _engine(contexts=2, quantize=quant)
    before = [_parts(v["q"] if tq.is_quantized_leaf(v) else v)
              for v in eng._state[0].values()]
    eng.update_params({k[4:]: v for k, v in new.items()})
    after = [_parts(v["q"] if tq.is_quantized_leaf(v) else v)
             for v in eng._state[0].values()]
    assert before == after
    fresh = _engine(new, contexts=2, quantize=quant)
    x = {"data": _x(5)}
    np.testing.assert_array_equal(eng.infer(x)[0], fresh.infer(x)[0])


def test_duplicate_device_positions_are_a_kept_divergence():
    """The JAX package refuses contexts that resolve to one device; the
    port takes them as positions sharing it (one card, or the host CPU),
    and 0, 1 or one context builds no mesh in both."""
    from mxnet_tpu.base import MXNetError as JMXNetError
    with pytest.raises(JMXNetError, match="duplicate devices"):
        _jengine(contexts=[mx.cpu(0), mx.cpu(0)])
    x = {"data": _x(3)}
    eng = _engine(contexts=[mt.cpu(0), mt.cpu(0)])
    assert eng.model_devices == 2
    np.testing.assert_allclose(eng.infer(x)[0], _engine().infer(x)[0],
                               rtol=RTOL_FC, atol=0)
    for ctx in (0, 1, [mt.cpu(3)]):
        assert _engine(contexts=ctx).model_devices == 1
    with pytest.raises(MXNetError, match="first of contexts"):
        serving.ServingEngine(_mlp_sym(mt), _mlp_params(), {"data": (6,)},
                              buckets=(4,), contexts=["meta"] * 2,
                              device="cpu")


def test_sharded_resnet_with_batchnorm_matches_single():
    """A convolutional net with BatchNorm (moving statistics served,
    gammas split by the rule) over two positions: rtol 1e-5 of one
    device's probabilities."""
    with mt.symbol.NameManager():
        sym = mt.models.resnet(num_classes=4, num_layers=18,
                               image_shape="3,16,16")
    shapes, _, aux_shapes = sym.infer_shape(data=(1, 3, 16, 16))
    rng = np.random.default_rng(3)
    arg = {"arg:" + n: (rng.standard_normal(s) * 0.2).astype(np.float32)
           for n, s in zip(sym.list_arguments(), shapes)
           if n not in ("data", "softmax_label")}
    aux = {"aux:" + n: (rng.random(s) + 0.5).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    x = {"data": rng.random((3, 3, 16, 16), dtype=np.float32)}
    outs = [serving.ServingEngine(sym, dict(arg, **aux),
                                  {"data": (3, 16, 16)}, buckets=(4,),
                                  device="cpu", contexts=c).infer(x)[0]
            for c in (None, 2)]
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the narrow SSD: convolutions and B2's plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssd():
    net = jssd.get_symbol(num_classes=3, width=8)
    shapes, _, _ = net.infer_shape(data=(1,) + SSD_SHAPE)
    rng = np.random.default_rng(0)
    params = {}
    for name, shape in zip(net.list_arguments(), shapes):
        if name == "data":
            continue
        scale = (np.sqrt(2.0 / np.prod(shape[1:]))
                 if name.endswith("_weight") else 0.1)
        params[name] = (rng.standard_normal(shape) * scale).astype(
            np.float32)
    images = rng.random((6,) + SSD_SHAPE, dtype=np.float32)
    return net.tojson(), params, images


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_ssd_matches_single_and_jax_with_one_nms_a_dispatch(
        ssd, n, monkeypatch):
    sym, params, images = ssd

    def port(**kw):
        return serving.ServingEngine(sym, params, {"data": SSD_SHAPE},
                                     buckets=(1, 4), device="cpu", **kw)
    single, sharded = port(), port(contexts=n)
    sheads = port(contexts=n, output_names=HEADS)
    jheads = [jserving.ServingEngine(sym, params, {"data": SSD_SHAPE},
                                     buckets=(1, 4), output_names=HEADS,
                                     **kw)
              for kw in ({}, {"contexts": n})]
    calls = []
    plain = multibox_nms.nms_alive

    def counting(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)
    monkeypatch.setattr(multibox_nms, "nms_alive", counting)
    for k in (1, 3, 4):
        x = {"data": images[:k]}
        del calls[:]
        before = sharded.health.batches
        det = sharded.infer(x)[0]
        assert len(calls) == sharded.health.batches - before == 1
        np.testing.assert_array_equal(det, single.infer(x)[0])
        assert (det[..., 0] >= 0).any()
        heads = sheads.infer(x)
        for jeng in jheads:
            for a, b in zip(heads, jeng.infer(x)):
                np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_CONV)
    pm.reset_counters()
    sharded.infer({"data": images[:1]})
    # one gather for each convolution's output slices
    convs = sum(1 for k in params if k.endswith("_weight")
                and params[k].shape[0] % n == 0)
    assert pm.COUNTERS["all_gather"] == convs


def test_unported_audits_still_raise_on_a_sharded_engine():
    """The communication audits of a sharded engine (the name predates
    them, when they raised): each bucket's inventory equals the JAX
    sharded engine's exactly (two all-gathers along 'model', FC1's and
    FC2's output slices, at the same payloads), counts what a real
    dispatch of that bucket counts in ``COUNTERS``, and lints clean, as
    the JAX package's contract for a sharded engine is."""
    eng = _engine(contexts=2)
    reps = {n.split("/", 1)[1]: r for n, r in eng.comms_report().items()}
    jreps = {n.split("/", 1)[1]: r
             for n, r in _jengine(contexts=2).comms_report().items()}
    assert sorted(reps) == sorted(jreps) == ["bucket[b=4]", "bucket[b=8]"]

    def sig(rep):
        return sorted((e.kind, tuple(e.axes), e.bytes, e.in_loop)
                      for e in rep.entries)
    for tag, rep in reps.items():
        assert sig(rep) == sig(jreps[tag])
        assert rep.counts_by_kind() == {"all-gather": 2}
        b = int(tag[len("bucket[b="):-1])
        pm.reset_counters()
        eng.infer({"data": _x(b)})
        assert pm.COUNTERS["all_gather"] == rep.collective_count
    assert eng.check(comms=True) == []
    # memory_report: every position's bytes on the one host
    # device, where the positions' shards and the replicated inputs share
    # their storage (the whole mesh's footprint), as one engine's
    reps, one = eng.memory_report(), _engine().memory_report()
    assert sorted(reps) == [4, 8]
    for b, rep in reps.items():
        assert rep.program == "%s/bucket[b=%d]" % (eng.name, b)
        assert rep.argument_bytes == eng.weight_bytes() + b * 6 * 4 \
            == one[b].argument_bytes


# ---------------------------------------------------------------------------
# the decode loop over a 'model' mesh
# ---------------------------------------------------------------------------

L, H, E, V, MAXLEN, SLOTS = 2, 4, 16, 32, 24, 2
PROMPTS = [[3, 5, 7], [1, 2], [9, 4, 4, 8], [6]]
SAMPLED = dict(temperature=0.8, top_k=10, top_p=0.9)


def _lm_params(num_layers=L, num_heads=H, embed=E, vocab=V, max_len=MAXLEN,
               seed=3):
    rs = np.random.RandomState(seed)
    p = {"tok_embed_weight": rs.randn(vocab, embed) * 0.3,
         "pos_embed_weight": rs.randn(max_len, embed) * 0.1,
         "final_ln_gamma": np.ones(embed), "final_ln_beta": np.zeros(embed),
         "lm_head_weight": rs.randn(vocab, embed) * 0.3,
         "lm_head_bias": np.zeros(vocab)}
    for i in range(num_layers):
        pre = "layer%d" % i
        p[pre + "_ln1_gamma"] = np.ones(embed)
        p[pre + "_ln1_beta"] = np.zeros(embed)
        p[pre + "_ln2_gamma"] = np.ones(embed)
        p[pre + "_ln2_beta"] = np.zeros(embed)
        p[pre + "_attn_qkv_weight"] = rs.randn(3 * embed, embed) * 0.2
        p[pre + "_attn_qkv_bias"] = np.zeros(3 * embed)
        p[pre + "_attn_out_weight"] = rs.randn(embed, embed) * 0.2
        p[pre + "_attn_out_bias"] = np.zeros(embed)
        p[pre + "_ffn_fc1_weight"] = rs.randn(4 * embed, embed) * 0.2
        p[pre + "_ffn_fc1_bias"] = np.zeros(4 * embed)
        p[pre + "_ffn_fc2_weight"] = rs.randn(embed, 4 * embed) * 0.2
        p[pre + "_ffn_fc2_bias"] = np.zeros(embed)
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


PARAMS = _lm_params()
DRAFT = _lm_params(num_layers=1, seed=8)


def _loop(pkg, params=PARAMS, **kw):
    kw.setdefault("slots", SLOTS)
    if pkg is serving:
        kw.setdefault("device", "cpu")
    return pkg.DecodeLoop(params, L, H, MAXLEN, **kw)


def _streams(loop, gen=None, prefix_len=0, n=8):
    futs = [loop.generate(p if not prefix_len else PROMPTS[0][:2] + p, n,
                          seed=11 + i, prefix_len=prefix_len,
                          **(gen or {}))
            for i, p in enumerate(PROMPTS)]
    return [f.result(timeout=120.0) for f in futs]


def _run(pkg, gen=None, prefix_len=0, params=PARAMS, **kw):
    loop = _loop(pkg, params, **kw)
    try:
        return _streams(loop, gen, prefix_len), loop
    finally:
        loop.close()


@pytest.mark.parametrize("n,as_list", [(2, False), (4, True)])
def test_sharded_decode_tokens_match_jax_sharded_and_single(n, as_list):
    for gen in (None, SAMPLED):
        got, loop = _run(serving, gen, contexts=_ctx(mt, n, as_list))
        single, _ = _run(serving, gen)
        jax_sharded, jloop = _run(jserving, gen,
                                  contexts=_ctx(mx, n, True))
        assert got == single == jax_sharded
    assert len(loop._state["k"].parts) == n
    # K and V split over heads: the port's cache keeps one trash row past
    # max_len in every loop (the JAX package's only with spec_k)
    for k in ("k", "v"):
        assert _parts(loop._state[k]) == [(L, SLOTS, H // n, MAXLEN + 1,
                                           E // H)] * n
        assert _jparts(jloop._state[k]) == [(L, SLOTS, H // n, MAXLEN,
                                             E // H)] * n
    assert _parts(loop._state["seed"]) == [(SLOTS,)] * n
    # every parameter leaf as the JAX sharded loop lays it out
    for name, leaf in loop._params.items():
        assert _parts(leaf) == _jparts(jloop._params[name]), name
    assert loop.weight_bytes() == _loop(serving).weight_bytes()


def test_sharded_int8_decode_lays_out_and_matches_single_int8():
    got, loop = _run(serving, contexts=2, quantize="int8")
    single, _ = _run(serving, quantize="int8")
    jloop = _loop(jserving, contexts=2, quantize="int8")
    try:
        for name, leaf in loop._params.items():
            jleaf = jloop._params[name]
            if tq.is_quantized_leaf(leaf):
                for k in ("q", "s"):
                    assert _parts(leaf[k]) == _jparts(jleaf[k]), (name, k)
            else:
                assert _parts(leaf) == _jparts(jleaf), name
    finally:
        jloop.close()
    assert got == single


def test_sharded_prefix_and_speculative_legs_token_for_token():
    target, _ = _run(serving, SAMPLED, contexts=2)
    spec, loop = _run(serving, SAMPLED, contexts=2, spec_k=2,
                      draft_params=DRAFT, draft_num_layers=1)
    assert spec == target
    assert _parts(loop._draft_state["k"]) == [(1, SLOTS, H // 2, MAXLEN + 1,
                                               E // H)] * 2
    cold, _ = _run(serving, SAMPLED, prefix_len=2, contexts=2,
                   prefix_cache=False)
    warm, loop = _run(serving, SAMPLED, prefix_len=2, contexts=2,
                      prefix_cache=True)
    assert warm == cold
    h = loop.health.report()
    assert h["prefix_hits"] >= 1 and h["prefix_prefills"] == 1
    slab = next(iter(loop._prefix.values()))["target"]["k"]
    assert _parts(slab) == [(L, H // 2, MAXLEN + 1, E // H)] * 2
    both, _ = _run(serving, SAMPLED, prefix_len=2, contexts=2,
                   prefix_cache=True, spec_k=2, draft_params=DRAFT,
                   draft_num_layers=1)
    assert both == cold


def test_update_params_on_a_sharded_loop():
    new = _lm_params(seed=9)
    loop = _loop(serving, contexts=2)
    try:
        loop.update_params(new)
        got = _streams(loop)
        assert _parts(loop._params["layer0_attn_qkv_weight"]) == \
            [(3 * E // 2, E)] * 2
    finally:
        loop.close()
    fresh, _ = _run(serving, params=new, contexts=2)
    assert got == fresh


def test_heads_must_divide_over_the_positions():
    with pytest.raises(MXNetError, match="num_heads 4 % 3"):
        _loop(serving, contexts=3)
    with pytest.raises(MXNetError, match="draft_num_heads 1 % 2"):
        _loop(serving, contexts=2, spec_k=2, draft_params=DRAFT,
              draft_num_layers=1, draft_num_heads=1)


# ---------------------------------------------------------------------------
# simple_bind(shared_exec=) across contexts of one device
# ---------------------------------------------------------------------------

def test_shared_exec_across_cpu_contexts_shares_the_arrays():
    """As in the JAX package, ``simple_bind(cpu(0), shared_exec=<bound on
    cpu(1)>)`` hands back the shared executor's very arrays: both contexts
    are the one host device."""
    shapes = {"data": (4, 6), "softmax_label": (4,)}
    for pkg in (mx, mt):
        sym = _mlp_sym(pkg)
        ex1 = sym.simple_bind(pkg.cpu(1), **shapes)
        ex0 = sym.simple_bind(pkg.cpu(0), shared_exec=ex1, **shapes)
        for n in ("fc1_weight", "fc2_bias", "data"):
            assert ex0.arg_dict[n] is ex1.arg_dict[n], (pkg.__name__, n)
            assert ex0.grad_dict[n] is ex1.grad_dict[n], (pkg.__name__, n)
    ex1.arg_dict["fc1_weight"][:] = np.ones((8, 6), np.float32)
    x = _x(4)
    np.testing.assert_array_equal(
        ex0.forward(data=x)[0].asnumpy(), ex1.forward(data=x)[0].asnumpy())
