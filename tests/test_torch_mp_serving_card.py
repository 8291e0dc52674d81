"""Model-parallel serving on the card: ``ServingEngine(contexts=2)`` and
``DecodeLoop(contexts=2)`` with both positions on ``cuda:0``, at a small
size (``chip_smoke.py`` phase 21 runs the full-width SSD and LM).

A narrow SSD (``models/ssd.get_symbol(num_classes=3, width=8)``, 3x64x64,
weights from a numpy seed) served in float32 with TF32 off and cuDNN
deterministic:

- (a) the sharded engine's detections and heads against the single-device
  engine's, largest |difference| over largest |value| within ``TOL``
  (1e-5: a position's convolution has half the output channels, so cuDNN
  may take other algorithms); its detections equal MultiBoxDetection
  with the plain NMS on its own heads, bit for bit; B2 launches once a
  dispatch, and the outputs' slices are gathered;
- (b) sharded bf16 and int8 engines equal sharded f32 engines of the
  host-dequantized weights, bit for bit, each int8 scale split as its
  payload;
- (c) a 2-layer LM (embed 32, 4 heads, vocabulary 64) through a sharded
  loop: teacher-forced, it picks at least 0.99 of the single-device
  loop's greedy and sampled tokens again; its prefix-cache and spec_k 2
  legs equal its target-only streams token for token; each position
  holds (layers, slots, 2, max_len + 1, head_dim) of K and of V;
- (d) a FleetRouter over a single-device and a sharded replica across a
  drain and a join: every answer equals one of the two engines' answers
  for its image, bit for bit, and ``report()`` names each replica's
  ``model_devices``.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mp_serving_card.py -q

Without CUDA each test skips, with its reason.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import ssd
from mxnet_tpu_torch.ops import contrib, multibox_nms as mnms
from mxnet_tpu_torch.parallel import mesh as pm
from mxnet_tpu_torch.serving import (Batcher, DecodeLoop, FleetRouter,
                                     ServingEngine)
from mxnet_tpu_torch.serving import quantize as tq
from mxnet_tpu_torch.symbol import _topo

SHAPE = (3, 64, 64)
BUCKETS = (1, 4)
HEADS = ["cls_prob", "multibox_loc_pred", "multibox_anchors"]
TOL = 1e-5
AGREE = 0.99


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sharded engines and loops "
                    "run their positions on cuda:0 (chip_smoke.py phase "
                    "21 drives them)")


@pytest.fixture
def fp32_deterministic():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = prev


def _checkpoint(seed=0):
    with mt.symbol.NameManager():
        net = ssd.get_symbol(num_classes=3, width=8)
    shapes, _, _ = net.infer_shape(data=(1,) + SHAPE)
    rng = np.random.default_rng(seed)
    params = {}
    for name, s in zip(net.list_arguments(), shapes):
        if name == "data":
            continue
        scale = np.sqrt(2.0 / np.prod(s[1:])) if len(s) > 1 else 0.1
        params[name] = (rng.standard_normal(s) * scale).astype(np.float32)
    return net, params


def _images(n, seed=5):
    return np.random.default_rng(seed).random((n,) + SHAPE,
                                              dtype=np.float32)


def _rel(got, want):
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _engine(net, params, contexts=None, **kw):
    return ServingEngine(net, params, {"data": SHAPE}, buckets=BUCKETS,
                         contexts=contexts, **kw)


@pytest.mark.gpu
def test_sharded_ssd_against_single_and_the_plain_nms(fp32_deterministic):
    _need_card()
    net, params = _checkpoint()
    single, sharded = _engine(net, params), _engine(net, params, 2)
    heads1 = _engine(net, params, output_names=HEADS)
    heads = _engine(net, params, 2, output_names=HEADS)
    assert sharded.device == torch.device("cuda", 0)
    assert sharded.model_devices == 2
    det_node = [n for n in _topo(net._out_nodes())
                if n.name == "detection"][0]
    attrs = contrib._mbd_attrs(det_node.attrs)
    for n in (1, 3, 4):
        x = {"data": _images(n, seed=n)}
        torch.cuda.synchronize()
        mnms.reset_launches()
        pm.reset_counters()
        det = sharded.infer(x)[0]
        torch.cuda.synchronize()
        assert mnms.LAUNCHES == mnms.LAUNCHES_BY_ROUTE["smem"] == 1
        assert pm.COUNTERS["all_gather"] > 0
        assert _rel(det, single.infer(x)[0]) <= TOL
        hs = heads.infer(x)
        for a, b in zip(hs, heads1.infer(x)):
            assert _rel(a, b) <= TOL
        cls_prob, loc, anc = (torch.from_numpy(h).cuda() for h in hs)
        with torch.inference_mode():
            plain = contrib.multibox_detection(
                cls_prob, loc, anc[:1], nms=mnms.nms_alive_reference,
                **attrs).cpu().numpy()
        np.testing.assert_array_equal(det, plain)
    assert sharded.weight_bytes(0) < sharded.weight_bytes() \
        == single.weight_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_sharded_quantized_equals_sharded_host_dequantized(
        mode, fp32_deterministic):
    _need_card()
    net, params = _checkpoint()
    eng = _engine(net, params, 2, quantize=mode)
    host = {k: tq.dequant_leaf(tq.quantize_array(v, mode)).numpy()
            for k, v in params.items()}
    ref = _engine(net, host, 2)
    for n in (1, 3, 4):
        x = {"data": _images(n, seed=n)}
        np.testing.assert_array_equal(eng.infer(x)[0], ref.infer(x)[0])
    for name, leaf in eng._state[0].items():
        if tq.is_quantized_leaf(leaf):
            assert [p.shape[0] for p in leaf["q"].parts] == \
                [p.shape[0] for p in leaf["s"].parts], name
            assert all(p.device.type == "cuda" for p in leaf["q"].parts)


# ---------------------------------------------------------------------------
# the decode loop
# ---------------------------------------------------------------------------

V, E, H, L, MAXLEN, SLOTS = 64, 32, 4, 2, 32, 4
SAMPLED = dict(temperature=0.8, top_k=10, top_p=0.9)


def _lm_params(layers=L, seed=3):
    rng = np.random.default_rng(seed)
    p = {"tok_embed_weight": rng.standard_normal((V, E)) * 0.3,
         "pos_embed_weight": rng.standard_normal((MAXLEN, E)) * 0.1,
         "final_ln_gamma": np.ones(E), "final_ln_beta": np.zeros(E),
         "lm_head_weight": rng.standard_normal((V, E)) * 0.3,
         "lm_head_bias": np.zeros(V)}
    for i in range(layers):
        pre = "layer%d" % i
        for ln in ("_ln1", "_ln2"):
            p[pre + ln + "_gamma"] = np.ones(E)
            p[pre + ln + "_beta"] = np.zeros(E)
        for name, rows, cols in (("_attn_qkv", 3 * E, E),
                                 ("_attn_out", E, E),
                                 ("_ffn_fc1", 4 * E, E),
                                 ("_ffn_fc2", E, 4 * E)):
            p[pre + name + "_weight"] = rng.standard_normal(
                (rows, cols)) * 0.2
            p[pre + name + "_bias"] = np.zeros(rows)
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [8, 9], [10, 11, 12], [13], [14, 15],
           [16, 17, 18], [19, 20]]


def _loop(contexts=None, **kw):
    kw.setdefault("prefix_cache", False)
    return DecodeLoop(_lm_params(), L, H, MAXLEN, slots=SLOTS,
                      contexts=contexts, **kw)


def _streams(loop, gen, prefix_len=0):
    futs = [loop.generate([1, 2] + p if prefix_len else p, 16, seed=9 + i,
                          prefix_len=prefix_len, **gen)
            for i, p in enumerate(PROMPTS)]
    return [f.result(timeout=300.0) for f in futs]


def _teacher_forced(loop, refs, gen):
    """The share of ``refs``' tokens the loop picks again with each
    reference stream fed to it as its prompt."""
    picks = {}
    step = loop._step_fn

    def recording(state, params, tokens, pos, *a):
        toks = step(state, params, tokens, pos, *a)
        p = (pos.parts[0] if hasattr(pos, "parts") else pos).cpu().numpy()
        t = toks.cpu().numpy()
        for i, slot in enumerate(loop._slots):
            if slot is not None:
                picks[slot.fut.rid, int(p[i])] = int(t[i])
        return toks
    loop._step_fn = recording
    futs = [loop.generate(p + r[:-1], 1, seed=9 + i, **gen)
            for i, (p, r) in enumerate(zip(PROMPTS, refs))]
    for f in futs:
        f.result(timeout=300.0)
    same = sum(picks.get((f.rid, len(p) - 1 + j)) == tok
               for f, p, r in zip(futs, PROMPTS, refs)
               for j, tok in enumerate(r))
    return same / sum(len(r) for r in refs)


@pytest.mark.gpu
def test_sharded_decode_legs_on_the_card():
    _need_card()
    for gen in ({}, SAMPLED):
        one = _loop()
        ref = _streams(one, gen)
        one.close()
        loop = _loop(2)
        try:
            got = _streams(loop, gen)
            assert _teacher_forced(loop, ref, gen) >= AGREE
            assert [tuple(p.shape) for p in loop._state["k"].parts] == \
                [(L, SLOTS, H // 2, MAXLEN + 1, E // H)] * 2
        finally:
            loop.close()
    spec = _loop(2, spec_k=2, draft_params=_lm_params(1, seed=8),
                 draft_num_layers=1)
    prefix = _loop(2, prefix_cache=True)
    cold = _loop(2)
    try:
        assert _streams(spec, SAMPLED) == got
        assert _streams(prefix, SAMPLED, 2) == _streams(cold, SAMPLED, 2)
        assert prefix.health.report()["prefix_hits"] >= 1
    finally:
        for lp in (spec, prefix, cold):
            lp.close()


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_mixed_fleet_across_a_drain_and_a_join(fp32_deterministic):
    _need_card()
    net, params = _checkpoint()
    single, sharded = _engine(net, params), _engine(net, params, 2)
    pool = _images(8, seed=11)
    refs = [set() for _ in pool]
    for eng in (single, sharded):
        for b in BUCKETS:
            for s in range(len(pool)):
                idx = (np.arange(b) + s) % len(pool)
                out = eng.infer({"data": pool[idx]})[0]
                for k, j in enumerate(idx):
                    refs[j].add(out[k].tobytes())
    router = FleetRouter({"r0": Batcher(single, max_latency_ms=1.0),
                          "r1": Batcher(sharded, max_latency_ms=1.0)})
    try:
        answers = []
        for i in range(30):
            if i == 10:
                router.drain("r1", timeout=60.0)
            if i == 20:
                router.join("r2", lambda: Batcher(
                    _engine(net, params, [mt.gpu(0)] * 2),
                    max_latency_ms=1.0))
            s, n = i % 5, 1 + i % 3
            answers.append((s, router.infer({"data": pool[s:s + n]})[0]))
        rep = router.report()
    finally:
        router.close()
    for s, a in answers:
        for k, row in enumerate(a):
            assert row.tobytes() in refs[s + k]
    assert {n: r["model_devices"] for n, r in rep["replicas"].items()} == \
        {"r0": 1, "r1": 2, "r2": 2}
    assert rep["fleet"]["shed"] == rep["fleet"]["errors"] == 0
