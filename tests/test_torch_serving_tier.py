"""The rest of the port's ``ServingEngine`` against the JAX package's.

One JAX-written checkpoint of each small model (the serving tests' MLP,
LeNet, and an MLP with a BatchNorm for the aux states; weights from numpy
seeds) is loaded by both packages' engines:

- quantized engines (``bf16``, ``int8``): outputs within ``ATOL`` of the
  JAX engine of the same mode (the f32 views of the weights are equal bit
  for bit; convolutions and matmuls sum in another order), ``weight_bytes``
  equal exactly, and ``quality_report`` with the same top-1 agreement;
- ``update_params``: after a reload the engine equals, bit for bit, a
  fresh engine built from the new weights (also for an f32 checkpoint
  into a bf16 engine, and into an int8 engine, which re-quantizes on the
  host), and the JAX engine after its own reload within ``ATOL``; missing
  keys, wrong shapes, missing aux states and integer arrays raise naming
  them; a reload is counted in the obs registry;
- the tuning DB's serving entry sets the buckets and the Batcher's
  latency in both packages alike, below ``buckets=`` and
  ``MXTPU_SERVE_BUCKETS``; a corrupt entry falls back, and an entry of
  another device kind is a noted mismatch;
- the load-time warm-up runs every bucket once and counts nothing;
- ``executables=`` warns naming the file and serves; ``export_compiled``
  raises;
- the served ``(params, aux)`` pair swaps atomically under a request in
  flight.
"""
import json
import logging
import threading

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, autotune, serving
from mxnet_tpu_torch.obs import REGISTRY
from mxnet_tpu_torch.serving import engine as engine_mod

ATOL = 1e-5


def _mlp(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                                 name="fc1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _bn_mlp(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                                 name="fc1")
    net = pkg.sym.BatchNorm(net, name="bn1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


MODELS = {
    "mlp": (_mlp, (6,)),
    "bn_mlp": (_bn_mlp, (6,)),
    "lenet": (lambda pkg: pkg.models.lenet(num_classes=10), (1, 28, 28)),
}


def _weights(model, seed):
    """(arg, aux) numpy dicts of ``model`` from ``seed``."""
    build, shape = MODELS[model]
    net = build(mx)
    arg_shapes, _, aux_shapes = net.infer_shape(data=(1,) + shape)
    rng = np.random.default_rng(seed)
    arg = {}
    for name, s in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        scale = np.sqrt(2.0 / np.prod(s[1:])) if len(s) > 1 else 0.1
        arg[name] = (rng.standard_normal(s) * scale).astype(np.float32)
    aux = {name: (rng.uniform(0.5, 1.5, s) if name.endswith("_var")
                  else 0.1 * rng.standard_normal(s)).astype(np.float32)
           for name, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return arg, aux


def _checkpoint(tmp_path, model, seed=0, epoch=0):
    build, _ = MODELS[model]
    arg, aux = _weights(model, seed)
    tmp_path.mkdir(exist_ok=True)
    prefix = str(tmp_path / model)
    mx.model.save_checkpoint(prefix, epoch, build(mx),
                             {k: mx.nd.array(v) for k, v in arg.items()},
                             {k: mx.nd.array(v) for k, v in aux.items()})
    return (prefix + "-symbol.json",
            "%s-%04d.params" % (prefix, epoch)), arg, aux


def _engines(files, model, buckets=(1, 4), **kw):
    shape = MODELS[model][1]
    return (jserving.ServingEngine(*files, {"data": shape}, buckets=buckets,
                                   **kw),
            serving.ServingEngine(*files, {"data": shape}, buckets=buckets,
                                  device="cpu", **kw))


def _images(model, n, seed=7):
    shape = MODELS[model][1]
    return np.random.default_rng(seed).random((n,) + shape,
                                              dtype=np.float32)


# ---------------------------------------------------------------------------
# quantized engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantized_engine_matches_jax(tmp_path, model, mode):
    files, _, _ = _checkpoint(tmp_path, model)
    jeng, teng = _engines(files, model, quantize=mode)
    assert teng.quant_mode == jeng.quant_mode == mode
    assert teng.weight_bytes() == jeng.weight_bytes()
    x = {"data": _images(model, 5)}
    got, want = teng.infer(x)[0], jeng.infer(x)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    jref, tref = _engines(files, model)
    jr = jeng.quality_report(jref, x)
    tr = teng.quality_report(tref, x)
    assert tr["top1_agreement"] == jr["top1_agreement"]
    assert tr["probe_rows"] == jr["probe_rows"] == 5
    assert abs(tr["max_abs_err"] - jr["max_abs_err"]) <= 2 * ATOL


def test_quantize_env_knob(tmp_path, monkeypatch):
    files, _, _ = _checkpoint(tmp_path, "mlp")
    monkeypatch.setenv("MXTPU_SERVE_QUANT", "bf16")
    _, teng = _engines(files, "mlp")
    assert teng.quant_mode == "bf16"
    monkeypatch.setenv("MXTPU_SERVE_QUANT", "fp4")
    with pytest.raises(MXNetError, match="quantize mode"):
        serving.ServingEngine(*files, {"data": (6,)}, device="cpu")


# ---------------------------------------------------------------------------
# update_params (hot reload)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["mlp", "bn_mlp", "lenet"])
@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_update_params_equals_fresh_engine(tmp_path, model, mode):
    files, _, _ = _checkpoint(tmp_path, model, seed=0)
    new_files, arg, aux = _checkpoint(tmp_path / "new", model, seed=1,
                                      epoch=3)
    jeng, teng = _engines(files, model, quantize=mode)
    before = REGISTRY.snapshot().get("serving.param_reloads", 0)
    teng.update_params(new_files[1])             # a param file
    jeng.update_params(new_files[1])
    assert REGISTRY.snapshot()["serving.param_reloads"] == before + 1
    _, fresh = _engines(new_files, model, quantize=mode)
    x = {"data": _images(model, 3)}
    got = teng.infer(x)[0]
    np.testing.assert_array_equal(got, fresh.infer(x)[0])
    np.testing.assert_allclose(got, jeng.infer(x)[0], rtol=0, atol=ATOL)
    # a dict and an (arg, aux) pair reload the same way
    teng.update_params((arg, aux))
    np.testing.assert_array_equal(teng.infer(x)[0], got)
    if not aux:
        teng.update_params(arg)
        np.testing.assert_array_equal(teng.infer(x)[0], got)


def test_update_params_errors_name_what_is_wrong(tmp_path):
    files, arg, aux = _checkpoint(tmp_path, "bn_mlp")
    _, eng = _engines(files, "bn_mlp")
    x = {"data": _images("bn_mlp", 2)}
    want = eng.infer(x)[0]
    partial = {k: v for k, v in arg.items() if k != "fc2_bias"}
    with pytest.raises(MXNetError, match="fc2_bias"):
        eng.update_params(partial, aux)
    with pytest.raises(MXNetError, match="aux states"):
        eng.update_params(arg)
    with pytest.raises(MXNetError, match="bn1_moving_var"):
        eng.update_params(arg, {"bn1_moving_mean": aux["bn1_moving_mean"]})
    bad = dict(arg, fc1_weight=np.zeros((8, 7), np.float32))
    with pytest.raises(MXNetError, match="fc1_weight.*shape"):
        eng.update_params(bad, aux)
    ints = dict(arg, fc2_bias=np.zeros(4, np.int32))
    with pytest.raises(MXNetError, match="fc2_bias.*dtype"):
        eng.update_params(ints, aux)
    # a refused reload leaves the engine serving what it served
    np.testing.assert_array_equal(eng.infer(x)[0], want)


def test_update_params_swap_is_atomic_under_a_request(tmp_path,
                                                      monkeypatch):
    """A request that has started reading the served weights when a
    reload swaps them in serves the old pair entirely, never old
    parameters with new aux states. The request is held at the copy of
    its input (after the engine read its weights) while the reload runs;
    reading ``params`` and ``aux`` separately would mix them there."""
    files, _, _ = _checkpoint(tmp_path, "bn_mlp", seed=0)
    new_files, arg, aux = _checkpoint(tmp_path / "new", "bn_mlp", seed=1,
                                      epoch=3)
    _, eng = _engines(files, "bn_mlp")
    _, fresh_new = _engines(new_files, "bn_mlp")
    x = {"data": _images("bn_mlp", 2)}
    old = eng.infer(x)[0]
    new = fresh_new.infer(x)[0]
    assert not np.array_equal(old, new)
    reading, proceed = threading.Event(), threading.Event()
    real = np.ascontiguousarray
    request = {}

    def gated(a, *args, **kw):
        if threading.current_thread() is request.get("thread"):
            reading.set()
            proceed.wait(10.0)
        return real(a, *args, **kw)

    monkeypatch.setattr(engine_mod.np, "ascontiguousarray", gated)

    def serve():
        request["out"] = eng.infer(x)[0]

    t = threading.Thread(target=serve)
    request["thread"] = t
    t.start()
    assert reading.wait(10.0)
    eng.update_params(arg, aux)
    proceed.set()
    t.join(10.0)
    assert not t.is_alive()
    np.testing.assert_array_equal(request["out"], old)
    np.testing.assert_array_equal(eng.infer(x)[0], new)


# ---------------------------------------------------------------------------
# the tuning DB's serving tier
# ---------------------------------------------------------------------------

def _serve_entry(path, sym, knobs, device_kind="cpu"):
    from mxnet_tpu.predictor import _strip_loss_heads
    from mxnet_tpu.autotune import symbol_signature
    sig = symbol_signature(_strip_loss_heads(sym))
    key = "mlp|%s|b0|serve_p99" % device_kind
    entry = {"model": "mlp", "objective": "serve_p99", "kind": "serve",
             "global_batch": 0, "device_kind": device_kind,
             "platform": "cpu" if device_kind == "cpu" else "gpu",
             "symbol": sym.name, "symbol_sig": sig, "knobs": dict(knobs),
             "score": -5.0, "unit": "ms_p99_neg"}
    with open(path, "w") as f:
        json.dump({"schema": autotune.SCHEMA_VERSION,
                   "entries": {key: entry}}, f)


def test_db_sets_buckets_and_batcher_latency_like_jax(tmp_path,
                                                      monkeypatch):
    files, _, _ = _checkpoint(tmp_path, "mlp")
    path = str(tmp_path / "tune_db.json")
    monkeypatch.setenv("MXTPU_AUTOTUNE_DB", path)
    _serve_entry(path, _mlp(mx), {"buckets": "1,4", "max_latency_ms": 2.0})
    before = REGISTRY.snapshot().get("autotune.db_resolutions", 0)
    jeng, teng = _engines(files, "mlp", buckets=None)
    assert teng.buckets == jeng.buckets == (1, 4)
    assert teng._autotuned == jeng._autotuned
    assert REGISTRY.snapshot()["autotune.db_resolutions"] == before + 1
    b = serving.Batcher(teng, start=False)
    assert abs(b.max_latency - jserving.Batcher(jeng, start=False)
               .max_latency) < 1e-15
    assert abs(b.max_latency - 0.002) < 1e-12
    # env beats the DB
    monkeypatch.setenv("MXTPU_SERVE_BUCKETS", "1,2")
    jeng, teng = _engines(files, "mlp", buckets=None)
    assert teng.buckets == jeng.buckets == (1, 2)
    assert teng._autotuned is None
    monkeypatch.delenv("MXTPU_SERVE_BUCKETS")
    # explicit ctor arg beats everything
    _, teng = _engines(files, "mlp", buckets=(1, 3))
    assert teng.buckets == (1, 3) and teng._autotuned is None
    # MXTPU_AUTOTUNE=0 disarms the DB
    monkeypatch.setenv("MXTPU_AUTOTUNE", "0")
    _, teng = _engines(files, "mlp", buckets=None)
    assert teng.buckets == (1, 8, 32)


def test_db_corrupt_spec_and_foreign_device_fall_back(tmp_path, monkeypatch,
                                                      caplog):
    files, _, _ = _checkpoint(tmp_path, "mlp")
    path = str(tmp_path / "tune_db.json")
    monkeypatch.setenv("MXTPU_AUTOTUNE_DB", path)
    _serve_entry(path, _mlp(mx), {"buckets": "0,garbage",
                                  "max_latency_ms": "wat"})
    with caplog.at_level(logging.WARNING):
        jeng, teng = _engines(files, "mlp", buckets=None)
    assert teng.buckets == jeng.buckets == (1, 8, 32)
    assert teng._autotuned is None
    assert "unusable" in caplog.text
    # an entry tuned on a card does not apply to a CPU engine: a note
    _serve_entry(path, _mlp(mx), {"buckets": "1,4"},
                 device_kind="NVIDIA H100 80GB HBM3")
    before = REGISTRY.snapshot().get("autotune.db_mismatches", 0)
    with caplog.at_level(logging.INFO):
        _, teng = _engines(files, "mlp", buckets=None)
    assert teng.buckets == (1, 8, 32)
    assert REGISTRY.snapshot()["autotune.db_mismatches"] == before + 1
    assert "NVIDIA H100 80GB HBM3" in caplog.text


# ---------------------------------------------------------------------------
# warm-up, executables=, export_compiled
# ---------------------------------------------------------------------------

def test_warmup_runs_every_bucket_and_counts_nothing(tmp_path, monkeypatch):
    files, _, _ = _checkpoint(tmp_path, "lenet")
    runs = []
    real = engine_mod._build_graph_runner

    def counting(symbol):
        run, nodes = real(symbol)

        def counted(args, aux, *a, **kw):
            runs.append(int(args["data"].shape[0]))
            return run(args, aux, *a, **kw)
        return counted, nodes

    monkeypatch.setattr(engine_mod, "_build_graph_runner", counting)
    eng = serving.ServingEngine(*files, {"data": (1, 28, 28)},
                                buckets=(1, 4, 8), device="cpu")
    assert runs == [1, 4, 8]
    rep = eng.health.report()
    assert rep["batches"] == rep["examples"] == rep["padded"] == 0
    eng.infer({"data": _images("lenet", 3)})
    assert runs == [1, 4, 8, 4]
    assert eng.health.batches == 1 and eng.health.padded == 1


def test_executables_warns_and_serves_export_raises(tmp_path, caplog):
    files, _, _ = _checkpoint(tmp_path, "mlp")
    _, ref = _engines(files, "mlp")
    exe = str(tmp_path / "exe.bin")
    with pytest.raises(MXNetError, match="cannot serialize"):
        ref.export_compiled(exe)
    with caplog.at_level(logging.WARNING):
        jeng, teng = _engines(files, "mlp", executables=exe)
    assert "exe.bin" in caplog.text and "warming up afresh" in caplog.text
    x = {"data": _images("mlp", 3)}
    np.testing.assert_array_equal(teng.infer(x)[0], ref.infer(x)[0])
    np.testing.assert_allclose(teng.infer(x)[0], jeng.infer(x)[0], rtol=0,
                               atol=ATOL)


def test_contexts_still_raises(tmp_path):
    """``contexts=2`` no longer raises: it serves the checkpoint over two
    positions within rtol 1e-6 of one device (the per-position products
    of half the output width), and ``contexts=1`` builds no mesh."""
    files, _, _ = _checkpoint(tmp_path, "mlp")
    x = {"data": _images("mlp", 3)}
    sharded = serving.ServingEngine(*files, {"data": (6,)}, contexts=2,
                                    buckets=(4,), device="cpu")
    assert sharded.model_devices == 2
    one = serving.ServingEngine(*files, {"data": (6,)}, buckets=(4,),
                                device="cpu")
    np.testing.assert_allclose(sharded.infer(x)[0], one.infer(x)[0],
                               rtol=1e-6, atol=0)
    eng = serving.ServingEngine(*files, {"data": (6,)}, contexts=1,
                                buckets=(1,), device="cpu")
    assert eng.model_devices == 1
    assert isinstance(mt.serving.FLEET_CLASSES, tuple)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantized_narrow_ssd_matches_jax_and_host_dequant(tmp_path, mode):
    """The narrow SSD (``ssd.get_symbol(num_classes=3, width=8)``, 64x64)
    quantized: its heads within ``ATOL`` of the JAX engine of the same
    mode, its detections (B2's plain version on the CPU) equal, bit for
    bit, an f32 engine loaded with the weights dequantized on the host."""
    from mxnet_tpu.models import ssd as jssd
    from mxnet_tpu_torch.serving import quantize as tq
    net = jssd.get_symbol(num_classes=3, width=8)
    shape = (3, 64, 64)
    shapes, _, _ = net.infer_shape(data=(1,) + shape)
    rng = np.random.default_rng(4)
    params = {}
    for name, s in zip(net.list_arguments(), shapes):
        if name == "data":
            continue
        scale = np.sqrt(2.0 / np.prod(s[1:])) if len(s) > 1 else 0.1
        params[name] = (rng.standard_normal(s) * scale).astype(np.float32)
    prefix = str(tmp_path / "ssd")
    mx.model.save_checkpoint(prefix, 0, net,
                             {k: mx.nd.array(v) for k, v in params.items()},
                             {})
    files = (prefix + "-symbol.json", prefix + "-0000.params")
    heads = ["cls_prob", "multibox_loc_pred", "multibox_anchors"]
    x = {"data": rng.random((3,) + shape, dtype=np.float32)}
    jeng = jserving.ServingEngine(*files, {"data": shape}, buckets=(1, 4),
                                  quantize=mode, output_names=heads)
    teng = serving.ServingEngine(*files, {"data": shape}, buckets=(1, 4),
                                 quantize=mode, output_names=heads,
                                 device="cpu")
    for j, t in zip(jeng.infer(x), teng.infer(x)):
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    det = serving.ServingEngine(*files, {"data": shape}, buckets=(1, 4),
                                quantize=mode, device="cpu")
    host = {k: tq.dequant_leaf(tq.quantize_array(v, mode)).numpy()
            for k, v in params.items()}
    ref = serving.ServingEngine(files[0], host, {"data": shape},
                                buckets=(1, 4), device="cpu")
    np.testing.assert_array_equal(det.infer(x)[0], ref.infer(x)[0])
    assert det.weight_bytes() <= (0.51 if mode == "bf16" else 0.30) * \
        ref.weight_bytes()
