"""The port's transformer LM (``models.transformer``, per layer and
stacked) trained through ``Module.fit``, against the JAX package's, on the
CPU, with the tokens/sec reporting and the tuning-DB entry of an LM fit.

Sizes: 2 layers, embed 32, 4 heads, vocabulary 64, sequence 16, batch 8.
The same numpy weights and batches (from a seed) go through both
packages. Tolerances:
- symbol JSON, parameter names and shapes, validation errors: exact;
- forward and gradients through ``simple_bind``: ``rtol=1e-5`` with
  ``atol`` 1e-5 of the array's largest magnitude (float32; the backends
  sum an einsum's products in other orders, and a weight's gradient sums
  batch x seq of them);
- ``stack_layers=True`` against the per-layer build from the same weights
  stacked: the same tolerance (one layer loop against one op per layer);
- ``Module.fit`` with SGD and momentum: parameters within ``rtol=1e-4``
  of the JAX package's (with ``atol`` 1e-4 of the largest magnitude),
  perplexity within ``rtol=1e-4``.
"""
import logging
import os
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.base import MXNetError as JMXNetError
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.transformer_stack import STACK_INPUTS
from mxnet_tpu_torch.train_step import TrainStep

V, E, H, L, S, B = 64, 32, 4, 2, 16, 8
RTOL = 1e-5
FIT_RTOL = 1e-4
#: the per-layer parameter of each stacked input of TransformerStack
_PER_LAYER = {"ln1_gamma": "ln1_gamma", "ln1_beta": "ln1_beta",
              "qkv_weight": "attn_qkv_weight", "qkv_bias": "attn_qkv_bias",
              "out_weight": "attn_out_weight", "out_bias": "attn_out_bias",
              "ln2_gamma": "ln2_gamma", "ln2_beta": "ln2_beta",
              "fc1_weight": "ffn_fc1_weight", "fc1_bias": "ffn_fc1_bias",
              "fc2_weight": "ffn_fc2_weight", "fc2_bias": "ffn_fc2_bias"}


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _close(got, want, rtol=RTOL, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _sym(pkg, **kw):
    cfg = dict(vocab_size=V, embed=E, num_heads=H, num_layers=L, seq_len=S)
    cfg.update(kw)
    with pkg.symbol.NameManager():
        return pkg.models.transformer(**cfg)


def _weights(name, **kw):
    """Random float32 weights for every parameter of the LM (gains near 1,
    shifts and biases near 0)."""
    sym = _sym(mt, **kw)
    shapes, _, _ = sym.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = _rng(name)
    out = {}
    for n, shp in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("gamma"):
            w = 1.0 + 0.1 * rng.standard_normal(shp)
        elif n.endswith(("beta", "bias")):
            w = 0.1 * rng.standard_normal(shp)
        else:
            w = 0.3 * rng.standard_normal(shp)
        out[n] = w.astype(np.float32)
    return out


def _stacked(w, layers=L):
    """The per-layer weights stacked into TransformerStack's inputs."""
    out = {k: v for k, v in w.items() if not k.startswith("layer")}
    for name in STACK_INPUTS[1:]:
        out["stack_" + name] = np.stack(
            [w["layer%d_%s" % (i, _PER_LAYER[name])] for i in range(layers)])
    return out


def _tokens(name, n=B):
    rng = _rng(name)
    x = rng.integers(0, V, (n, S)).astype(np.float32)
    return x, ((x + 1) % V).astype(np.float32)


def _run(pkg, sym, w, x, y, grads=True):
    """Forward (and backward, head gradient of ones) through simple_bind;
    returns (output, {param: gradient})."""
    ctx = pkg.cpu()
    ex = sym.simple_bind(ctx, grad_req="write" if grads else "null",
                         data=x.shape, softmax_label=y.shape)
    ex.copy_params_from({k: pkg.nd.array(v, ctx=ctx) for k, v in w.items()})
    ex.forward(is_train=grads, data=pkg.nd.array(x, ctx=ctx),
               softmax_label=pkg.nd.array(y, ctx=ctx))
    out = ex.outputs[0].asnumpy()
    if not grads:
        return out, {}
    ex.backward()
    return out, {k: ex.grad_dict[k].asnumpy() for k in w}


# ---------------------------------------------------------------------------
# the symbol
# ---------------------------------------------------------------------------

VARIANTS = {
    "default": {},
    "stacked": dict(stack_layers=True),
    "rank3_maxlen": dict(preserve_shape=True, max_seq_len=32),
    "dropout": dict(dropout=0.1),
    "blocked": dict(block_size=4, ffn_hidden=48),
    "ring": dict(seq_parallel="ring"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_symbol_json_round_trips_across_packages(variant):
    kw = VARIANTS[variant]
    tjs, jjs = _sym(mt, **kw).tojson(), _sym(mx, **kw).tojson()
    assert tjs == jjs
    assert mt.sym.load_json(jjs).tojson() == jjs
    assert mx.sym.load_json(tjs).tojson() == tjs
    assert mt.models.get_symbol("transformer", vocab_size=V, embed=E,
                                num_heads=H, num_layers=L, seq_len=S,
                                **kw).list_arguments() == \
        mt.sym.load_json(jjs).list_arguments()


@pytest.mark.parametrize("head", ["flat", "rank3"])
def test_forward_and_gradients_match_jax(head):
    kw = dict(preserve_shape=True) if head == "rank3" else {}
    w = _weights("fwd-" + head, **kw)
    x, y = _tokens("fwd-" + head)
    jout, jgrad = _run(mx, _sym(mx, **kw), w, x, y)
    tout, tgrad = _run(mt, _sym(mt, **kw), w, x, y)
    assert tout.shape == jout.shape == ((B, S, V) if kw else (B * S, V))
    _close(tout, jout)
    for k in w:
        _close(tgrad[k], jgrad[k], err_msg=k)


def test_stacked_build_matches_per_layer_and_jax():
    """``stack_layers=True`` over the per-layer weights stacked gives the
    per-layer build's output and gradients (the layer loop against one op
    a layer), and the JAX package's stacked build's."""
    w = _weights("stack")
    ws = _stacked(w)
    x, y = _tokens("stack")
    per_out, per_grad = _run(mt, _sym(mt), w, x, y)
    st_out, st_grad = _run(mt, _sym(mt, stack_layers=True), ws, x, y)
    j_out, j_grad = _run(mx, _sym(mx, stack_layers=True), ws, x, y)
    _close(st_out, per_out)
    _close(st_out, j_out)
    for k, g in _stacked(per_grad).items():
        _close(st_grad[k], g, err_msg=k)
        _close(st_grad[k], j_grad[k], err_msg=k)


def test_max_seq_len_gives_the_table_its_rows():
    sym = _sym(mt, max_seq_len=40)
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(2, S), softmax_label=(2, S))[0]))
    assert shapes["pos_embed_weight"] == (40, E)
    # rows past seq_len never reach the output
    w = _weights("maxlen", max_seq_len=40)
    x, y = _tokens("maxlen", n=2)
    out, _ = _run(mt, sym, w, x, y, grads=False)
    w2 = dict(w, pos_embed_weight=w["pos_embed_weight"].copy())
    w2["pos_embed_weight"][S:] = 7.0
    out2, _ = _run(mt, sym, w2, x, y, grads=False)
    np.testing.assert_array_equal(out, out2)
    jout, _ = _run(mx, _sym(mx, max_seq_len=40), w, x, y, grads=False)
    _close(out, jout)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=1), dict(seq_len=0), dict(num_layers=0),
    dict(embed=30), dict(ffn_hidden=-1), dict(max_seq_len=8),
    dict(block_size=-1), dict(block_size=32), dict(block_size=5),
    dict(dropout=1.0), dict(stack_layers=True, seq_parallel="ring"),
    dict(stack_layers=True, dropout=0.1)],
    ids=lambda kw: ",".join("%s=%s" % i for i in sorted(kw.items())))
def test_validate_errors_match_jax(kw):
    with pytest.raises(JMXNetError) as jerr:
        _sym(mx, **kw)
    with pytest.raises(MXNetError) as terr:
        _sym(mt, **kw)
    assert str(terr.value) == str(jerr.value)


def test_pipe_mesh_raises():
    """The stacked build trains over a 'pipe' mesh: ``Module(mesh_axes=
    "pipe=2")`` over two CPU positions runs the GPipe schedule (each
    stage's stacked weights sharded along 'pipe' by ``param_shardings``)
    and its parameters equal the one-device fit's (``rtol=1e-4``); an
    indivisible layer count still raises naming the axis."""
    from mxnet_tpu_torch.parallel.mesh import P
    rng = np.random.RandomState(5)
    x = rng.randint(0, V, (2 * B, S)).astype(np.float32)
    y = rng.randint(0, V, (2 * B, S)).astype(np.float32)

    def fit(**kw):
        sym = _sym(mt, stack_layers=True, num_microbatches=2)
        mod = mt.mod.Module(sym, **kw)
        mt.random.seed(11)
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=B,
                                  label_name="softmax_label"),
                num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05},
                initializer=mt.initializer.Xavier(),
                eval_metric=mt.metric.Perplexity(None))
        return mod
    ref = fit(context=mt.cpu())
    stacked = [n for n in ref.get_params()[0] if n.startswith("stack_")]
    mod = fit(context=[mt.cpu(0), mt.cpu(1)], mesh_axes="pipe=2",
              param_shardings={n: P("pipe") for n in stacked})
    assert dict(mod._fused.mesh.shape) == {"pipe": 2}
    assert mod._fused_state["params"][stacked[0]].shape[0] == L // 2
    want = ref.get_params()[0]
    for n, v in mod.get_params()[0].items():
        np.testing.assert_allclose(v.asnumpy(), want[n].asnumpy(),
                                   rtol=FIT_RTOL, atol=1e-6, err_msg=n)
    bad = mt.mod.Module(_sym(mt, stack_layers=True, num_layers=3),
                        context=[mt.cpu(0), mt.cpu(1)], mesh_axes="pipe=2")
    with pytest.raises(MXNetError, match="num_layers"):
        bad.fit(mt.io.NDArrayIter(x, y, batch_size=B,
                                  label_name="softmax_label"),
                num_epoch=1, initializer=mt.initializer.Xavier(),
                eval_metric=mt.metric.Perplexity(None))


@pytest.mark.parametrize("stacked", [False, True], ids=["layers", "stack"])
def test_convert_carries_the_lm_parameters(stacked):
    """``convert.from_reference_params`` carries the LM's flat parameter
    dict across: a JAX module's parameters load into the port's executor
    and give the JAX forward."""
    kw = dict(stack_layers=True) if stacked else {}
    w = _weights("convert")
    if stacked:
        w = _stacked(w)
    x, y = _tokens("convert")
    jmod = mx.mod.Module(_sym(mx, **kw), context=mx.cpu())
    jmod.bind(data_shapes=[("data", x.shape)],
              label_shapes=[("softmax_label", y.shape)])
    jmod.init_params(arg_params={k: mx.nd.array(v) for k, v in w.items()})
    jargs, jaux = jmod.get_params()
    targs, taux = convert.from_reference_params(
        {k: v.asnumpy() for k, v in jargs.items()},
        {k: v.asnumpy() for k, v in jaux.items()})
    assert set(targs) == set(w) and not taux
    ex = _sym(mt, **kw).simple_bind(mt.cpu(), grad_req="null",
                                    data=x.shape, softmax_label=y.shape)
    ex.copy_params_from({k: mt.nd.NDArray(v) for k, v in targs.items()})
    ex.forward(data=mt.nd.array(x, ctx=mt.cpu()))
    jmod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]),
                 is_train=False)
    _close(ex.outputs[0].asnumpy(), jmod.get_outputs()[0].asnumpy())


# ---------------------------------------------------------------------------
# training through Module.fit
# ---------------------------------------------------------------------------

def _fit(pkg, k, w, speedo=None, **fit_kw):
    x, y = _tokens("fit", n=4 * B)
    it = pkg.io.NDArrayIter(x, y, batch_size=B, label_name="softmax_label")
    mod = pkg.mod.Module(_sym(pkg), context=pkg.cpu())
    metric = pkg.metric.Perplexity(ignore_label=None)
    ppl = []
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params={n: pkg.nd.array(v, ctx=pkg.cpu())
                        for n, v in w.items()},
            eval_metric=metric, batch_end_callback=speedo,
            epoch_end_callback=lambda *a: ppl.append(metric.get()[1]),
            **fit_kw)
    args, _ = mod.get_params()
    return mod, {n: v.asnumpy() for n, v in args.items()}, ppl


@pytest.mark.parametrize("k", [1, 2])
def test_fit_matches_jax(k):
    """Two epochs of 4 batches of SGD with momentum and weight decay."""
    w = _weights("fit")
    _, jp, jppl = _fit(mx, k, w, steps_per_dispatch=k)
    tmod, tp, tppl = _fit(mt, k, w, steps_per_dispatch=k)
    assert tmod._fused is not None      # the fused TrainStep path
    assert tppl[1] < tppl[0]
    np.testing.assert_allclose(tppl, jppl, rtol=FIT_RTOL)
    for n in jp:
        _close(tp[n], jp[n], rtol=FIT_RTOL, err_msg=n)


def test_bf16_compute_keeps_token_ids_exact():
    """Under ``compute_dtype="bfloat16"`` the LM's token ids reach
    ``tok_embed`` unrounded at a vocabulary above 256: ids 257 and 256
    (one bf16 value) look up different rows."""
    vocab = 300
    sym = _sym(mt, vocab_size=vocab)
    ts = TrainStep(sym, compute_dtype="bfloat16", learning_rate=0.0,
                   device="cpu")
    assert "data" in ts._keep_dtype
    st = ts.init({"data": (1, S)}, {"softmax_label": (1, S)})
    outs = {}
    for tok in (256.0, 257.0):
        x = np.full((1, S), tok, np.float32)
        _, o = ts.step(st, {"data": x, "softmax_label": np.zeros((1, S),
                                                                np.float32)})
        outs[tok] = o[0].float().numpy()
    assert not np.array_equal(outs[256.0], outs[257.0])


def _speedo_lines(caplog):
    return [r.getMessage() for r in caplog.records
            if "samples/sec" in r.getMessage()]


def test_speedometer_tokens_per_sec_suffix(caplog):
    """An LM fit's Speedometer lines carry tokens/sec (samples/sec times
    the sequence length); a vision fit's, through the same reused
    Speedometer, do not."""
    speedo = mt.callback.Speedometer(batch_size=B, frequent=2)
    with caplog.at_level(logging.INFO):
        _fit(mt, 1, _weights("fit"), speedo=speedo, steps_per_dispatch=1)
    lm_lines = _speedo_lines(caplog)
    assert lm_lines and all("tokens/sec" in s for s in lm_lines)
    for s in lm_lines:
        sps = float(s.split("Speed: ")[1].split(" samples/sec")[0])
        tps = float(s.split("(")[1].split(" tokens/sec")[0])
        assert abs(tps - sps * S) <= 0.05 * S + 0.01 * tps
    caplog.clear()
    rng = _rng("vision")
    x = rng.standard_normal((4 * B, 6)).astype(np.float32)
    y = rng.integers(0, 3, 4 * B).astype(np.float32)
    mod = mt.mod.Module(mt.models.mlp(num_classes=3, hidden=(8,)),
                        context=mt.cpu())
    with caplog.at_level(logging.INFO):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=B), num_epoch=2,
                batch_end_callback=speedo)
    vision = _speedo_lines(caplog)
    assert vision and not any("tokens/sec" in s for s in vision)


def test_module_speed_tokens_per_sample_reads_label_shape():
    mod = mt.mod.Module(_sym(mt), context=mt.cpu())
    assert mod._speed_tokens_per_sample() == 1          # not bound yet
    mod.bind(data_shapes=[("data", (B, S))],
             label_shapes=[("softmax_label", (B, S))])
    assert mod._speed_tokens_per_sample() == S
    mlp = mt.mod.Module(mt.models.mlp(num_classes=3, hidden=(8,)),
                        context=mt.cpu())
    mlp.bind(data_shapes=[("data", (B, 6))],
             label_shapes=[("softmax_label", (B,))])
    assert mlp._speed_tokens_per_sample() == 1


def test_fit_resolves_tokens_per_sec_db_entry(tmp_path, monkeypatch):
    """A fit that names no dispatch knob takes K from a
    ``transformer|cpu|b8|tokens_per_sec`` entry, as the JAX package's
    does; the same entry seen from a card is a device mismatch note,
    never a hit."""
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.autotune import db as adb
    from mxnet_tpu_torch.obs import REGISTRY
    sym = _sym(mt)
    path = os.path.join(str(tmp_path), "tuned.json")
    tdb = adb.TuningDB(path)
    key = tdb.put("transformer", "tokens_per_sec", B,
                  {"steps_per_dispatch": 2, "dispatch_pipeline": 1},
                  score=12345.0, unit="tokens/sec", kind="train",
                  symbol=sym.name, symbol_sig=adb.symbol_signature(sym),
                  device="cpu")
    assert key == "transformer|cpu|b%d|tokens_per_sec" % B
    tdb.save()
    monkeypatch.setenv("MXTPU_AUTOTUNE_DB", path)
    hits = REGISTRY.counter("autotune.db_resolutions")
    before = hits.value
    calls = []
    real = TrainStep.run_steps

    def spy(self, state, batches, *a, **kw):
        calls.append(next(iter(batches.values())).shape[0])
        return real(self, state, batches, *a, **kw)

    monkeypatch.setattr(TrainStep, "run_steps", spy)
    _fit(mt, None, _weights("fit"))
    assert hits.value == before + 1
    assert calls and set(calls) == {2}
    monkeypatch.setattr(adb, "device_kind",
                        lambda device: "NVIDIA H100 80GB HBM3")
    misses = REGISTRY.counter("autotune.db_mismatches")
    before = misses.value
    assert autotune.resolve_train_knobs(sym, B, device="cpu") == (None,
                                                                  None)
    assert misses.value == before + 1
