"""The transformer LM on the card, in small form: training through
``Module(compute_dtype="bfloat16").fit`` at ``steps_per_dispatch`` 4
against 1, the stacked build against the per-layer one, and
``DecodeLoop``'s legs (``chip_smoke.py`` phase 17 runs the same checks at
bench.py lm_main's widths).

Checks:
- fit over the next-token task: perplexity falls, and K=4 ends on the
  parameters of K=1 bit for bit, or else within 1e-3 of each parameter's
  norm (the same step code; only a backward whose sums are not bitwise
  repeatable could part them);
- ``stack_layers=True`` over the per-layer weights stacked, float32 with
  TF32 off: within 1e-5 of the output's largest value;
- greedy decoding: every token the argmax of the full forward at its
  position (teacher-forced on the stream), except where the forward's two
  probabilities are within 1e-5 (a rounding tie); speculative decoding
  (spec_k 2, a one-layer draft) token-identical to target-only sampling;
  a prefix hit identical to a cold start; ``update_params`` bitwise;
  ``serve.sample`` sheds every sequence with ``ServingClosedError``;
- bf16 and int8 weights: teacher-forced on the float32 loop's greedy
  streams (each position a request whose prompt is the stream so far),
  their greedy token is float32's at 0.98 of the positions or more (the
  serving tier's int8 gate); the float32 loop itself at every position;
  speculative decoding to ``max_len`` (prompt plus new tokens
  fill the positional table; the target as a perfect draft starts a
  window at ``max_len`` - 2, past the table) with that draft and the
  one-layer one, greedy and sampled, token-identical to target-only;
- none of the kernels B1-B3 launches on this path.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lm_card.py -q

Without CUDA each test skips, with its reason.
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import faults, rtc, serving
from mxnet_tpu_torch.ops import matmul_stats, multibox_nms
from mxnet_tpu_torch.ops.nn import matmul_precision
from mxnet_tpu_torch.ops.transformer_stack import STACK_INPUTS

V, E, H, L, S, B = 300, 32, 4, 2, 32, 8
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
       "rescale_grad": 1.0 / (B * S)}
SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
PROMPTS = [[1, 2, 3], [50, 51], [7], [100, 101, 102, 103], [9, 10]]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the LM trains and decodes on "
                    "cuda:0 here (chip_smoke.py phase 17 runs this path at "
                    "full width)")


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _sym(layers=L, **kw):
    with mt.symbol.NameManager():
        return mt.models.transformer(vocab_size=V, embed=E, num_heads=H,
                                     num_layers=layers, seq_len=S, **kw)


def _params(name, layers=L):
    sym = _sym(layers)
    shapes, _, _ = sym.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = _rng(name)
    out = {}
    for n, shp in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("gamma"):
            out[n] = np.ones(shp, np.float32)
        elif n.endswith(("beta", "bias")):
            out[n] = np.zeros(shp, np.float32)
        else:
            a = np.sqrt(6.0 / (shp[0] + shp[1]))
            out[n] = rng.uniform(-a, a, shp).astype(np.float32)
    return out


def _fit(params, k, layers=L, epochs=2):
    rng = _rng("tokens")
    x = ((rng.integers(0, V, (8 * B, 1)) + np.arange(S)[None]) % V) \
        .astype(np.float32)
    it = mt.io.NDArrayIter(x, (x + 1) % V, batch_size=B,
                           label_name="softmax_label")
    mod = mt.mod.Module(_sym(layers), context=mt.gpu(0),
                        compute_dtype="bfloat16")
    metric = mt.metric.Perplexity(ignore_label=None)
    ppl = []
    mod.fit(it, eval_metric=metric, num_epoch=epochs, optimizer="sgd",
            optimizer_params=dict(OPT),
            arg_params={n: mt.nd.array(v, ctx=mt.cpu())
                        for n, v in params.items()},
            steps_per_dispatch=k,
            epoch_end_callback=lambda *a: ppl.append(metric.get()[1]))
    args, _ = mod.get_params()
    return {n: v.asnumpy() for n, v in args.items()}, ppl


def _forward(sym, params, x):
    ex = sym.simple_bind(mt.gpu(0), grad_req="null", data=x.shape,
                         softmax_label=x.shape)
    ex.copy_params_from({n: mt.nd.array(v, ctx=mt.gpu(0))
                         for n, v in params.items()})
    with matmul_precision(torch.device("cuda", 0)):
        ex.forward(is_train=False, data=mt.nd.array(x, ctx=mt.gpu(0)))
        return ex.outputs[0].asnumpy()


def _loop(params, **kw):
    kw.setdefault("prefix_cache", False)
    return serving.DecodeLoop(params, num_layers=L, num_heads=H, max_len=S,
                              slots=4, **kw)


def _streams(loop, n=12, prompts=PROMPTS, **kw):
    futs = [loop.generate(p, n, seed=11 + i, **kw)
            for i, p in enumerate(prompts)]
    return [f.result(timeout=300.0) for f in futs]


@pytest.fixture(scope="module")
def trained():
    """The small LM trained at K=1 and K=4 (fit on the card) for 12
    epochs, to a perplexity near 1.4 as phase 17's LM reaches (the
    quantized legs' greedy streams are held to the float32 ones, which
    needs argmaxes that are not near ties), and a one-layer draft."""
    _need_card()
    p0 = _params("lm")
    p1, ppl1 = _fit(p0, 1, epochs=12)
    p4, ppl4 = _fit(p0, 4, epochs=12)
    draft, _ = _fit(_params("draft", 1), 4, layers=1, epochs=1)
    return {"p1": p1, "p4": p4, "ppl1": ppl1, "ppl4": ppl4, "draft": draft}


@pytest.mark.gpu
def test_fit_card_k4_equals_k1(trained):
    _need_card()
    for ppl in (trained["ppl1"], trained["ppl4"]):
        assert np.all(np.isfinite(ppl)) and ppl[-1] < ppl[0], ppl
    p1, p4 = trained["p1"], trained["p4"]
    if not all(np.array_equal(p1[n], p4[n]) for n in p1):
        for n in p1:
            assert np.linalg.norm(p4[n] - p1[n]) <= \
                1e-3 * np.linalg.norm(p1[n]), n


@pytest.mark.gpu
def test_stacked_build_matches_per_layer_card(trained):
    _need_card()
    p = trained["p1"]
    stacked = {k: v for k, v in p.items() if not k.startswith("layer")}
    per = {"qkv_weight": "attn_qkv_weight", "qkv_bias": "attn_qkv_bias",
           "out_weight": "attn_out_weight", "out_bias": "attn_out_bias",
           "fc1_weight": "ffn_fc1_weight", "fc1_bias": "ffn_fc1_bias",
           "fc2_weight": "ffn_fc2_weight", "fc2_bias": "ffn_fc2_bias"}
    for name in STACK_INPUTS[1:]:
        stacked["stack_" + name] = np.stack(
            [p["layer%d_%s" % (i, per.get(name, name))] for i in range(L)])
    x = _rng("stack-x").integers(0, V, (4, S)).astype(np.float32)
    want = _forward(_sym(), p, x)
    got = _forward(_sym(stack_layers=True), stacked, x)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.gpu
def test_decode_card_legs(trained):
    _need_card()
    p = trained["p1"]
    loop = _loop(_params("cold"))
    try:
        loop.update_params(p)
        for n, v in p.items():
            assert torch.equal(loop._params[n].cpu(), torch.from_numpy(v))
        greedy = _streams(loop)
    finally:
        loop.close()
    x = np.zeros((len(PROMPTS), S), np.float32)
    for i, (pr, o) in enumerate(zip(PROMPTS, greedy)):
        x[i, :len(pr) + len(o)] = pr + o
    probs = _forward(_sym(), p, x).reshape(len(PROMPTS), S, V)
    for i, (pr, o) in enumerate(zip(PROMPTS, greedy)):
        for j, tok in enumerate(o):
            row = probs[i, len(pr) + j - 1]
            top = int(np.argmax(row))
            assert top == tok or row[top] - row[tok] < 1e-5, (i, j)
    loop = _loop(p)
    try:
        sampled = _streams(loop, **SAMPLED)
    finally:
        loop.close()
    loop = _loop(p, spec_k=2, draft_params=trained["draft"],
                 draft_num_layers=1)
    try:
        assert _streams(loop, **SAMPLED) == sampled
        assert loop.health.spec_drafted > 0
    finally:
        loop.close()
    shared = [4, 8, 15, 16, 23, 42]
    prompts = [shared + [1 + i] for i in range(4)]
    loop = _loop(p)
    try:
        cold = _streams(loop, prompts=prompts, **SAMPLED)
    finally:
        loop.close()
    loop = _loop(p, prefix_cache=True)
    try:
        warm = [loop.generate(pr, 12, seed=11 + i, prefix_len=len(shared),
                              **SAMPLED).result(timeout=300.0)
                for i, pr in enumerate(prompts)]
        assert warm == cold
        assert loop.health.prefix_hits == 3
    finally:
        loop.close()
    loop = _loop(p)
    try:
        faults.inject("serve.sample", nth=2, kind="raise")
        futs = [loop.generate(pr, 8, **SAMPLED) for pr in PROMPTS[:3]]
        for f in futs:
            with pytest.raises(serving.ServingClosedError):
                f.result(timeout=60.0)
    finally:
        faults.clear("serve.sample")
        loop.close()


def _teacher_forced_agreement(loop, streams):
    """The share of positions of ``streams`` (greedy, after PROMPTS) where
    the loop's greedy token, prompted with the stream so far, is the
    stream's own."""
    futs, want = [], []
    for pr, g in zip(PROMPTS, streams):
        for j, tok in enumerate(g):
            futs.append(loop.generate(pr + g[:j], 1))
            want.append(tok)
    got = [f.result(timeout=300.0)[0] for f in futs]
    return float(np.mean(np.equal(got, want)))


@pytest.mark.gpu
def test_decode_card_quantized_and_to_max_len(trained):
    _need_card()
    p = trained["p1"]
    loop = _loop(p)
    try:
        greedy = _streams(loop, n=24)
    finally:
        loop.close()
    for mode, floor in (("none", 1.0), ("bf16", 0.98), ("int8", 0.98)):
        loop = _loop(p, quantize=mode)
        try:
            assert _teacher_forced_agreement(loop, greedy) >= floor, mode
        finally:
            loop.close()
    new = [S - len(pr) for pr in PROMPTS[:4]]
    for gen in ({}, SAMPLED):
        loop = _loop(p)
        try:
            futs = [loop.generate(pr, n, seed=11 + i, **gen)
                    for i, (pr, n) in enumerate(zip(PROMPTS, new))]
            target = [f.result(timeout=300.0) for f in futs]
        finally:
            loop.close()
        for draft, layers in ((p, L), (trained["draft"], 1)):
            loop = _loop(p, spec_k=2, draft_params=draft,
                         draft_num_layers=layers)
            starts = []
            verify = loop._verify_fn

            def recording(state, params, tokens_w, pos0, *a):
                starts.append(int(pos0.max()))
                return verify(state, params, tokens_w, pos0, *a)
            loop._verify_fn = recording
            try:
                futs = [loop.generate(pr, n, seed=11 + i, **gen)
                        for i, (pr, n) in enumerate(zip(PROMPTS, new))]
                assert [f.result(timeout=300.0) for f in futs] == target
            finally:
                loop.close()
            if layers == L:
                assert max(starts) == S - 2


@pytest.mark.gpu
def test_lm_path_launches_no_kernel_of_b1_to_b3():
    _need_card()
    multibox_nms.reset_launches()
    matmul_stats.reset_launches()
    before = (rtc.RTC_LAUNCHES, rtc.TRITON_LAUNCHES)
    p, _ = _fit(_params("lm"), 4, epochs=1)
    loop = _loop(p)
    try:
        _streams(loop, n=4, **SAMPLED)
    finally:
        loop.close()
    assert (multibox_nms.LAUNCHES, matmul_stats.LAUNCHES,
            rtc.RTC_LAUNCHES - before[0],
            rtc.TRITON_LAUNCHES - before[1]) == (0, 0, 0, 0)
