"""The port's decode loop (``serving.DecodeLoop``: in-graph sampling,
int8/bf16 weights, the prefix cache, speculative decoding) against the JAX
package's ``mxnet_tpu.serving.DecodeLoop``, on the CPU.

Sizes: 2 layers, embed 32, 4 heads, vocabulary 64, ``max_len`` 16, 4
slots; random float32 weights from a seed (``randn * 0.3``, as the JAX
package's decode tests make them). Tolerances: none. The uniforms are
held against ``jax.random`` bit for bit, ``sample_rows`` token for token
on 1000 random rows (and, with ``u`` one float below 1, where the
backends' cumulative sums round apart, within 1e-6 of the mass of a CDF
edge), and every stream token for token (greedy and
sampled at float32, bf16 and int8 weights, against the JAX package;
speculative, prefix-hit and co-rider runs against the port's own
target-only, cold and solo runs, and speculative runs to ``max_len``
against the JAX package's too); weight bytes and reloaded parameters are
exact.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import models as jmodels
from mxnet_tpu import serving as jserving
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.serving import sampling as jsampling
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import sampling

V, E, H, L, MAXLEN, SLOTS = 64, 32, 4, 2, 16, 4
PROMPTS = [[1, 2, 3], [5, 6, 7, 8], [9], [10, 11], [12, 13, 14], [20]]
SAMPLED = dict(temperature=0.8, top_k=10, top_p=0.9)


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _params(name, layers=L):
    sym = jmodels.transformer(vocab_size=V, embed=E, num_heads=H,
                              num_layers=layers, seq_len=MAXLEN)
    shapes, _, _ = sym.infer_shape(data=(1, MAXLEN),
                                   softmax_label=(1, MAXLEN))
    rng = _rng(name)
    return {n: (0.3 * rng.standard_normal(s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


PARAMS = _params("target")


def _loop(pkg, params=PARAMS, **kw):
    kw.setdefault("slots", SLOTS)
    kw.setdefault("prefix_cache", False)
    if pkg is serving:
        kw.setdefault("device", "cpu")
    kw.setdefault("max_len", MAXLEN)
    return pkg.DecodeLoop(params, num_layers=L, num_heads=H, **kw)


def _streams(loop, prompts=PROMPTS, n=8, **kw):
    futs = [loop.generate(p, n, seed=7 + i, **kw)
            for i, p in enumerate(prompts)]
    return [f.result(timeout=120.0) for f in futs]


def _run(pkg, params=PARAMS, prompts=PROMPTS, n=8, gen=None, **kw):
    loop = _loop(pkg, params, **kw)
    try:
        return _streams(loop, prompts, n, **(gen or {})), loop
    finally:
        loop.close()


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX package's streams of PROMPTS, by (quantize, greedy or
    sampled), each decoded on first use."""
    cache = {}

    def get(mode, kind):
        if (mode, kind) not in cache:
            cache[mode, kind] = _run(
                jserving, quantize=mode,
                gen=SAMPLED if kind == "sampled" else None)[0]
        return cache[mode, kind]
    return get


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_position_uniforms_match_jax_bit_for_bit():
    seeds = np.array([0, 1, 5, 0x7FFFFFFF, 0x7FFFFFFE, 123456789,
                      2 ** 30], np.uint32)
    pos = np.arange(MAXLEN + 2, dtype=np.int32)
    sg, pg = (a.reshape(-1) for a in np.meshgrid(seeds, pos))
    want = np.asarray(jsampling.position_uniforms(jnp.asarray(sg),
                                                  jnp.asarray(pg)))
    got = sampling.position_uniforms(torch.from_numpy(sg.astype(np.int64)),
                                     torch.from_numpy(pg)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the worked example: seed 5 at position 7
    k0, k1 = sampling.threefry2x32(*[torch.tensor([v]) for v in
                                     (0, 5, 0, 7)])
    assert (int(k0), int(k1)) == (1394159668, 1590028285)
    u = sampling.position_uniforms(torch.tensor([5]), torch.tensor([7]))
    assert u.numpy().view(np.uint32)[0] == np.float32(
        jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(5), 7))
    ).view(np.uint32)


def _rows(name, n):
    rng = _rng(name)
    logits = (2.0 * rng.standard_normal((n, V))).astype(np.float32)
    logits[::7, 3] = logits[::7, 5]            # ties, broken by index
    u = rng.random(n).astype(np.float32)
    temp = rng.choice([0.0, 0.5, 0.8, 1.0, 1.5], n).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 50], n).astype(np.int32)
    top_p = rng.choice([1.0, 0.95, 0.9, 0.5], n).astype(np.float32)
    return logits, u, temp, top_k, top_p


def _sample_both(args):
    want = np.asarray(jsampling.sample_rows(*[jnp.asarray(a) for a in args]))
    got = sampling.sample_rows(*[torch.from_numpy(a) for a in args]).numpy()
    return got, want


def test_sample_rows_matches_jax_on_1000_rows():
    got, want = _sample_both(_rows("rows", 1000))
    np.testing.assert_array_equal(got, want)


def test_sample_rows_at_the_float_edge():
    """With ``u`` one float below 1 the token is the last whose CDF passes
    ``u`` times the kept mass, which the two backends' cumulative sums
    round differently. Where the packages part, the JAX package's choice
    sits within 1e-6 of the kept mass of the crossing in the port's own
    CDF: the uniform landed on a CDF edge, not a different rule."""
    logits, u, temp, top_k, top_p = _rows("edge", 200)
    u[:] = np.float32(1.0) - np.float32(2 ** -24)
    temp[:] = 0.5
    top_k[:] = 0
    top_p[:] = 1.0
    got, want = _sample_both((logits, u, temp, top_k, top_p))
    scaled = torch.from_numpy(logits) / 0.5
    order = torch.argsort(-scaled, dim=-1, stable=True)
    cdf = torch.cumsum(torch.softmax(torch.gather(scaled, -1, order), -1),
                       -1).numpy()
    rank_of = np.argsort(order.numpy(), axis=-1)
    for i in np.nonzero(got != want)[0]:
        target = u[i] * cdf[i, -1]
        gap = abs(cdf[i, rank_of[i, want[i]]] - target)
        assert gap < 1e-6 * cdf[i, -1], (i, gap)


@pytest.mark.parametrize("knobs", [dict(temperature=-1.0),
                                   dict(temperature=float("nan")),
                                   dict(top_k=-1), dict(top_p=0.0),
                                   dict(top_p=1.5)])
def test_validate_sampling_matches_jax(knobs):
    kw = dict(temperature=0.5, top_k=0, top_p=1.0)
    kw.update(knobs)
    with pytest.raises(JMXNetError) as jerr:
        jsampling.validate_sampling(**kw)
    with pytest.raises(MXNetError) as terr:
        sampling.validate_sampling(**kw)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# streams against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_greedy_streams_match_jax(jax_streams, mode):
    """Float32, bf16 and int8 weights: the port dequantizes as the JAX
    package does, so each mode's streams are the JAX package's."""
    got, _ = _run(serving, quantize=mode)
    assert got == jax_streams(mode, "greedy")


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_sampled_streams_match_jax(jax_streams, mode):
    got, _ = _run(serving, quantize=mode, gen=SAMPLED)
    assert got == jax_streams(mode, "sampled")


def test_temperature_zero_is_bitwise_greedy():
    """A sampled-path request with temperature 0 (top-k/top-p set) gives
    the greedy stream, and ``sample_rows`` returns the first argmax of
    the logits for such rows."""
    greedy, _ = _run(serving)
    zero, _ = _run(serving, gen=dict(temperature=0.0, top_k=5, top_p=0.5))
    assert zero == greedy
    logits = torch.from_numpy(_rng("t0").standard_normal((8, V))
                              .astype(np.float32))
    z = torch.zeros(8)
    got = sampling.sample_rows(logits, torch.rand(8), z,
                               torch.full((8,), 5), torch.full((8,), 0.5))
    assert torch.equal(got, logits.argmax(dim=-1).to(torch.int32))


def test_sampled_stream_is_immune_to_co_riders():
    """A seeded stream decoded alone equals the same request decoded
    while other sequences join and retire around it (one more request
    than slots, different lengths)."""
    loop = _loop(serving)
    try:
        alone = loop.generate([3, 4, 5], 10, seed=99,
                              **SAMPLED).result(timeout=120.0)
        others = [loop.generate(p, 2 + i, seed=i, **SAMPLED)
                  for i, p in enumerate(PROMPTS[:3])]
        mine = loop.generate([3, 4, 5], 10, seed=99, **SAMPLED)
        late = [loop.generate(p, 4, seed=50 + i, **SAMPLED)
                for i, p in enumerate(PROMPTS[3:])]
        assert mine.result(timeout=120.0) == alone
        for f in others + late:
            f.result(timeout=120.0)
        assert loop.health.joined == 1 + len(others) + 1 + len(late)
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# the prefix cache
# ---------------------------------------------------------------------------

SHARED = [4, 8, 15, 16, 23, 42]


def test_prefix_hit_equals_cold_start():
    prompts = [SHARED + [1, 2], SHARED + [3], SHARED + [5, 6]]
    cold, _ = _run(serving, prompts=prompts, n=6, gen=SAMPLED)
    loop = _loop(serving, prefix_cache=True)
    try:
        warm = [loop.generate(p, 6, seed=7 + i, prefix_len=len(SHARED),
                              **SAMPLED).result(timeout=120.0)
                for i, p in enumerate(prompts)]
        h = loop.health.report()
    finally:
        loop.close()
    assert warm == cold
    assert (h["prefix_prefills"], h["prefix_hits"]) == (1, 2)


def test_prefix_lru_evicts_at_capacity(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_PREFIX_MAX", "2")
    loop = _loop(serving, prefix_cache=True)
    try:
        assert loop.prefix_max == 2
        for first in (30, 31, 32):
            loop.generate([first, 1, 2, 3], 2,
                          prefix_len=3).result(timeout=120.0)
        assert list(loop._prefix) == [(31, 1, 2), (32, 1, 2)]
        loop.generate([30, 1, 2, 9], 2, prefix_len=3).result(timeout=120.0)
        h = loop.health.report()
        assert (h["prefix_prefills"], h["prefix_hits"]) == (4, 0)
        loop.generate([32, 1, 2, 9], 2, prefix_len=3).result(timeout=120.0)
        assert loop.health.prefix_hits == 1
        assert list(loop._prefix) == [(30, 1, 2), (32, 1, 2)]
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gen", [{}, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("draft", ["perfect", "weak"])
def test_speculative_output_equals_target_only(draft, gen):
    target, _ = _run(serving, gen=gen)
    if draft == "perfect":
        kw = dict(draft_params=PARAMS, draft_num_layers=L)
    else:
        kw = dict(draft_params=_params("draft", layers=1))
    spec, loop = _run(serving, gen=gen, spec_k=2, **kw)
    assert spec == target
    h = loop.health.report()
    assert h["spec_rounds"] > 0 and h["spec_drafted"] > 0
    if draft == "perfect":
        assert h["spec_accepted"] == h["spec_drafted"]
    else:
        assert h["spec_accepted"] < h["spec_drafted"]


@pytest.mark.parametrize("gen", [{}, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("draft", ["perfect", "weak"])
def test_speculative_to_max_len_matches_target_and_jax(draft, gen):
    """Requests whose prompt plus new tokens fill ``max_len``, on tables
    of exactly ``max_len`` positions: windows that start ``spec_k`` or
    fewer positions before the last sample reach past the table, whose
    row is clamped as the JAX package's gather clamps it. ``max_len`` 14
    puts the last sample (position 12) on a window start of the perfect
    draft (which advances 3 a round). The streams equal target-only
    decoding and the JAX package's speculative loop."""
    max_len = 14
    prompts = PROMPTS[:SLOTS]

    def cut(params):
        return dict(params,
                    pos_embed_weight=params["pos_embed_weight"][:max_len])
    params = cut(PARAMS)
    if draft == "perfect":
        kw = dict(draft_params=params, draft_num_layers=L)
    else:
        kw = dict(draft_params=cut(_params("draft", layers=1)))

    def run(pkg, **loop_kw):
        loop = _loop(pkg, params, max_len=max_len, **loop_kw)
        starts = []
        if pkg is serving and loop.spec_k:
            verify = loop._verify_fn

            def recording(state, params, tokens_w, pos0, *a):
                starts.append(int(pos0.max()))
                return verify(state, params, tokens_w, pos0, *a)
            loop._verify_fn = recording
        try:
            futs = [loop.generate(p, max_len - len(p), seed=7 + i, **gen)
                    for i, p in enumerate(prompts)]
            return [f.result(timeout=120.0) for f in futs], starts
        finally:
            loop.close()
    target, _ = run(serving)
    spec, starts = run(serving, spec_k=2, **kw)
    jspec, _ = run(jserving, spec_k=2, **kw)
    assert [len(o) for o in target] == [max_len - len(p) for p in prompts]
    assert max(starts) == max_len - 2     # a window reached past the table
    assert spec == target
    assert jspec == target


def test_spec_k_without_draft_raises():
    with pytest.raises(MXNetError, match="needs draft_params"):
        _loop(serving, spec_k=2)


# ---------------------------------------------------------------------------
# quantized weights and hot reload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_weight_bytes_match_jax(mode):
    draft = _params("draft", layers=1)
    kw = dict(quantize=mode, spec_k=1, draft_params=draft)
    jloop = _loop(jserving, **kw)
    tloop = _loop(serving, **kw)
    try:
        assert tloop.weight_bytes() == jloop.weight_bytes()
        assert tloop.quant_mode == mode
    finally:
        jloop.close()
        tloop.close()


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_update_params_is_bitwise(mode):
    """A reload lands the new weights exactly as a loop built with them
    holds them, and decodes their streams."""
    new = _params("reloaded")
    loop = _loop(serving, quantize=mode)
    fresh = _loop(serving, new, quantize=mode)
    try:
        before = _streams(loop)
        loop.update_params({k: mt.nd.array(v, ctx=mt.cpu())
                            for k, v in new.items()})
        for k, v in fresh._params.items():
            got = loop._params[k]
            if isinstance(v, dict):
                assert all(torch.equal(got[n], v[n]) for n in v), k
            else:
                assert torch.equal(got, v), k
        assert _streams(loop) == _streams(fresh) != before
        with pytest.raises(MXNetError, match="missing"):
            loop.update_params({"lm_head_bias": new["lm_head_bias"]})
        with pytest.raises(MXNetError, match="shape"):
            loop.update_params(dict(new, lm_head_bias=np.zeros(3,
                                                               np.float32)))
    finally:
        loop.close()
        fresh.close()


# ---------------------------------------------------------------------------
# knobs, validation and what is not ported
# ---------------------------------------------------------------------------

def test_knob_chain_arg_env_db_default(monkeypatch, tmp_path):
    """arg > MXTPU_SERVE_* env > tuning DB > default, the DB matched on
    the parameter signature and the loop's device kind; a DB ``spec_k``
    without a draft is dropped with a warning."""
    from mxnet_tpu_torch.autotune import db as adb
    for var in ("MXTPU_SERVE_SPEC_K", "MXTPU_SERVE_PREFIX_CACHE",
                "MXTPU_SERVE_QUANT"):
        monkeypatch.delenv(var, raising=False)
    loop = _loop(serving, prefix_cache=None)
    assert (loop.spec_k, loop.prefix_enabled, loop.quant_mode) == \
        (0, True, "none")
    loop.close()
    path = tmp_path / "tune.json"
    tdb = adb.TuningDB(str(path))
    tdb.put("lm", "decode_tokens_per_sec", 0,
            {"spec_k": 2, "prefix_cache": 0}, 100.0, "tokens/sec",
            kind="decode", symbol_sig=adb.param_signature(PARAMS),
            device="cpu")
    tdb.save()
    monkeypatch.setenv("MXTPU_AUTOTUNE_DB", str(path))
    loop = _loop(serving, prefix_cache=None)
    assert (loop.spec_k, loop.prefix_enabled) == (0, False)   # db
    loop.close()
    loop = _loop(serving, prefix_cache=None,
                 draft_params=_params("draft", layers=1))
    assert loop.spec_k == 2                                    # db
    loop.close()
    monkeypatch.setenv("MXTPU_SERVE_PREFIX_CACHE", "1")
    monkeypatch.setenv("MXTPU_SERVE_QUANT", "bf16")
    monkeypatch.setenv("MXTPU_SERVE_SPEC_K", "0")
    loop = _loop(serving, prefix_cache=None,
                 draft_params=_params("draft", layers=1))
    assert (loop.spec_k, loop.prefix_enabled, loop.quant_mode) == \
        (0, True, "bf16")                                      # env
    loop.close()
    loop = _loop(serving, prefix_cache=False, quantize="int8", spec_k=1,
                 draft_params=_params("draft", layers=1))
    assert (loop.spec_k, loop.prefix_enabled, loop.quant_mode) == \
        (1, False, "int8")                                     # arg
    loop.close()


@pytest.mark.parametrize("args,kw", [
    (([],), {}), (([V],), {}), (([-1, 2],), {}),
    (([1, 2, 3], MAXLEN), {}), (([1, 2], 3), dict(prefix_len=2)),
    (([1, 2], 3), dict(temperature=-0.5))])
def test_generate_errors_match_jax(args, kw):
    args = args if len(args) == 2 else args + (3,)
    jloop, tloop = _loop(jserving), _loop(serving)
    try:
        with pytest.raises(JMXNetError) as jerr:
            jloop.generate(*args, **kw)
        with pytest.raises(MXNetError) as terr:
            tloop.generate(*args, **kw)
        assert str(terr.value) == str(jerr.value)
    finally:
        jloop.close()
        tloop.close()


def test_construction_errors_and_unported_options():
    with pytest.raises(MXNetError, match="missing 'lm_head_bias'"):
        _loop(serving, {k: v for k, v in PARAMS.items()
                        if k != "lm_head_bias"})
    with pytest.raises(MXNetError, match="positional embedding"):
        serving.DecodeLoop(PARAMS, num_layers=L, num_heads=H,
                           max_len=MAXLEN + 1, device="cpu")
    with pytest.raises(MXNetError, match="num_heads"):
        serving.DecodeLoop(PARAMS, num_layers=L, num_heads=5,
                           max_len=MAXLEN, device="cpu")
    # a model-parallel loop splits the KV cache over heads
    with pytest.raises(MXNetError, match="num_heads 4 % 3"):
        _loop(serving, contexts=[mt.cpu(i) for i in range(3)])
    loop, jloop = _loop(serving), _loop(jserving)
    try:
        # comms_report: the JAX package's program names, and no collective
        # on one device in either package; check(comms=True) finds nothing
        creps, jcreps = loop.comms_report(), jloop.comms_report()
        assert sorted(n.split("/", 1)[1] for n in creps) == sorted(
            n.split("/", 1)[1] for n in jcreps) == [
            "step[slots=%d,len=%d]" % (SLOTS, MAXLEN)]
        for rep in list(creps.values()) + list(jcreps.values()):
            assert rep.collective_count == 0
        assert loop.check(comms=True) == []
        # memory_report: the JAX package's program names, the
        # KV caches donated and updated in place
        reps, jreps = loop.memory_report(), jloop.memory_report()
        tags = sorted(n.split("/", 1)[1] for n in reps)
        assert tags == sorted(n.split("/", 1)[1] for n in jreps) == [
            "step[slots=%d,len=%d]" % (SLOTS, MAXLEN)]
        (rep,) = reps.values()
        assert rep.alias_bytes == rep.donated_bytes > 0
        assert not rep.unaliased_donated
    finally:
        loop.close()
        jloop.close()
    with pytest.raises(serving.ServingClosedError):
        loop.generate([1], 1)


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------

@pytest.mark.faults
@pytest.mark.parametrize("site,kind,spec", [
    ("serve.decode_die", "die", False), ("serve.sample", "raise", False),
    ("serve.spec_verify", "raise", True)])
def test_fault_sites_shed_with_serving_closed(site, kind, spec):
    """Each decode site kills the loop thread, which sheds the sequence in
    flight and the queued ones with ServingClosedError; a round killed
    before its verify pass commits nothing (only the first, verified
    round is counted)."""
    kw = dict(spec_k=2, draft_params=PARAMS, draft_num_layers=L) \
        if spec else {}
    loop = _loop(serving, slots=1, **kw)
    try:
        tfaults.inject(site, nth=2, kind=kind)
        futs = [loop.generate([1, 2, 3], 6, **SAMPLED) for _ in range(3)]
        for f in futs:
            with pytest.raises(serving.ServingClosedError):
                f.result(timeout=60.0)
        assert loop.dead is not None
        assert loop.health.shed == 3
        if spec:
            assert loop.health.spec_rounds == 1     # the one verified
        with pytest.raises(serving.ServingClosedError):
            loop.generate([1], 1)
    finally:
        tfaults.clear(site)
        loop.close()
