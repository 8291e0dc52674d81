"""The port's autotune search driver, knob spaces and bench-knob table
against the JAX package's.

- the same knob space and the same ``evaluate``/``prune`` stubs give the
  same trial order, statuses, scores and best in both packages: an
  exhaustive grid, a greedy hill climb, a crashing candidate, a candidate
  that times out (the sweep stops there), and a pruned candidate (never
  executed, its prune cached per program-knob projection);
- ``space_for`` of every objective and ``BENCH_KNOBS`` are equal in both
  packages, and ``benv`` reads the same values and turns the same junk
  into ``MXNetError``.

Tolerance: none (trial sequences, statuses and scores are exact; the
stubs return the same floats in both packages).
"""
import threading

import pytest

from mxnet_tpu import autotune as jat
from mxnet_tpu.autotune import benchcfg as jbench
from mxnet_tpu.autotune import search as jsearch
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu_torch import autotune as tat
from mxnet_tpu_torch.autotune import benchcfg as tbench
from mxnet_tpu_torch.autotune import search as tsearch
from mxnet_tpu_torch.base import MXNetError


def _trials(driver):
    return [(t.knobs, t.score, t.status) for t in driver.trials]


def _both(space, evaluate, kw):
    """Run the same sweep in both packages, each with its own ``Knob``s,
    ``evaluate(mod)`` and driver arguments ``kw`` (a dict, or
    ``kw(mod)``); returns ``[(best, trials, driver)]``, JAX first."""
    out = []
    for mod in (jsearch, tsearch):
        sp = [mod.Knob(k.name, k.values) for k in space]
        d = mod.SearchDriver(sp, evaluate(mod),
                             **(kw(mod) if callable(kw) else kw))
        best, _ = d.run()
        out.append((best, _trials(d), d))
    return out


def _same(runs):
    (jb, jt, jd), (tb, tt, td) = runs
    assert tt == jt
    assert (tb and (tb.knobs, tb.score)) == (jb and (jb.knobs, jb.score))
    assert td.counts() == jd.counts()
    assert td.default_knobs() == jd.default_knobs()
    return runs[1]


def test_grid_in_declared_order_matches_jax():
    space = [jsearch.Knob("a", (1, 2)), jsearch.Knob("b", (0, 1, 2))]
    seen = {}

    def ev(mod):
        seen[mod] = []

        def f(kn):
            seen[mod].append((kn["a"], kn["b"]))
            return kn["a"] * 10.0 + kn["b"]
        return f

    best, trials, d = _same(_both(space, ev, dict(budget=10)))
    assert seen[tsearch] == seen[jsearch] == [
        (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2)]
    assert d.default_trial.knobs == {"a": 1, "b": 0}
    assert best.knobs == {"a": 2, "b": 2}


def test_hill_climb_matches_jax():
    # 4 x 4 x 3 = 48 candidates over a budget of 7: the greedy climb
    space = [jsearch.Knob("x", (0, 1, 2, 3)),
             jsearch.Knob("y", (0, 1, 2, 3)),
             jsearch.Knob("z", ("a", "b", "c"))]

    def ev(mod):
        return lambda kn: (-(kn["x"] - 2) ** 2 - (kn["y"] - 1) ** 2
                           + {"a": 0.0, "b": 0.5, "c": 0.25}[kn["z"]])

    best, trials, d = _same(_both(space, ev, dict(budget=7)))
    assert len(trials) == 7 and trials[0][0] == {"x": 0, "y": 0, "z": "a"}
    assert best.knobs == {"x": 2, "y": 1, "z": "a"}


def test_crashing_candidate_scores_neg_inf_in_both():
    space = [jsearch.Knob("k", (1, 2, 4))]

    def ev(mod):
        def f(kn):
            if kn["k"] == 2:
                raise RuntimeError("out of memory")
            return float(kn["k"])
        return f

    best, trials, d = _same(_both(space, ev, dict(budget=5)))
    assert [t[2] for t in trials] == ["ok", "error", "ok"]
    assert trials[1][1] == float("-inf") and best.knobs == {"k": 4}
    assert "out of memory" in d.trials[1].detail


def test_timeout_stops_the_sweep_in_both():
    space = [jsearch.Knob("k", (1, 2, 3, 4))]
    release = threading.Event()

    def ev(mod):
        def f(kn):
            if kn["k"] == 2:
                release.wait(5.0)     # wedged past the trial timeout
            return float(kn["k"])
        return f

    try:
        best, trials, d = _same(_both(space, ev, dict(
            budget=10, trial_timeout=0.2)))
    finally:
        release.set()
    assert [t[2] for t in trials] == ["ok", "timeout"]
    assert d.timed_out and best.knobs == {"k": 1}


def test_pruned_candidate_never_executes_in_both():
    space = [jsearch.Knob("spd", (1, 2, 4)), jsearch.Knob("depth", (1, 0))]
    ran, pruned = {}, {}

    def ev(mod):
        ran[mod] = []
        return lambda kn: ran[mod].append(dict(kn)) or float(kn["spd"])

    def kw(mod):
        pruned[mod] = []

        def prune(kn):
            pruned[mod].append(kn["spd"])
            return ["over budget"] if kn["spd"] == 4 else []
        return dict(prune=prune, program_knobs=("spd",), budget=10)

    best, trials, d = _same(_both(space, ev, kw))
    assert [t[2] for t in trials] == ["ok"] * 4 + ["pruned"] * 2
    for mod in (jsearch, tsearch):
        assert all(kn["spd"] != 4 for kn in ran[mod])
        # one prune a program-knob projection: spd=1, 2, 4 once each
        assert pruned[mod] == [1, 2, 4]
    assert best.knobs == {"spd": 2, "depth": 1}
    assert d.trials[-1].detail == "over budget"


def test_empty_space_and_knob_raise_in_both():
    for mod, err in ((jsearch, JMXNetError), (tsearch, MXNetError)):
        with pytest.raises(err, match="empty knob space"):
            mod.SearchDriver([], lambda kn: 0.0)
        with pytest.raises(err, match="has no values"):
            mod.SearchDriver([mod.Knob("a", ())], lambda kn: 0.0)


@pytest.mark.parametrize("objective", [
    "img_per_sec", "tokens_per_sec", "serve_p99", "serve_p50",
    "decode_tokens_per_sec"])
def test_space_for_matches_jax(objective):
    def plain(space):
        return [(k.name, k.values) for k in space]
    assert plain(tat.space_for(objective)) == plain(jat.space_for(objective))
    assert plain(tat.train_space(spd_values=(1, 3))) == plain(
        jat.train_space(spd_values=(1, 3)))


def test_bench_knobs_match_jax():
    assert ({n: tuple(k) for n, k in tbench.BENCH_KNOBS.items()}
            == {n: tuple(k) for n, k in jbench.BENCH_KNOBS.items()})
    assert tbench.bench_defaults() == jbench.bench_defaults()


@pytest.mark.parametrize("name,value", [
    ("BENCH_BATCH", "64"), ("BENCH_SERVE_QPS", "12.5"),
    ("BENCH_LM", "off"), ("BENCH_FLEET_DRAIN", "1"),
    ("BENCH_DTYPE", "float32"), ("BENCH_BATCH", "")])
def test_benv_reads_like_jax(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    assert tbench.benv(name) == jbench.benv(name)
    assert tbench.env_set(name) == jbench.env_set(name)


@pytest.mark.parametrize("name,junk", [
    ("BENCH_BATCH", "12q"), ("BENCH_SERVE_QPS", "fast"),
    ("BENCH_ROUNDS", "2.5")])
def test_benv_junk_raises_in_both(monkeypatch, name, junk):
    monkeypatch.setenv(name, junk)
    with pytest.raises(JMXNetError, match=name):
        jbench.benv(name)
    with pytest.raises(MXNetError, match=name):
        tbench.benv(name)
    for mod, err in ((jbench, JMXNetError), (tbench, MXNetError)):
        with pytest.raises(err, match="not a declared bench knob"):
            mod.benv("BENCH_NOPE")
