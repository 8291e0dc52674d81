"""The port's chaos harness (``mxnet_tpu_torch.chaos``) against the JAX
package's ``mxnet_tpu.chaos``, on the CPU.

- ``sample_plan`` draws from the port's ``faults.SITES``, which equals the
  JAX registry name for name, so the plan bytes are equal for seeds 0–19
  in every scenario, and the CLI's ``--emit-plan`` prints the same text.
- ``rules_for_rank``, ``shrink_plan`` and the invariants' verdicts are
  equal on the same inputs.
- Every registered site fires in both packages with the same action.
- ``audit_sites`` is clean on the port (its ``faults.py`` site table and
  ``tests/test_torch_*.py``) and finds drift.
- The three committed plans (``tests/chaos_plans/``, read as they are)
  replay green through ``python -m mxnet_tpu_torch.chaos --replay
  --device cpu``: the dist plan kills rank 2 of a three-process fit
  launched by the port's launcher.

Tolerance: exact (bytes, strings and verdicts); each replay has its own
time limit.
"""
import json
import os
import subprocess
import sys

import pytest

import mxnet_tpu.chaos as jchaos
import mxnet_tpu.chaos.__main__ as jmain
import mxnet_tpu.faults as jfaults
import mxnet_tpu_torch.chaos as tchaos
import mxnet_tpu_torch.chaos.__main__ as tmain
import mxnet_tpu_torch.faults as tfaults
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.chaos import audit as taudit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = os.path.join(ROOT, "tests", "chaos_plans")

#: every registered site with a kind it samples (the literal names are
#: also the audit's proof that the port's tests reach each site)
ALL_SITES = [
    ("checkpoint.write", "truncate"),
    ("checkpoint.write.mid", "raise"),
    ("ckpt.async_die", "die"),
    ("ckpt.async_write", "delay"),
    ("ckpt.disk_full", "enospc"),
    ("data.decode_delay", "delay"),
    ("data.worker_die", "die"),
    ("fleet.replica_die", "die"),
    ("guard.grad_nan", "poison"),
    ("guard.loss_spike", "poison"),
    ("guard.param_nan", "poison"),
    ("io.batch_read", "transient"),
    ("io.h2d", "raise"),
    ("io.record_read", "transient"),
    ("kv.partition", "drop"),
    ("kv.push_delay", "delay"),
    ("kv.reform_delay", "delay"),
    ("kv.worker_die", "die"),
    ("kvstore.barrier", "transient"),
    ("kvstore.dead_node", "dead:1"),
    ("kvstore.pull", "transient"),
    ("kvstore.push", "transient"),
    ("serve.decode_die", "die"),
    ("serve.enqueue_drop", "drop"),
    ("serve.sample", "raise"),
    ("serve.spec_verify", "raise"),
    ("superbatch.producer", "die"),
]


@pytest.fixture(autouse=True)
def _clean():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def test_site_registry_equals_jax():
    assert [s for s, _ in ALL_SITES] == sorted(tfaults.SITES) == sorted(
        jfaults.SITES)
    for name in tfaults.SITES:
        assert tfaults.SITES[name].describe() == \
            jfaults.SITES[name].describe()
    for scen in tchaos.SCENARIOS:
        assert sorted(tfaults.sites(scen)) == sorted(jfaults.sites(scen))
    assert tchaos.SCENARIOS == jchaos.SCENARIOS
    assert tchaos.INVARIANTS == jchaos.INVARIANTS


@pytest.mark.parametrize("site,kind", ALL_SITES,
                         ids=[s for s, _ in ALL_SITES])
def test_every_registered_site_fires_as_in_jax(site, kind):
    got = []
    for faults in (jfaults, tfaults):
        faults.inject(site, nth=1, kind=kind, delay=0.0)
        if faults.SITES[site].flag:
            act = faults.fire_flag(site)
        else:
            try:
                act = faults.fire(site)
            except Exception as e:      # raise/transient kinds: typed
                act = type(e).__name__
        got.append((act, faults.fired(site), faults.fired_counts()))
        faults.clear()
        assert faults.fired_counts() == {}
    assert got[0] == got[1]
    assert got[1][1:] == (1, {site: 1})


@pytest.mark.parametrize("scenario", ["train", "data", "dist", "serve"])
def test_sample_plan_bytes_equal_for_seeds_0_to_19(scenario):
    for seed in range(20):
        t = tchaos.sample_plan(seed, scenario)
        j = jchaos.sample_plan(seed, scenario)
        assert t.to_json() == j.to_json(), (scenario, seed)
        n = len(t) + 1
        assert tchaos.sample_plan(seed, scenario, n_faults=n, nproc=4) \
            .to_json() == jchaos.sample_plan(seed, scenario, n_faults=n,
                                             nproc=4).to_json()


def test_emit_plan_cli_prints_the_same_text(capsys):
    texts = []
    for main in (jmain.main, tmain.main):
        assert main(["--emit-plan", "--seed", "7", "--scenario",
                     "serve"]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and texts[0].startswith("{")


def test_committed_plans_load_as_they_are():
    for name in sorted(os.listdir(PLANS)):
        raw = open(os.path.join(PLANS, name)).read()
        plan = tchaos.ChaosPlan.load(os.path.join(PLANS, name))
        assert plan.to_json() == raw
        assert tchaos.sample_plan(plan.seed, plan.scenario,
                                  n_faults=len(plan)).to_json() == raw
    bad = json.loads(raw)
    bad["version"] = 2
    with pytest.raises(MXNetError, match="plan version"):
        tchaos.ChaosPlan.from_dict(bad)


def test_rules_for_rank_equal():
    rules = [
        {"site": "kv.worker_die", "kind": "die", "nth": 9, "times": 1,
         "delay": 0.05, "rank": 2},
        {"site": "kvstore.pull", "kind": "transient", "nth": 1,
         "times": 1, "delay": 0.05, "rank": 0},
        {"site": "kv.push_delay", "kind": "delay", "nth": 3, "times": 1,
         "delay": 0.1}]
    for r in range(3):
        got = [pkg.ChaosPlan(0, "dist", rules).rules_for_rank(r)
               for pkg in (jchaos, tchaos)]
        assert got[0] == got[1]
    p = tchaos.ChaosPlan(0, "dist", rules)
    assert [x["site"] for x in p.rules_for_rank(2)] == ["kv.worker_die",
                                                       "kv.push_delay"]
    assert p.describe() == jchaos.ChaosPlan(0, "dist", rules).describe()


@pytest.mark.parametrize("culprits", [("checkpoint.write", "io.h2d"),
                                      ("io.h2d",), ()])
def test_shrink_equal(culprits):
    sites = ["io.batch_read", "checkpoint.write", "ckpt.async_write",
             "io.h2d"]

    def violates(p):
        s = set(p.sites())
        return all(c in s for c in culprits) if culprits else len(p) == 4

    got = []
    for pkg in (jchaos, tchaos):
        plan = pkg.ChaosPlan(0, "train", [
            {"site": s, "kind": "raise", "nth": i + 1, "times": 1,
             "delay": 0.05} for i, s in enumerate(sites)])
        log = []
        shrunk, runs = pkg.shrink_plan(plan, violates, log=log.append)
        got.append((shrunk.to_json(), runs, log))
    assert got[0] == got[1]


def _result(**over):
    base = {"scenario": "train", "outcome": "completed", "typed": True,
            "fault_fired": {}, "fault_counts": {}, "health": {},
            "flight": {"exists": True, "parses": True}}
    base.update(over)
    return base


def _outcome(result=None, **over):
    base = {"scenario": "train", "watchdog_fired": False, "rc": 0,
            "wall_s": 1.0, "deadline_s": 240.0, "result": result}
    base.update(over)
    return base


def _dist_outcome():
    ranks = {0: _result(scenario="dist", final_hash="aa" * 32),
             1: _result(scenario="dist", final_hash="bb" * 32),
             2: None}
    out = _outcome(None, scenario="dist", rank_results=ranks,
                   expected_dead=[2], rc=137)
    del out["result"]
    return out


_CASES = {
    "green": (("train", 0, None), _outcome(_result())),
    "hang": (("train", 0, None), _outcome(None, watchdog_fired=True)),
    "bare_crash": (("train", 0, None), _outcome(None, rc=1)),
    "untyped": (("train", 0, None), _outcome(_result(
        outcome="error", typed=False, error_type="ValueError",
        error_msg="boom"))),
    "settle": (("serve", 1, None), _outcome(_result(
        scenario="serve", settle={"submitted": 10, "completed": 6,
                                  "expired": 1, "shed": 1, "failed": 1,
                                  "unsettled": 1}))),
    "resume": (("train", 0, None), _outcome(_result(
        resume={"mode": "bitwise", "ok": False, "detail": "hash"}))),
    "grad_nan": (("train", 0, [{"site": "guard.grad_nan", "kind": "poison",
                                "nth": 1, "times": 1, "delay": 0.05}]),
                 _outcome(_result(fault_fired={"guard.grad_nan": 1}))),
    "flight": (("serve", 1, [{"site": "fleet.replica_die", "kind": "die",
                              "nth": 1, "times": 1, "delay": 0.05}]),
               _outcome(_result(scenario="serve",
                                fault_fired={"fleet.replica_die": 1},
                                flight={"exists": False,
                                        "parses": False}))),
    "dist_hashes": (("dist", 13, None), _dist_outcome()),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_invariant_verdicts_equal(case, monkeypatch):
    (scenario, seed, rules), outcome = _CASES[case]
    for broken in (None, "typed_outcome"):
        if broken:
            monkeypatch.setenv("MXTPU_CHAOS_BREAK_INVARIANT", broken)
        got = []
        for pkg in (jchaos, tchaos):
            plan = (pkg.ChaosPlan(seed, scenario, rules) if rules
                    else pkg.sample_plan(seed, scenario))
            got.append([v.to_dict() for v in
                        pkg.check_scenario(plan, outcome)])
        assert got[0] == got[1], (case, broken)
    if case == "green":
        monkeypatch.delenv("MXTPU_CHAOS_BREAK_INVARIANT")
        assert tchaos.check_scenario(tchaos.sample_plan(0, "train"),
                                     outcome) == []


def test_audit_is_clean_on_the_port():
    assert taudit.audit_sites() == []
    assert tmain.main(["--audit-sites"]) == 0


def test_audit_finds_drift(tmp_path):
    doc = ("x\n====  ====\nsite  where\n====  ====\n"
           "``io.record_read``  per record\n``no.such.site``  ghost\n"
           "====  ====\n")
    problems = taudit.audit_sites(doc_text=doc)
    assert any("'ckpt.disk_full'" in p and "missing from" in p
               for p in problems)
    assert any("'no.such.site'" in p and "not registered" in p
               for p in problems)
    with pytest.raises(ValueError, match="rule lines"):
        taudit.doc_sites("no table here\n")
    (tmp_path / "test_torch_x.py").write_text(
        'faults.fire("io.record_read")\n')
    (tmp_path / "test_other.py").write_text('fire("ckpt.disk_full")\n')
    problems = taudit.audit_sites(tests_dir=str(tmp_path))
    assert any("'ckpt.disk_full'" in p and "test_torch_" in p
               for p in problems)
    assert not any("'io.record_read'" in p for p in problems)


@pytest.mark.parametrize("plan", sorted(os.listdir(PLANS)))
def test_committed_plan_replays_green_on_the_cpu(plan, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.chaos", "--replay",
         os.path.join(PLANS, plan), "--workdir", str(tmp_path),
         "--device", "cpu", "--deadline", "200"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "RESULT: GREEN" in r.stdout
    if plan.startswith("dist"):
        res = {k: json.load(open(tmp_path / ("rank%d.json" % k)))
               for k in (0, 1)}
        assert not (tmp_path / "rank2.json").exists()
        assert res[0]["final_hash"] == res[1]["final_hash"]
        assert res[0]["reforms"] == res[1]["reforms"] == 1
