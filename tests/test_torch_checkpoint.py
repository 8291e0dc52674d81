"""The port's fault-tolerant checkpoints and resume against the JAX
package's contract (the counterparts of ``tests/test_checkpoint_resume.py``),
on the CPU.

Pins: atomic checksummed checkpoints with retention and a ``latest``
pointer; fallback past a torn, corrupt or disk-full checkpoint;
``fit(resume="auto")`` reaching parameters bit for bit equal to an
uninterrupted run at one and at several steps a dispatch, in process and
through a real SIGKILL and SIGTERM of a subprocess (its worker is this
file's ``__main__``); the async writer's shedding and its dead-thread
recovery; FeedForward's save, load and predict errors; and checkpoints
written by either package resuming in the other, with parameters, aux,
optimizer states and the cursor equal (bit for bit: the files are the same
bytes). A run resumed in the other package continues within ``rtol=1e-4,
atol=1e-5`` of an uninterrupted run (XLA:CPU and PyTorch round the MLP's
float32 products differently).
"""
import json
import logging
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data=data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(data=net, act_type="relu")
    net = pkg.sym.FullyConnected(data=net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def _bn_mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
    net = pkg.sym.BatchNorm(data=net, name="bn1")
    net = pkg.sym.Activation(data=net, act_type="relu")
    net = pkg.sym.FullyConnected(data=net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def _toy_data(n=128, dim=10, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    w = rng.normal(size=(dim, classes)).astype(np.float32)
    y = np.argmax(X @ w, axis=1).astype(np.float32)
    return X, y


def _opt_params(pkg):
    return {"learning_rate": 0.1, "momentum": 0.9,
            "lr_scheduler": pkg.lr_scheduler.FactorScheduler(step=5,
                                                             factor=0.5)}


# ---------------------------------------------------------------------------
# the subprocess worker (python tests/test_torch_checkpoint.py PREFIX OUT K)
# ---------------------------------------------------------------------------

def _worker(prefix, out_npz, k):
    """Train the MLP over 2 epochs of 16 batches with checkpoints every
    ``RESUME_WORKER_CKPT_EVERY`` batches (4) and ``resume="auto"``, printing
    ``BATCH e.n`` after every dispatch (paced by ``RESUME_WORKER_PACE``
    seconds) and writing the final parameters to ``out_npz``. With
    ``RESUME_WORKER_TERM_OK`` a graceful preemption prints ``PREEMPTED
    <tag>`` and exits 0."""
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mt
    pace = float(os.environ.get("RESUME_WORKER_PACE", "0") or 0)
    every = int(os.environ.get("RESUME_WORKER_CKPT_EVERY", "4") or 4)
    X, y = _toy_data(256, seed=3)
    mt.random.seed(7)
    train = mt.io.NDArrayIter(X, y, batch_size=16)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())

    def cb(param):
        print("BATCH %d.%d" % (param.epoch, param.nbatch), flush=True)
        time.sleep(pace)

    try:
        mod.fit(train, num_epoch=2, steps_per_dispatch=k,
                optimizer_params=_opt_params(mt), batch_end_callback=cb,
                checkpoint_prefix=prefix, checkpoint_every_n_batches=every,
                resume="auto")
    except mt.TrainingPreemptedError as e:
        if os.environ.get("RESUME_WORKER_TERM_OK"):
            print("PREEMPTED %s" % e.tag, flush=True)
            return
        raise
    arg, _ = mod.get_params()
    np.savez(out_npz, **{n: v.asnumpy() for n, v in arg.items()})
    print("DONE", flush=True)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]))
    sys.exit(0)


import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
import torch  # noqa: E402
from mxnet_tpu.model import CheckpointManager as JCheckpointManager  # noqa
from mxnet_tpu_torch import faults  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.model import (AsyncCheckpointWriter,  # noqa: E402
                                   CheckpointManager, atomic_write_bytes,
                                   load_checkpoint, save_checkpoint)
from mxnet_tpu_torch.train_step import TrainStep  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


class _Interrupt(Exception):
    pass


def _run_fit(X, y, k, num_epoch=2, interrupt_after=None, prefix=None,
             resume=None, every=4, pkg=mt, asyn=None):
    """One deterministic training run; returns the final arg params as
    numpy. ``interrupt_after`` simulates a kill after that many batches."""
    pkg.random.seed(3)
    train = pkg.io.NDArrayIter(X, y, batch_size=16)
    n_per_epoch = X.shape[0] // 16
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    cb = None
    if interrupt_after is not None:
        def cb(p):
            if p.epoch * n_per_epoch + p.nbatch + 1 >= interrupt_after:
                raise _Interrupt()
    kw = {} if asyn is None else {"checkpoint_async": asyn}
    try:
        mod.fit(train, num_epoch=num_epoch, optimizer_params=_opt_params(pkg),
                batch_end_callback=cb, steps_per_dispatch=k,
                checkpoint_prefix=prefix,
                checkpoint_every_n_batches=every if prefix else None,
                resume=resume, **kw)
    except _Interrupt:
        pass
    arg, _ = mod.get_params()
    return {n: v.asnumpy() for n, v in arg.items()}


def _assert_equal(ref, got):
    assert sorted(ref) == sorted(got)
    for name in ref:
        np.testing.assert_array_equal(ref[name], got[name], err_msg=name)


# -- kill mid-epoch, resume, bitwise ----------------------------------------

@pytest.mark.parametrize("k,asyn", [(1, False), (4, False), (1, True),
                                    (4, True)])
def test_interrupted_resume_bitwise_identical(tmp_path, k, asyn):
    X, y = _toy_data()
    ref = _run_fit(X, y, k)
    prefix = str(tmp_path / "ck")
    _run_fit(X, y, k, interrupt_after=11, prefix=prefix, asyn=asyn)
    got = _run_fit(X, y, k, prefix=prefix, resume="auto", asyn=asyn)
    _assert_equal(ref, got)


@pytest.mark.parametrize("k", [1, 4])
def test_bf16_compute_fit_resumes_bitwise(tmp_path, k):
    """Module(compute_dtype="bfloat16"), the port's own argument: the fused
    step computes in bfloat16 over float32 masters (as bench.py main()
    trains), equals a TrainStep driven by hand, and resumes bit for bit."""
    X, y = _toy_data()

    def run(prefix=None, stop=None, resume=None):
        mt.random.seed(3)
        mod = mt.mod.Module(_mlp(mt), context=mt.cpu(),
                            compute_dtype="bfloat16")

        def cb(p):
            if stop is not None and p.epoch * 8 + p.nbatch + 1 >= stop:
                raise _Interrupt()
        try:
            mod.fit(mt.io.NDArrayIter(X, y, batch_size=16), num_epoch=2,
                    optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                    initializer=mt.initializer.Xavier(),
                    batch_end_callback=cb, steps_per_dispatch=k,
                    checkpoint_prefix=prefix,
                    checkpoint_every_n_batches=4 if prefix else None,
                    resume=resume)
        except _Interrupt:
            pass
        return mod

    ref = run()
    assert ref._fused.compute_dtype == torch.bfloat16
    assert all(v.dtype == torch.float32
               for v in ref._fused_state["params"].values())
    # the same steps by hand
    mt.random.seed(3)
    hand = mt.mod.Module(_mlp(mt), context=mt.cpu())
    it = mt.io.NDArrayIter(X, y, batch_size=16)
    hand.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    hand.init_params(initializer=mt.initializer.Xavier())
    arg, aux = hand.get_params()
    step = TrainStep(_mlp(mt), optimizer="sgd", learning_rate=0.1,
                     momentum=0.9, rescale_grad=1.0 / 16,
                     compute_dtype="bfloat16", device="cpu")
    st = {"params": {n: v.data.clone() for n, v in arg.items()}, "aux": {},
          "opt": {n: torch.zeros_like(v.data) for n, v in arg.items()},
          "step": torch.zeros((), dtype=torch.int32)}
    for _ in range(2):
        it.reset()
        for batch in it:
            step.step(st, {"data": batch.data[0].data,
                           "softmax_label": batch.label[0].data})
    for n, v in ref.get_params()[0].items():
        assert torch.equal(v.data, st["params"][n]), n
    run(str(tmp_path / "ck"), stop=7)
    got = run(str(tmp_path / "ck"), resume="auto")
    for n, v in ref.get_params()[0].items():
        np.testing.assert_array_equal(got.get_params()[0][n].asnumpy(),
                                      v.asnumpy(), err_msg=n)


def test_resume_after_k_change_trains_tail_per_step(tmp_path):
    # the checkpoint cuts a superbatch of the new k: its tail trains per step
    # and the run equals the uninterrupted k=1 run bit for bit
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    ref = _run_fit(X, y, 1)
    _run_fit(X, y, 1, interrupt_after=10, prefix=prefix, every=3)
    got = _run_fit(X, y, 4, prefix=prefix, resume="auto", every=3)
    assert all(np.isfinite(v).all() for v in got.values())
    st = CheckpointManager(prefix).load_latest()
    assert (st.epoch, st.batches_done) == (2, 0)
    for name in ref:
        np.testing.assert_allclose(ref[name], got[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_resume_auto_without_checkpoint_starts_fresh(tmp_path):
    X, y = _toy_data()
    ref = _run_fit(X, y, 1)
    got = _run_fit(X, y, 1, prefix=str(tmp_path / "never-written"),
                   resume="auto")
    _assert_equal(ref, got)


def test_resume_requires_prefix():
    X, y = _toy_data(32)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    train = mt.io.NDArrayIter(X, y, batch_size=16)
    with pytest.raises(MXNetError, match="checkpoint_prefix"):
        mod.fit(train, num_epoch=1, resume="auto")
    with pytest.raises(MXNetError, match="resume must be"):
        mod.fit(train, num_epoch=1, resume="latest",
                checkpoint_prefix="/nonexistent/x")


# -- the manager's mechanics --------------------------------------------------

def _trained_module(X, y, prefix=None, every=None, keep=3):
    mt.random.seed(0)
    train = mt.io.NDArrayIter(X, y, batch_size=16)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.fit(train, num_epoch=1, optimizer_params={"learning_rate": 0.1,
                                                  "momentum": 0.9},
            checkpoint_prefix=prefix, checkpoint_every_n_batches=every,
            checkpoint_keep=keep)
    return mod


def test_manifest_records_cursor_clock_and_checksums(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    _trained_module(X, y, prefix=prefix, every=3)
    mgr = CheckpointManager(prefix)
    st = mgr.load_latest()
    assert st.epoch == 1 and st.batches_done == 0   # the epoch-end save
    assert st.num_update == 8 and st.fused_step == 8
    man = json.loads(open(mgr._file(st.tag, "manifest.json")).read())
    assert set(man["files"]) == {"params", "states"}
    for info in man["files"].values():
        assert len(info["sha256"]) == 64 and info["size"] > 0
    assert man["version"] == 2 and man["known_good"] is True
    # the port's random state, under its own key
    assert "rng" not in man and set(man["torch_rng"]) == {"seed",
                                                           "generators"}
    assert st.rng is not None
    assert open(mgr.latest_path).read().strip() == st.tag


def test_retention_prunes_oldest(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    _trained_module(X, y, prefix=prefix, every=2, keep=2)
    mgr = CheckpointManager(prefix, keep=2)
    assert len(mgr.list_tags()) == 2          # 5 saves, 2 kept
    data_files = [f for f in os.listdir(tmp_path)
                  if f.endswith((".params", ".states"))]
    assert len(data_files) == 4


def test_corrupt_newest_falls_back_to_previous(tmp_path, caplog):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    _trained_module(X, y, prefix=prefix, every=3)
    mgr = CheckpointManager(prefix)
    tags = mgr.list_tags()
    params_f = mgr._file(tags[-1], "params")
    with open(params_f, "r+b") as f:
        f.truncate(os.path.getsize(params_f) // 2)
    with caplog.at_level(logging.WARNING):
        st = mgr.load_latest()
    assert st is not None and st.tag == tags[-2]
    assert any("failed validation" in r.message for r in caplog.records)
    # a flipped byte of the same size fails the checksum
    states_f = mgr._file(tags[-2], "states")
    data = bytearray(open(states_f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(states_f, "wb").write(bytes(data))
    with pytest.raises(MXNetError, match="checksum mismatch"):
        mgr.load(tags[-2])


@pytest.mark.parametrize("nth,what", [(6, "params"), (7, "states")])
def test_injected_torn_write_detected_and_skipped(tmp_path, nth, what):
    # write order a mid-epoch save: params, states, manifest, latest; the
    # first also writes symbol.json third, so call 6 is the second save's
    # params and call 7 its states
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    faults.inject("checkpoint.write", nth=nth, kind="truncate")
    _trained_module(X, y, prefix=prefix, every=2, keep=10)
    faults.clear()
    mgr = CheckpointManager(prefix)
    torn = mgr.list_tags()[1]
    with pytest.raises(MXNetError, match="truncated|checksum"):
        mgr.load(torn)
    st = mgr.load_latest()
    assert st is not None and st.tag != torn


def test_checkpoint_write_abort_preserves_previous(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    _trained_module(X, y, prefix=prefix, every=4)
    mgr = CheckpointManager(prefix)
    before = mgr.load_latest()
    mod2 = _trained_module(X, y)
    faults.inject("checkpoint.write.mid", nth=1, kind="raise")
    with pytest.raises(faults.InjectedFault):
        mgr.save(mod2, 9, 0)
    faults.clear()
    assert mgr.load_latest().tag == before.tag


def test_disk_full_mid_write_actionable_and_no_litter(tmp_path):
    path = str(tmp_path / "x.params")
    atomic_write_bytes(path, b"generation-1")
    faults.inject("ckpt.disk_full", nth=1, kind="enospc")
    with pytest.raises(MXNetError) as ei:
        atomic_write_bytes(path, b"generation-2-never-lands")
    faults.clear()
    msg = str(ei.value)
    assert "no space left on device" in msg and "ENOSPC" in msg
    assert path in msg and "free disk space" in msg
    assert open(path, "rb").read() == b"generation-1"
    assert [f for f in os.listdir(str(tmp_path)) if ".tmp" in f] == []
    atomic_write_bytes(path, b"generation-2")
    assert open(path, "rb").read() == b"generation-2"


def test_disk_full_during_manager_save_keeps_previous_generation(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    _trained_module(X, y, prefix=prefix, every=4)
    mgr = CheckpointManager(prefix)
    before = mgr.load_latest()
    mod2 = _trained_module(X, y)
    faults.inject("ckpt.disk_full", nth=1, kind="enospc")
    with pytest.raises(MXNetError, match="no space left on device"):
        mgr.save(mod2, 9, 0)
    faults.clear()
    assert mgr.load_latest().tag == before.tag
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


def test_load_latest_prefers_newer_tag_over_stale_pointer(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    _trained_module(X, y, prefix=prefix, every=3)
    mgr = CheckpointManager(prefix)
    tags = mgr.list_tags()
    atomic_write_bytes(mgr.latest_path, tags[0].encode())
    assert mgr.load_latest().tag == tags[-1]


def test_checkpoint_prefix_with_glob_chars(tmp_path):
    X, y = _toy_data()
    d = tmp_path / "run[1]"
    d.mkdir()
    prefix = str(d / "ck")
    _trained_module(X, y, prefix=prefix, every=4)
    mgr = CheckpointManager(prefix)
    assert mgr.list_tags(), "glob chars in prefix must not disable resume"
    assert mgr.load_latest() is not None


def test_export_and_import_blob_round_trip(tmp_path):
    X, y = _toy_data()
    src = CheckpointManager(str(tmp_path / "a" / "ck"))
    _trained_module(X, y, prefix=src, every=4)
    want = src.load_latest()
    dst = CheckpointManager(str(tmp_path / "b" / "ck"))
    assert dst.export_latest() == b""
    tag = dst.import_blob(src.export_latest())
    got = dst.load_latest()
    assert tag == got.tag == want.tag
    for n, v in want.arg_params.items():
        np.testing.assert_array_equal(got.arg_params[n].asnumpy(),
                                      v.asnumpy())
    assert os.path.exists(str(tmp_path / "b" / "ck-symbol.json"))


# -- legacy checkpoint API ----------------------------------------------------

def test_load_checkpoint_rejects_malformed_and_unknown_keys(tmp_path):
    prefix = str(tmp_path / "model")
    w = mt.nd.ones((2, 2), ctx=mt.cpu())
    save_checkpoint(prefix, 1, _mlp(mt), {"fc1_weight": w}, {})
    mt.nd.save("%s-0001.params" % prefix, {"nonsense-key": w})
    with pytest.raises(MXNetError) as ei:
        load_checkpoint(prefix, 1)
    assert "nonsense-key" in str(ei.value)
    mt.nd.save("%s-0001.params" % prefix, {"grad:fc1_weight": w})
    with pytest.raises(MXNetError, match="unknown prefix 'grad'"):
        load_checkpoint(prefix, 1)


def test_module_load_states_errors_actionable(tmp_path):
    X, y = _toy_data(32)
    mod = _trained_module(X, y)
    with pytest.raises(MXNetError, match="save_optimizer_states"):
        mod.load_optimizer_states(str(tmp_path / "missing.states"))
    fname = str(tmp_path / "t.states")
    mod.save_optimizer_states(fname)
    with open(fname, "r+b") as f:
        f.truncate(5)
    with pytest.raises(MXNetError, match="corrupt or truncated"):
        mod.load_optimizer_states(fname)


def test_restore_trainer_clock_reaches_kvstore_updater():
    X, y = _toy_data(32)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    it = mt.io.NDArrayIter(X, y, batch_size=16)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    kv = mt.kvstore.create("local")
    kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.1))
    mod._kvstore = kv
    mod._update_on_kvstore = True
    mod._optimizer = mt.optimizer.create("sgd", learning_rate=0.1)
    mod.optimizer_initialized = True
    mod._restore_trainer_clock(42)
    assert mod._optimizer.num_update == 42
    assert kv._updater.optimizer.num_update == 42
    assert kv._updater.optimizer.begin_num_update == 42


# -- the async writer ---------------------------------------------------------

def test_async_save_sheds_while_busy_and_drains(tmp_path):
    X, y = _toy_data()
    mod = _trained_module(X, y)
    w = AsyncCheckpointWriter()
    mgr = CheckpointManager(str(tmp_path / "ck"), async_writer=w)
    faults.inject("ckpt.async_write", nth=1, kind="delay", delay=0.5)
    assert mgr.save(mod, 1, 4) == "e0001-b00000004"
    assert w.busy()
    assert mgr.save(mod, 1, 8) is None                 # shed, counted
    assert w.skipped == 1
    assert mgr.drain() is True
    assert w.written == 1 and not w.busy()
    assert mgr.list_tags() == ["e0001-b00000004"]
    # the async bytes are the synchronous save's
    sync = CheckpointManager(str(tmp_path / "sync"))
    sync.save(mod, 1, 4)
    for suffix in ("params", "states"):
        a = open(mgr._file("e0001-b00000004", suffix), "rb").read()
        b = open(sync._file("e0001-b00000004", suffix), "rb").read()
        assert a == b, suffix
    w.close()
    with pytest.raises(MXNetError, match="closed"):
        w.submit(lambda: None)


def test_async_snapshot_is_decoupled_from_later_updates(tmp_path):
    # the snapshot is taken before save returns: training on while the
    # writer stalls does not reach the checkpoint
    X, y = _toy_data()
    mod = _trained_module(X, y)
    want = {n: v.asnumpy().copy() for n, v in mod.get_params()[0].items()}
    w = AsyncCheckpointWriter()
    mgr = CheckpointManager(str(tmp_path / "ck"), async_writer=w)
    faults.inject("ckpt.async_write", nth=1, kind="delay", delay=0.3)
    mgr.save(mod, 1, 4)
    train = mt.io.NDArrayIter(X, y, batch_size=16)
    for batch in train:
        assert mod._try_fused_fit_step(batch)
    assert mgr.drain()
    st = mgr.load_latest()
    for n, v in want.items():
        np.testing.assert_array_equal(st.arg_params[n].asnumpy(), v)
    w.close()


def test_async_writer_error_and_death_keep_the_previous_generation(tmp_path):
    X, y = _toy_data()
    mod = _trained_module(X, y)
    w = AsyncCheckpointWriter()
    mgr = CheckpointManager(str(tmp_path / "ck"), async_writer=w)
    mgr.save(mod, 1, 2)
    assert mgr.drain()
    faults.inject("ckpt.async_write", nth=1, kind="raise")
    mgr.save(mod, 1, 4)
    assert mgr.drain() is True and w.errors == 1
    faults.inject("ckpt.async_die", nth=1, kind="die")
    mgr.save(mod, 1, 6)
    assert mgr.drain() is False                        # the job is lost
    assert w.errors == 2
    assert mgr.load_latest().tag == "e0001-b00000002"
    mgr.save(mod, 1, 8)                                # a new thread
    assert mgr.drain() and w.restarts == 1 and w.written == 2
    assert mgr.load_latest().tag == "e0001-b00000008"
    w.close()


def test_fit_closes_its_writer_and_counts_skips(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    mgr = CheckpointManager(prefix, keep=10)
    faults.inject("ckpt.async_write", nth=1, kind="delay", delay=0.4)
    mt.random.seed(0)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(X, y, batch_size=16), num_epoch=1,
            optimizer_params={"learning_rate": 0.1},
            checkpoint_prefix=mgr, checkpoint_every_n_batches=1,
            checkpoint_async=True)
    assert mgr.async_writer is None
    w = mgr.last_async_writer
    assert w.skipped >= 1 and w.written >= 2 and not w.busy()
    assert mgr.load_latest().tag == "e0001-b00000000"
    assert mgr.save_time > 0


# -- FeedForward --------------------------------------------------------------

def test_feedforward_save_load_epoch_none(tmp_path):
    X, y = _toy_data(64)
    model = mt.model.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=2,
                                 numpy_batch_size=16, learning_rate=0.1)
    model.fit(X, y)
    prefix = str(tmp_path / "ff")
    model.save(prefix)
    assert os.path.exists("%s-0002.params" % prefix)
    loaded = mt.model.FeedForward.load(prefix, 2, ctx=mt.cpu())
    assert loaded.begin_epoch == 2
    for n, v in model.arg_params.items():
        np.testing.assert_array_equal(v.asnumpy(),
                                      loaded.arg_params[n].asnumpy())
    # the JAX package opens the same files
    _, jarg, _ = mx.model.load_checkpoint(prefix, 2)
    for n, v in model.arg_params.items():
        np.testing.assert_array_equal(v.asnumpy(), jarg[n].asnumpy())


def test_feedforward_save_load_with_aux_params_and_score(tmp_path):
    X, y = _toy_data(64)
    model = mt.model.FeedForward(_bn_mlp(mt), ctx=mt.cpu(), num_epoch=1,
                                 numpy_batch_size=16, learning_rate=0.05)
    model.fit(X, y)
    assert model.aux_params
    assert 0.0 <= model.score(X, y) <= 1.0
    prefix = str(tmp_path / "ffbn")
    model.save(prefix, epoch=5)
    loaded = mt.model.FeedForward.load(prefix, 5, ctx=mt.cpu())
    assert sorted(loaded.aux_params) == sorted(model.aux_params)
    pred = loaded.predict(X[:16])
    assert pred.shape == (16, 4)
    np.testing.assert_array_equal(pred, model.predict(X[:16]))


def test_feedforward_save_epoch_none_without_num_epoch_asserts(tmp_path):
    model = mt.model.FeedForward(_mlp(mt), ctx=mt.cpu())
    with pytest.raises(AssertionError):
        model.save(str(tmp_path / "ff"))
    with pytest.raises(MXNetError, match="fit or predict first"):
        model.score(*_toy_data(16))


def test_feedforward_predict_missing_weight_or_aux_raises(tmp_path):
    X, y = _toy_data(64)
    model = mt.model.FeedForward(_bn_mlp(mt), ctx=mt.cpu(), num_epoch=1,
                                 numpy_batch_size=16, learning_rate=0.1)
    model.fit(X, y)
    prefix = str(tmp_path / "ff")
    model.save(prefix, epoch=1)
    loaded = mt.model.FeedForward.load(prefix, 1, ctx=mt.cpu())
    del loaded.arg_params["fc2_weight"]
    with pytest.raises(MXNetError, match="fc2_weight"):
        loaded.predict(X[:16])
    loaded = mt.model.FeedForward.load(prefix, 1, ctx=mt.cpu())
    loaded.aux_params = {}
    with pytest.raises(MXNetError, match="bn1_moving"):
        loaded.predict(X[:16])


def test_feedforward_create_matches_jax():
    X, y = _toy_data(64)
    mx.random.seed(0)
    mt.random.seed(0)
    init = mx.initializer.Constant(0.01)
    jm = mx.model.FeedForward.create(_mlp(mx), X, y, ctx=mx.cpu(),
                                     num_epoch=1, numpy_batch_size=64,
                                     learning_rate=0.1, initializer=init)
    tm = mt.model.FeedForward.create(
        _mlp(mt), X, y, ctx=mt.cpu(), num_epoch=1, numpy_batch_size=64,
        learning_rate=0.1, initializer=mt.initializer.Constant(0.01))
    # one batch of all 64 rows: the shuffle cannot reorder the gradient sum
    for n, v in jm.arg_params.items():
        np.testing.assert_allclose(tm.arg_params[n].asnumpy(), v.asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


# -- the real thing: SIGKILL and SIGTERM a training process -------------------

def _launch(prefix, out, k, **env):
    full = dict(os.environ, RESUME_WORKER_PACE="0.02")
    full.update(env)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), prefix, out, str(k)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=full, cwd=ROOT)


def test_sigkill_and_resume_bitwise_identical(tmp_path):
    k = 2
    ref_out = str(tmp_path / "ref.npz")
    p = _launch(str(tmp_path / "ref-ck"), ref_out, k, RESUME_WORKER_PACE="0")
    assert p.wait(timeout=300) == 0, p.stdout.read()

    prefix = str(tmp_path / "ck")
    out = str(tmp_path / "resumed.npz")
    p = _launch(prefix, out, k)
    killed = False
    for line in p.stdout:
        if line.startswith("BATCH 1."):
            os.kill(p.pid, signal.SIGKILL)
            killed = True
            break
    p.wait(timeout=60)
    assert killed, "worker finished before it could be killed"
    assert not os.path.exists(out)
    mgr = CheckpointManager(prefix)
    st = mgr.load_latest()
    assert st is not None and st.known_good is True and st.epoch >= 1

    p = _launch(prefix, out, k, RESUME_WORKER_PACE="0")
    assert p.wait(timeout=300) == 0, p.stdout.read()
    ref, got = np.load(ref_out), np.load(out)
    _assert_equal({n: ref[n] for n in ref.files},
                  {n: got[n] for n in got.files})


def test_sigterm_graceful_preempt_resumes_from_newer_checkpoint(tmp_path):
    """SIGTERM mid-epoch drains, seals an emergency checkpoint at the exact
    cursor and exits through TrainingPreemptedError; cadence saves are off,
    so the only mid-epoch tag is the emergency one, and the relaunch
    resumes from it to the uninterrupted run's parameters, bit for bit."""
    env = dict(RESUME_WORKER_TERM_OK="1", RESUME_WORKER_CKPT_EVERY="1000")
    ref_out = str(tmp_path / "ref.npz")
    p = _launch(str(tmp_path / "ref-ck"), ref_out, 2, RESUME_WORKER_PACE="0",
                **env)
    assert p.wait(timeout=300) == 0, p.stdout.read()

    prefix = str(tmp_path / "ck")
    out = str(tmp_path / "resumed.npz")
    p = _launch(prefix, out, 2, **env)
    termed = False
    tail = []
    for line in p.stdout:
        tail.append(line)
        if not termed and line.startswith("BATCH 1."):
            os.kill(p.pid, signal.SIGTERM)
            termed = True
        elif line.startswith("PREEMPTED"):
            break
    assert termed, "worker finished before it could be preempted"
    assert p.wait(timeout=60) == 0, "".join(tail)
    assert not os.path.exists(out)
    st = CheckpointManager(prefix).load_latest()
    assert st is not None and (st.epoch, st.batches_done) > (1, 0), st.tag
    assert st.tag in [l for l in tail if l.startswith("PREEMPTED")][0]

    p = _launch(prefix, out, 2, RESUME_WORKER_PACE="0", **env)
    assert p.wait(timeout=300) == 0, p.stdout.read()
    ref, got = np.load(ref_out), np.load(out)
    _assert_equal({n: ref[n] for n in ref.files},
                  {n: got[n] for n in got.files})


# -- across the two packages --------------------------------------------------

def _host(d):
    return {n: v.asnumpy() for n, v in d.items()}


def _states(fname):
    import pickle
    with open(fname, "rb") as f:
        return pickle.loads(f.read())


def _assert_same_checkpoint(jst, tst):
    assert (tst.tag, tst.epoch, tst.batches_done, tst.num_update,
            tst.fused_step) == (jst.tag, jst.epoch, jst.batches_done,
                                jst.num_update, jst.fused_step)
    assert tst.known_good is jst.known_good is True
    assert tst.metric_state == jst.metric_state
    _assert_equal(_host(jst.arg_params), _host(tst.arg_params))
    _assert_equal(_host(jst.aux_params), _host(tst.aux_params))
    js, ts = _states(jst.opt_states_file), _states(tst.opt_states_file)
    assert sorted(js) == sorted(ts)
    for i in js:
        np.testing.assert_array_equal(np.asarray(js[i]), np.asarray(ts[i]))


def test_jax_checkpoint_resumes_in_the_port(tmp_path, caplog):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    ref = _run_fit(X, y, 2, pkg=mx)
    _run_fit(X, y, 2, interrupt_after=11, prefix=prefix, pkg=mx)
    jst = JCheckpointManager(prefix).load_latest()
    tst = CheckpointManager(prefix).load_latest()
    assert jst.tag == "e0001-b00000000" or jst.batches_done > 0
    _assert_same_checkpoint(jst, tst)
    assert "data" in tst.rng                  # the JAX package's key
    with caplog.at_level(logging.WARNING):
        got = _run_fit(X, y, 2, prefix=prefix, resume="auto")
    assert any("JAX package's random key" in r.message
               for r in caplog.records)
    for n in ref:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    ref = _run_fit(X, y, 2)
    _run_fit(X, y, 2, interrupt_after=11, prefix=prefix)
    tst = CheckpointManager(prefix).load_latest()
    jst = JCheckpointManager(prefix).load_latest()
    _assert_same_checkpoint(jst, tst)
    assert jst.rng is None                    # the port's state is its own
    got = _run_fit(X, y, 2, prefix=prefix, resume="auto", pkg=mx)
    for n in ref:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_metric_partial_sums_cross_both_ways(tmp_path):
    # a mid-epoch checkpoint under device sums carries the metric's partial
    # sums; each package replays the other's
    X, y = _toy_data()
    for writer, reader in ((mx, mt), (mt, mx)):
        prefix = str(tmp_path / writer.__name__ / "ck")
        _run_fit(X, y, 2, interrupt_after=7, prefix=prefix, pkg=writer)
        mgr = (CheckpointManager if reader is mt else JCheckpointManager)
        st = mgr(prefix).load_latest()
        assert st.batches_done == 4 and st.metric_state is not None
        m = reader.metric.create("acc")
        reader.mod.Module._restore_metric_state(m, st.metric_state)
        assert [m.sum_metric, m.num_inst] == st.metric_state
        assert m.num_inst == 4 * 16
