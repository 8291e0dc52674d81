"""``mxnet_tpu_torch.c_api`` against ``mxnet_tpu.c_api`` on the CPU.

Every public ``MX*`` function of the JAX package's module exists in the
port's with the same signature (one case each). Then each family runs
through both packages' ``c_api`` at ``dev_type`` 1 on the same numpy
inputs, made from a seed, and the answers are compared:

- NDArray create, copy, slice, reshape, save and load: exactly;
- imperative invoke (new outputs and in place) and the Func* registry:
  ``rtol=1e-5`` (XLA:CPU and PyTorch may round a transcendental in another
  last bit);
- Symbol compose, JSON, infer shape and type, attributes, printing:
  equal;
- the Executor of ``src/capi/smoke_client.c``'s net (FullyConnected and
  LinearRegressionOutput), forward and backward, and the monitor
  callback, called back into C (``ctypes``): ``rtol=1e-5``;
- the KVStore with a C updater (``ctypes``): ``rtol=1e-6``;
- MXPred create, reshape and partial output: ``rtol=1e-5``;
- DataIter (CSVIter), RecordIO, autograd and the profiler: exactly, the
  autograd gradient ``rtol=1e-6``;
- the error contract: status -1 and the same message up to the package's
  name.

``MXRtcCreate`` builds the decorated CUDA source that
``tests/test_torch_rtc.py`` holds, Python source (the JAX package's
Pallas body) raises, and ``MXRtcPush`` raises on CPU arrays; ``dev_type``
2 raises without CUDA. The port's calls run inside ``with mt.cpu():``, the
ABI's default context for calls that name no device.
"""
import ctypes
import inspect
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import c_api as jc
from mxnet_tpu_torch import c_api as tc

PKGS = {"jax": (jc, mx), "torch": (tc, mt)}
F32 = dict(rtol=1e-5, atol=1e-6)


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    with mt.cpu():
        yield


def _public(mod):
    return sorted(n for n in dir(mod) if n.startswith("MX")
                  and inspect.isfunction(getattr(mod, n)))


def _inner(fn):
    """The function a ``_capi`` wrapper calls: the port's sets
    ``__wrapped__``; the JAX package's closes over it."""
    if hasattr(fn, "__wrapped__"):
        return fn.__wrapped__
    for cell in fn.__closure__ or ():
        v = cell.cell_contents
        if inspect.isfunction(v) and v.__name__ == fn.__name__:
            return v
    return fn


def test_the_port_has_every_function():
    assert _public(tc) == _public(jc)
    assert len(_public(jc)) == 129


@pytest.mark.parametrize("name", _public(jc))
def test_signature_matches_jax(name):
    assert (inspect.signature(_inner(getattr(tc, name)))
            == inspect.signature(_inner(getattr(jc, name))))


def ok(res, capi):
    st, val = res
    assert st == 0, capi.MXGetLastError()
    return val


def both(scenario):
    """Run ``scenario(capi, pkg)`` through each package; returns
    {"jax": ..., "torch": ...}."""
    return {name: scenario(capi, pkg) for name, (capi, pkg) in PKGS.items()}


# -- NDArray ------------------------------------------------------------------

def test_ndarray_family_exact(tmp_path):
    x = _rng("nd").standard_normal((4, 6)).astype(np.float32)

    def scenario(c, pkg):
        h = ok(c.MXNDArrayCreate((4, 6), 1, 0), c)
        ok(c.MXNDArraySyncCopyFromCPU(h, x), c)
        hb = ok(c.MXNDArrayCreateEx((3,), 1, 0, 0, 4), c)
        ok(c.MXNDArraySyncCopyFromBytes(hb, np.arange(3, dtype=np.int32)
                                        .tobytes(), "int32"), c)
        hn = ok(c.MXNDArrayCreateFromNumpy(x * 2), c)
        sl = ok(c.MXNDArraySlice(h, 1, 3), c)
        rs = ok(c.MXNDArrayReshape(h, (6, 4)), c)
        at = ok(c.MXNDArrayAt(h, 2), c)
        f = str(tmp_path / ("%s.params" % pkg.__name__))
        ok(c.MXNDArraySave(f, [h, hn], ["a", "b"]), c)
        loaded, keys = ok(c.MXNDArrayLoad(f), c)
        raw = ok(c.MXNDArraySaveRawBytes(sl), c)
        back = ok(c.MXNDArrayLoadFromRawBytes(raw), c)
        ok(c.MXNDArrayWaitToRead(h), c)
        ok(c.MXNDArrayWaitToWrite(h), c)
        ok(c.MXNDArrayWaitAll(), c)
        out = {
            "shape": ok(c.MXNDArrayGetShape(rs), c),
            "dtype": [ok(c.MXNDArrayGetDType(a), c) for a in (h, hb)],
            "ctx": ok(c.MXNDArrayGetContext(h), c),
            "size": ok(c.MXNDArraySize(h), c),
            "copy": ok(c.MXNDArraySyncCopyToCPU(h), c),
            "bytes": ok(c.MXNDArraySyncCopyToBytes(hb), c),
            "data": ok(c.MXNDArrayGetData(h), c),
            "slice": ok(c.MXNDArraySyncCopyToCPU(sl), c),
            "reshape": ok(c.MXNDArraySyncCopyToCPU(rs), c),
            "at": ok(c.MXNDArraySyncCopyToCPU(at), c),
            "keys": keys,
            "loaded": [ok(c.MXNDArraySyncCopyToCPU(a), c) for a in loaded],
            "raw": raw,
            "back": ok(c.MXNDArraySyncCopyToCPU(back), c),
            "none": ok(c.MXNDArrayGetShape(ok(c.MXNDArrayCreateNone(), c)),
                       c)}
        for a in [h, hb, hn, sl, rs, at, back] + loaded:
            ok(c.MXNDArrayFree(a), c)
        return out

    got = both(scenario)
    j, t = got["jax"], got["torch"]
    assert set(j) == set(t)
    for k in j:
        if isinstance(j[k], list):
            assert len(j[k]) == len(t[k])
            for a, b in zip(j[k], t[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        elif isinstance(j[k], np.ndarray):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        else:
            assert t[k] == j[k], k
    assert t["ctx"] == (1, 0)
    assert t["data"] == x.tobytes()     # a host copy of the bytes


# -- imperative invoke and the Func* registry ---------------------------------

def test_imperative_and_func_registry_against_jax():
    r = _rng("inv")
    a = r.standard_normal((3, 4)).astype(np.float32)
    b = r.standard_normal((3, 4)).astype(np.float32)

    def scenario(c, pkg):
        ha = ok(c.MXNDArrayCreateFromNumpy(a), c)
        hb = ok(c.MXNDArrayCreateFromNumpy(b), c)
        outs = {}
        (h,) = ok(c.MXImperativeInvoke("elemwise_add", [ha, hb], {}), c)
        outs["add"] = ok(c.MXNDArraySyncCopyToCPU(h), c)
        (h,) = ok(c.MXImperativeInvoke("_plus_scalar", [ha],
                                       {"scalar": "1.5"}), c)
        outs["plus_scalar"] = ok(c.MXNDArraySyncCopyToCPU(h), c)
        hs = ok(c.MXImperativeInvoke("SliceChannel", [ha],
                                     {"num_outputs": "2", "axis": "1"}), c)
        outs["split"] = [ok(c.MXNDArraySyncCopyToCPU(x), c) for x in hs]
        tgt = ok(c.MXNDArrayCreate((3, 4), 1, 0), c)
        assert ok(c.MXImperativeInvokeInPlace("exp", [ha], {}, [tgt]), c) \
            == 1
        outs["exp_inplace"] = ok(c.MXNDArraySyncCopyToCPU(tgt), c)
        fns = ok(c.MXListFunctions(), c)
        fh = ok(c.MXGetFunction("elemwise_mul"), c)
        info = ok(c.MXFuncGetInfo(fh), c)
        desc = ok(c.MXFuncDescribe(fh), c)
        mut = ok(c.MXNDArrayCreate((3, 4), 1, 0), c)
        ok(c.MXFuncInvoke(fh, [ha, hb], [], [mut]), c)
        outs["func_mul"] = ok(c.MXNDArraySyncCopyToCPU(mut), c)
        fs = ok(c.MXGetFunction("_mul_scalar"), c)
        ok(c.MXFuncInvokeEx(fs, [ha], [3.0], [mut], [], []), c)
        outs["func_mul_scalar"] = ok(c.MXNDArraySyncCopyToCPU(mut), c)
        return outs, (len(fns), fh, info, desc,
                      ok(c.MXListAllOpNames(), c))

    got = both(scenario)
    (jo, jm), (to, tm) = got["jax"], got["torch"]
    assert tm == jm
    for k in jo:
        np.testing.assert_allclose(np.asarray(to[k]), np.asarray(jo[k]),
                                   err_msg=k, **F32)


# -- Symbol -------------------------------------------------------------------

def _compose(c):
    """smoke_client.c's net, composed through the ABI."""
    data = ok(c.MXSymbolCreateVariable("data"), c)
    label = ok(c.MXSymbolCreateVariable("label"), c)
    fc = ok(c.MXSymbolCreateAtomicSymbol("FullyConnected", ["num_hidden"],
                                         ["1"]), c)
    ok(c.MXSymbolCompose(fc, "fc", [data]), c)
    lro = ok(c.MXSymbolCreateAtomicSymbol("LinearRegressionOutput", [], []),
             c)
    ok(c.MXSymbolCompose(lro, "lro", [fc, label], ["data", "label"]), c)
    return lro, fc


def test_symbol_family_against_jax(tmp_path):
    def scenario(c, pkg):
        lro, fc = _compose(c)
        js = ok(c.MXSymbolSaveToJSON(lro), c)
        back = ok(c.MXSymbolCreateFromJSON(js), c)
        f = str(tmp_path / ("%s.json" % pkg.__name__))
        ok(c.MXSymbolSaveToFile(lro, f), c)
        from_file = ok(c.MXSymbolCreateFromFile(f), c)
        ok(c.MXSymbolSetAttr(fc, "ctx_group", "dev1"), c)
        grp = ok(c.MXSymbolCreateGroup([lro, fc]), c)
        internals = ok(c.MXSymbolGetInternals(lro), c)
        cp = ok(c.MXSymbolCopy(lro), c)
        return {
            "json": js,
            "args": [ok(c.MXSymbolListArguments(h), c)
                     for h in (lro, back, from_file, cp)],
            "outputs": ok(c.MXSymbolListOutputs(grp), c),
            "internals": ok(c.MXSymbolListOutputs(internals), c),
            "aux": ok(c.MXSymbolListAuxiliaryStates(lro), c),
            "infer": ok(c.MXSymbolInferShape(lro, ["data"], [(5, 2)]), c),
            "partial": ok(c.MXSymbolInferShapePartial(lro, ["data"],
                                                      [(5, 2)]), c),
            "type": ok(c.MXSymbolInferType(lro, ["data"], ["float32"]), c),
            "name": ok(c.MXSymbolGetName(fc), c),
            "attr": ok(c.MXSymbolGetAttr(fc, "ctx_group"), c),
            "no_attr": ok(c.MXSymbolGetAttr(fc, "nothing"), c),
            "attrs": ok(c.MXSymbolListAttr(fc), c),
            "shallow": ok(c.MXSymbolListAttrShallow(fc), c),
            "children": ok(c.MXSymbolListOutputs(
                ok(c.MXSymbolGetChildren(lro), c)), c),
            "output1": ok(c.MXSymbolListOutputs(
                ok(c.MXSymbolGetOutput(grp, 1), c)), c),
            "print": ok(c.MXSymbolPrint(lro), c),
            "creators": len(ok(c.MXSymbolListAtomicSymbolCreators(), c)),
            "creator0": ok(c.MXSymbolGetAtomicSymbolName(0), c),
            "info": ok(c.MXSymbolGetAtomicSymbolInfo(
                ok(c.MXGetFunction("Concat"), c)), c),
            "free": ok(c.MXSymbolFree(cp), c)}

    got = both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"]["infer"][1] == [(5, 1)]


# -- Executor and the monitor callback ----------------------------------------

MONITOR = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_void_p)
UPDATER = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_uint64,
                           ctypes.c_uint64, ctypes.c_void_p)


def test_executor_and_monitor_callback_against_jax():
    r = _rng("exec")
    x = r.random((8, 2)).astype(np.float32)
    y = (2 * x[:, 0] - 3 * x[:, 1] + 1).astype(np.float32)
    w = r.standard_normal((1, 2)).astype(np.float32)

    def scenario(c, pkg):
        lro, _ = _compose(c)
        vals = {"data": x, "fc_weight": w, "fc_bias": np.zeros(1, np.float32),
                "label": y}
        names = ok(c.MXSymbolListArguments(lro), c)
        args = [ok(c.MXNDArrayCreateFromNumpy(vals[n]), c) for n in names]
        grads = [ok(c.MXNDArrayCreate(vals[n].shape, 1, 0), c)
                 for n in names]
        seen = []

        @MONITOR
        def monitor(name, handle, closure):
            # called back from the port with a live handle
            seen.append((name.decode(), ok(c.MXNDArrayGetShape(handle), c)))
        ex = ok(c.MXExecutorBind(lro, 1, 0, args, grads), c)
        ok(c.MXExecutorSetMonitorCallback(
            ex, ctypes.cast(monitor, ctypes.c_void_p).value), c)
        ok(c.MXExecutorForward(ex, 1), c)
        ok(c.MXExecutorBackward(ex), c)
        outs = [ok(c.MXNDArraySyncCopyToCPU(h), c)
                for h in ok(c.MXExecutorOutputs(ex), c)]
        g = [ok(c.MXNDArraySyncCopyToCPU(h), c) for h in grads]
        exx = ok(c.MXExecutorBindX(lro, 1, 0, [], [], [], args, grads,
                                   "write"), c)
        exe = ok(c.MXExecutorBindEX(lro, 1, 0, [], [], [], args, grads,
                                    "write", None, exx), c)
        ok(c.MXExecutorForward(exe, 0), c)
        outs2 = [ok(c.MXNDArraySyncCopyToCPU(h), c)
                 for h in ok(c.MXExecutorOutputs(exe), c)]
        text = ok(c.MXExecutorPrint(ex), c)
        for h in (ex, exx, exe):
            ok(c.MXExecutorFree(h), c)
        return outs, g, outs2, sorted(set(seen)), text.splitlines()[1:]

    got = both(scenario)
    (jo, jg, jo2, jseen, jtext), (to, tg, to2, tseen, ttext) = \
        got["jax"], got["torch"]
    for a, b in zip(to + tg + to2, jo + jg + jo2):
        np.testing.assert_allclose(a, b, **F32)
    assert tseen == jseen and tseen
    assert ttext == jtext


# -- KVStore with a C updater -------------------------------------------------

def test_kvstore_with_a_c_updater_against_jax():
    r = _rng("kv")
    w = r.standard_normal((3, 4)).astype(np.float32)
    g = r.standard_normal((3, 4)).astype(np.float32)

    def scenario(c, pkg):
        calls = []

        @UPDATER
        def updater(key, recv, local, closure):
            # local -= 0.1 * recv, through the ABI
            rv = ok(c.MXNDArraySyncCopyToCPU(recv), c)
            lv = ok(c.MXNDArraySyncCopyToCPU(local), c)
            ok(c.MXNDArraySyncCopyFromCPU(local, lv - 0.1 * rv), c)
            calls.append(key)
        kv = ok(c.MXKVStoreCreate("local"), c)
        ok(c.MXKVStoreSetUpdater(kv, ctypes.cast(updater,
                                                 ctypes.c_void_p).value), c)
        hw = ok(c.MXNDArrayCreateFromNumpy(w), c)
        hg = ok(c.MXNDArrayCreateFromNumpy(g), c)
        out = ok(c.MXNDArrayCreate((3, 4), 1, 0), c)
        ok(c.MXKVStoreInit(kv, [3], [hw]), c)
        ok(c.MXKVStorePush(kv, [3], [hg]), c)
        ok(c.MXKVStorePull(kv, [3], [out]), c)
        ok(c.MXKVStoreBarrier(kv), c)
        ok(c.MXKVStoreSetBarrierBeforeExit(kv, 1), c)
        meta = (ok(c.MXKVStoreGetType(kv), c), ok(c.MXKVStoreGetRank(kv), c),
                ok(c.MXKVStoreGetGroupSize(kv), c),
                ok(c.MXKVStoreGetNumDeadNode(kv, 0), c),
                ok(c.MXKVStoreIsWorkerNode(), c),
                ok(c.MXKVStoreIsServerNode(), c),
                ok(c.MXKVStoreIsSchedulerNode(), c))
        ok(c.MXKVStoreRunServer(kv), c)
        ok(c.MXKVStoreFree(kv), c)
        return ok(c.MXNDArraySyncCopyToCPU(out), c), calls, meta

    got = both(scenario)
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-6)
    np.testing.assert_allclose(got["torch"][0], w - 0.1 * g, rtol=1e-6)
    assert got["torch"][1:] == got["jax"][1:] == ([3], (
        "local", 0, 1, 0, 1, 0, 0))


def test_kvstore_command_installs_the_optimizer():
    import pickle

    def scenario(c, pkg):
        kv = ok(c.MXKVStoreCreate("local"), c)
        body = pickle.dumps(pkg.optimizer.create("sgd", learning_rate=0.25))
        ok(c.MXKVStoreSendCommmandToServers(kv, 0, body), c)
        st, _ = c.MXKVStoreSendCommmandToServers(kv, 0, body[:10])
        return c._get(kv)._updater.optimizer.lr, st, \
            c.MXGetLastError().split(":")[0]

    got = both(scenario)
    assert got["torch"] == got["jax"] == (0.25, -1, "MXNetError")


# -- MXPred -------------------------------------------------------------------

def test_pred_create_reshape_partial_against_jax():
    r = _rng("pred")
    params = {"arg:fc1_weight": r.standard_normal((5, 4)).astype(np.float32),
              "arg:fc1_bias": np.zeros(5, np.float32),
              "arg:fc2_weight": r.standard_normal((3, 5)).astype(np.float32),
              "arg:fc2_bias": np.zeros(3, np.float32)}
    x = r.random((2, 4)).astype(np.float32)

    def scenario(c, pkg):
        net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            pkg.sym.Activation(pkg.sym.FullyConnected(
                pkg.sym.Variable("data"), num_hidden=5, name="fc1"),
                act_type="relu", name="relu1"),
            num_hidden=3, name="fc2"), name="softmax")
        blob = pkg.dmlc_serial.dumps(list(params.values()),
                                     list(params.keys()))
        out = {}
        hp = ok(c.MXPredCreate(net.tojson(), blob, 1, 0, ["data"], [(2, 4)]),
                c)
        ok(c.MXPredSetInput(hp, "data", x.tobytes()), c)
        ok(c.MXPredForward(hp), c)
        out["full"] = (ok(c.MXPredGetOutputShape(hp, 0), c),
                       ok(c.MXPredGetOutput(hp, 0), c))
        h6 = ok(c.MXPredReshape(hp, ["data"], [(6, 4)]), c)
        ok(c.MXPredSetInput(h6, "data", np.vstack([x] * 3).tobytes()), c)
        ok(c.MXPredForward(h6), c)
        out["reshaped"] = (ok(c.MXPredGetOutputShape(h6, 0), c),
                           ok(c.MXPredGetOutput(h6, 0), c))
        hpo = ok(c.MXPredCreatePartialOut(net.tojson(), blob, 1, 0, ["data"],
                                          [(2, 4)], ["relu1"]), c)
        ok(c.MXPredSetInput(hpo, "data", x.tobytes()), c)
        ok(c.MXPredForward(hpo), c)
        out["partial"] = (ok(c.MXPredGetOutputShape(hpo, 0), c),
                          ok(c.MXPredGetOutput(hpo, 0), c))
        st, _ = c.MXPredReshape(hp, ["data"], [(6, 9)])
        out["bad_reshape"] = (st, "parameter" in c.MXGetLastError())
        for h in (hp, h6, hpo):
            ok(c.MXPredFree(h), c)
        return out

    got = both(scenario)
    for k in ("full", "reshaped", "partial"):
        (js, jb), (ts, tb) = got["jax"][k], got["torch"][k]
        assert ts == js
        np.testing.assert_allclose(np.frombuffer(tb, np.float32),
                                   np.frombuffer(jb, np.float32), **F32)
    assert got["torch"]["partial"][0] == (2, 5)
    assert got["torch"]["bad_reshape"] == got["jax"]["bad_reshape"] == (
        -1, True)


# -- DataIter, RecordIO, autograd, profiler -----------------------------------

def test_dataiter_recordio_autograd_profiler_against_jax(tmp_path):
    r = _rng("io")
    x = r.random((6, 3)).astype(np.float32)
    y = np.arange(6, dtype=np.float32)
    np.savetxt(str(tmp_path / "d.csv"), x, delimiter=",")
    np.savetxt(str(tmp_path / "l.csv"), y, delimiter=",")

    def scenario(c, pkg):
        name = pkg.__name__
        out = {"iters": [ok(c.MXDataIterGetIterInfo(i), c)[0]
                         for i in ok(c.MXListDataIters(), c)]}
        csv = out["iters"].index("CSVIter")
        it = ok(c.MXDataIterCreateIter(csv, [
            "data_csv", "data_shape", "label_csv", "label_shape",
            "batch_size"], [str(tmp_path / "d.csv"), "(3,)",
                            str(tmp_path / "l.csv"), "(1,)", "4"]), c)
        batches = []
        while ok(c.MXDataIterNext(it), c):
            batches.append((
                ok(c.MXNDArraySyncCopyToCPU(ok(c.MXDataIterGetData(it), c)),
                   c),
                ok(c.MXNDArraySyncCopyToCPU(ok(c.MXDataIterGetLabel(it), c)),
                   c),
                ok(c.MXDataIterGetPadNum(it), c)))
        ok(c.MXDataIterBeforeFirst(it), c)
        assert ok(c.MXDataIterNext(it), c) == 1
        ok(c.MXDataIterFree(it), c)
        out["batches"] = batches
        rec = str(tmp_path / ("%s.rec" % name))
        wh = ok(c.MXRecordIOWriterCreate(rec), c)
        tells = []
        for blob in (b"first", b"", b"\x00third"):
            tells.append(ok(c.MXRecordIOWriterTell(wh), c))
            ok(c.MXRecordIOWriterWriteRecord(wh, blob), c)
        ok(c.MXRecordIOWriterFree(wh), c)
        rh = ok(c.MXRecordIOReaderCreate(rec), c)
        recs = [ok(c.MXRecordIOReaderReadRecord(rh), c) for _ in range(3)]
        ok(c.MXRecordIOReaderSeek(rh, tells[2]), c)
        recs.append(ok(c.MXRecordIOReaderReadRecord(rh), c))
        ok(c.MXRecordIOReaderFree(rh), c)
        out["records"] = (tells, recs)
        hx = ok(c.MXNDArrayCreateFromNumpy(x), c)
        hg = ok(c.MXNDArrayCreate(x.shape, 1, 0), c)
        ok(c.MXAutogradMarkVariables([hx], [hg]), c)
        out["was"] = ok(c.MXAutogradSetIsTraining(1), c)
        (sq,) = ok(c.MXImperativeInvoke("square", [hx], {}), c)
        out["now"] = ok(c.MXAutogradSetIsTraining(0), c)
        ok(c.MXAutogradComputeGradient([sq]), c)
        out["grad"] = ok(c.MXNDArraySyncCopyToCPU(hg), c)
        prof = str(tmp_path / ("%s_profile.json" % name))
        ok(c.MXSetProfilerConfig(0, prof), c)
        ok(c.MXSetProfilerState(1), c)
        ok(c.MXImperativeInvoke("exp", [hx], {}), c)
        ok(c.MXSetProfilerState(0), c)
        ok(c.MXDumpProfile(), c)
        ok(c.MXInitPSEnv(["MXTPU_CAPI_TEST_%s" % name.upper()], ["1"]), c)
        ok(c.MXRandomSeed(3), c)
        ok(c.MXNotifyShutdown(), c)
        out["version"] = ok(c.MXGetVersion(), c)
        return out

    got = both(scenario)
    j, t = got["jax"], got["torch"]
    assert t["iters"] == j["iters"]
    assert len(t["batches"]) == len(j["batches"]) == 2
    for (ta, tl, tp), (ja, jl, jp) in zip(t["batches"], j["batches"]):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp
    assert t["records"] == j["records"]
    assert (t["was"], t["now"], t["version"]) == (j["was"], j["now"],
                                                  j["version"])
    np.testing.assert_allclose(t["grad"], j["grad"], rtol=1e-6)
    np.testing.assert_allclose(t["grad"], 2 * x, rtol=1e-6)
    import os
    assert os.environ.pop("MXTPU_CAPI_TEST_MXNET_TPU_TORCH") == "1"
    os.environ.pop("MXTPU_CAPI_TEST_MXNET_TPU", None)


# -- errors -------------------------------------------------------------------

def _csv_iter(c, tmp):
    path = str(tmp / "x.csv")
    np.savetxt(path, np.ones((2, 1), np.float32), delimiter=",")
    creators = [ok(c.MXDataIterGetIterInfo(i), c)[0]
                for i in ok(c.MXListDataIters(), c)]
    return ok(c.MXDataIterCreateIter(creators.index("CSVIter"),
                                     ["data_csv", "data_shape"],
                                     [path, "(1,)"]), c)


ERRORS = {
    "free handle": lambda c: c.MXNDArrayGetShape(10 ** 9),
    "unknown op": lambda c: c.MXImperativeInvoke("no_such_op", [], {}),
    "unknown function": lambda c: c.MXGetFunction("no_such_function"),
    "bad function handle": lambda c: c.MXFuncGetInfo(10 ** 6),
    "composed twice": lambda c: c.MXSymbolCompose(
        _compose(c)[0], "again", []),
    "symbol grad": lambda c: c.MXSymbolGrad(
        ok(c.MXSymbolCreateVariable("v"), c), ["v"]),
    "no current batch": lambda c, tmp: c.MXDataIterGetData(
        _csv_iter(c, tmp)),
    "custom op register": lambda c: c.MXCustomOpRegister("x", 1),
    "custom op without a creator": lambda c: c.MXCustomOpRegister("x"),
    "pred unknown input": lambda c: c.MXPredSetInput(ok(c.MXPredCreate(
        c._get(_compose(c)[0]).tojson(), b"", 1, 0, ["data"], [(2, 2)]), c),
        "nope", b""),
}


def _prefix(msg):
    """The message up to the package's own name."""
    return msg.split("mxnet_tpu")[0]


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_contract_against_jax(case, tmp_path):
    def scenario(c, pkg):
        fn = ERRORS[case]
        if fn.__code__.co_argcount == 2:
            st, val = fn(c, tmp_path)
        else:
            st, val = fn(c)
        return st, val, _prefix(c.MXGetLastError())

    got = both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == -1 and got["torch"][2]


def test_error_is_thread_local():
    import threading
    st, _ = tc.MXGetFunction("no_such_function")
    assert st == -1
    mine = tc.MXGetLastError()
    seen = []
    t = threading.Thread(target=lambda: seen.append(tc.MXGetLastError()))
    t.start()
    t.join(30)
    assert not t.is_alive() and seen == [""]
    assert tc.MXGetLastError() == mine


# -- devices and Rtc ----------------------------------------------------------

def test_dev_type_two_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st, _ = tc.MXNDArrayCreate((2,), 2, 0)
    assert st == -1 and "CUDA is not available" in tc.MXGetLastError()
    lro, _ = _compose(tc)
    h = ok(tc.MXNDArrayCreate((2, 2), 1, 0), tc)
    st, _ = tc.MXExecutorBind(lro, 2, 0, [h, h, h, h])
    assert st == -1 and "CUDA" in tc.MXGetLastError()


def test_calls_without_a_device_follow_the_default(monkeypatch):
    """Outside any open context (a C client's thread), MXTPU_CAPI_DEVICE
    decides, else gpu(0), which raises without CUDA."""
    import threading
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = {}

    def call(key):
        st, h = tc.MXNDArrayCreateFromNumpy(np.ones(2, np.float32))
        got[key] = (st, tc.MXNDArrayGetContext(h)[1] if st == 0 else
                    tc.MXGetLastError())

    for env in ("cpu", None, "tpu"):
        if env is None:
            monkeypatch.delenv("MXTPU_CAPI_DEVICE", raising=False)
        else:
            monkeypatch.setenv("MXTPU_CAPI_DEVICE", env)
        t = threading.Thread(target=call, args=(env,))
        t.start()
        t.join(60)
        assert not t.is_alive()
    assert got["cpu"] == (0, (1, 0))
    assert got[None][0] == -1 and "CUDA is not available" in got[None][1]
    assert got["tpu"][0] == -1 and "MXTPU_CAPI_DEVICE" in got["tpu"][1]


SCALE_BODY = ("int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
              "if (i < x_dims[0] * x_dims[1]) y[i] = 2.0f * x[i];")


def test_rtc_create_builds_the_decorated_cuda_source():
    hx = ok(tc.MXNDArrayCreateFromNumpy(np.zeros((8, 128), np.float32)), tc)
    hb = ok(tc.MXNDArrayCreateFromNumpy(np.zeros((3,), np.float32)), tc)
    hy = ok(tc.MXNDArrayCreateFromNumpy(np.zeros((8, 128), np.float32)), tc)
    h = ok(tc.MXRtcCreate("scale", ["x", "b"], ["y"], [hx, hb], [hy],
                          SCALE_BODY), tc)
    assert tc._get(h).source == (
        '\nextern "C" __global__ void scale(const float* x,const float* b,'
        'float* y) {\n'
        "const int x_ndim = 2;\n"
        "const int x_dims[] = {8,128};\n"
        "const int b_ndim = 1;\n"
        "const int b_dims[] = {3};\n"
        "const int y_ndim = 2;\n"
        "const int y_dims[] = {8,128};\n"
        + SCALE_BODY + "\n}\n")
    # no CPU fallback: a push on CPU arrays raises
    st, _ = tc.MXRtcPush(h, [hx, hb], [hy], 1, 1, 1, 128, 1, 1)
    assert st == -1 and "card only" in tc.MXGetLastError()
    assert ok(tc.MXRtcFree(h), tc) is None


def test_rtc_create_rejects_python_source():
    """The JAX package's MXRtcCreate takes Python source defining a Pallas
    body; the port takes CUDA source and names the difference."""
    src = "def scale(x_ref, o_ref):\n    o_ref[...] = x_ref[...] * 2\n"
    hx = ok(jc.MXNDArrayCreateFromNumpy(np.ones(4, np.float32)), jc)
    assert jc.MXRtcCreate("scale", ["x"], ["o"], [hx], [hx], src)[0] == 0
    hx = ok(tc.MXNDArrayCreateFromNumpy(np.ones(4, np.float32)), tc)
    st, _ = tc.MXRtcCreate("scale", ["x"], ["o"], [hx], [hx], src)
    assert st == -1
    assert "Pallas body has no meaning on the card" in tc.MXGetLastError()


@pytest.mark.parametrize("value,want", [("1", True), ("0", False),
                                        (None, False)])
def test_enforce_determinism_sets_cudnn_on_load(value, want):
    """A C client cannot reach torch.backends: MXNET_ENFORCE_DETERMINISM=1
    makes the ABI's module select cuDNN's deterministic algorithms."""
    import os
    import subprocess
    import sys
    env = dict(os.environ)
    env.pop("MXNET_ENFORCE_DETERMINISM", None)
    if value is not None:
        env["MXNET_ENFORCE_DETERMINISM"] = value
    code = ("import torch, mxnet_tpu_torch.c_api; "
            "print(torch.backends.cudnn.deterministic, "
            "torch.backends.cudnn.benchmark)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == [str(want), "False"]
