"""The rest of the training API on the card: resume, the guard, remat and
Dropout, with the matmul-with-statistics kernel (B1) on the path.

A small NHWC network whose 1x1 convolutions feed BatchNorm, so the fusion
(``MXTPU_FUSE_CONV_BN=1``) runs B1 on ``cuda:0``: in float32 its
``tf32x3`` route, in bfloat16 its ``wgmma`` route (channels multiples of
8). Checks, each exact unless it says otherwise:
- ``Module.fit`` interrupted after 6 batches and resumed (``resume="auto"``,
  async checkpoints, the guard on) ends with the parameters and moving
  statistics of the uninterrupted fit, bit for bit (cuDNN deterministic,
  TF32 off);
- a guarded step with ``guard.grad_nan`` armed leaves the state as it
  was, and a clean guarded step equals an unguarded one;
- remat ``True`` and ``"conv"`` launch B1 twice a step's forward and give
  the parameters of no remat, bit for bit;
- Dropout on a 4096x4096 tensor keeps 0.5 +- 0.005 of it, and equal
  seeds give equal masks.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_checkpoint_card.py -q

Without CUDA each test skips, with its reason.
"""
import contextlib
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.executor import node_generator
from mxnet_tpu_torch.ops import matmul_stats as ms
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.train_step import TrainStep

SHAPE = (16, 8, 8, 16)
#: the fused Conv1x1->BatchNorm pairs of _net
FUSED = 2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the matmul-with-statistics "
                    "kernel runs on cuda:0 (chip_smoke.py phase 14 runs "
                    "this path at full width)")


@contextlib.contextmanager
def _exact(monkeypatch):
    """Fusion on, TF32 off, cuDNN deterministic; the faults cleared."""
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    faults.clear()
    try:
        yield
    finally:
        faults.clear()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


def _net():
    with mt.symbol.NameManager():
        d = mt.sym.Variable("data")
        x = mt.sym.Convolution(d, kernel=(3, 3), pad=(1, 1), num_filter=32,
                               no_bias=True, layout="NHWC", name="c1")
        x = mt.sym.BatchNorm(x, axis=3, fix_gamma=False, name="bn1")
        x = mt.sym.Activation(x, act_type="relu")
        y = mt.sym.Convolution(x, kernel=(1, 1), num_filter=64, no_bias=True,
                               layout="NHWC", name="c2")
        y = mt.sym.BatchNorm(y, axis=3, fix_gamma=False, name="bn2")
        y = mt.sym.Activation(y, act_type="relu")
        y = mt.sym.Convolution(y, kernel=(1, 1), num_filter=32, no_bias=True,
                               layout="NHWC", name="c3")
        y = mt.sym.BatchNorm(y, axis=3, fix_gamma=False, name="bn3")
        x = mt.sym.Activation(x + y, act_type="relu")
        x = mt.sym.Pooling(x, global_pool=True, kernel=(1, 1),
                           pool_type="avg", layout="NHWC")
        x = mt.sym.FullyConnected(mt.sym.Flatten(x), num_hidden=10,
                                  name="fc")
        return mt.sym.SoftmaxOutput(x, name="softmax")


def _data(n=16 * 8):
    rng = np.random.default_rng(zlib.crc32(b"checkpoint_card"))
    x = rng.standard_normal((n,) + SHAPE[1:]).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.float32)
    return x, y


class _Stop(Exception):
    pass


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_resume_bitwise_with_b1(monkeypatch, tmp_path, k):
    _need_card()
    x, y = _data()

    def fit(prefix, stop=None, resume=None):
        mt.random.seed(3)
        mod = mt.mod.Module(_net())

        def cb(p):
            if stop is not None and p.epoch * 8 + p.nbatch + 1 >= stop:
                raise _Stop()
        try:
            mod.fit(mt.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                    optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                      "wd": 1e-4},
                    initializer=mt.initializer.Xavier(),
                    batch_end_callback=cb, steps_per_dispatch=k,
                    checkpoint_prefix=prefix, checkpoint_every_n_batches=4,
                    checkpoint_async=True, guard=True, resume=resume)
        except _Stop:
            pass
        arg, aux = mod.get_params()
        return ({n: v.asnumpy() for n, v in arg.items()},
                {n: v.asnumpy() for n, v in aux.items()})

    with _exact(monkeypatch):
        before = ms.LAUNCHES
        ref = fit(str(tmp_path / "ref"))
        assert ms.LAUNCHES - before == FUSED * 16
        fit(str(tmp_path / "vic"), stop=6)
        got = fit(str(tmp_path / "vic"), resume="auto")
    for want, have in zip(ref, got):
        for n, v in want.items():
            np.testing.assert_array_equal(have[n], v, err_msg=n)


def _step_pair(compute_dtype="bfloat16"):
    kw = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4,
              compute_dtype=compute_dtype)
    a, b = TrainStep(_net(), **kw), TrainStep(_net(), **kw)
    sa = a.init({"data": SHAPE}, {"softmax_label": (SHAPE[0],)}, seed=1)
    sb = b.init({"data": SHAPE}, {"softmax_label": (SHAPE[0],)}, seed=1)
    return a, b, sa, sb


def _batch(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"data": torch.randn(SHAPE, generator=g, device="cuda"),
            "softmax_label": torch.randint(0, 10, (SHAPE[0],), generator=g,
                                           device="cuda").float()}


def _same(sa, sb):
    for key in ("params", "aux", "opt"):
        for n, v in sa[key].items():
            assert torch.equal(v, sb[key][n]), (key, n)
    assert int(sa["step"]) == int(sb["step"])


@pytest.mark.gpu
def test_guard_noop_and_clean_step_with_b1(monkeypatch):
    _need_card()
    with _exact(monkeypatch):
        a, b, sa, sb = _step_pair()
        ms.reset_launches()
        sa, _ = a.step(sa, _batch(1))
        sb, _, packed = b.step(sb, _batch(1), guard=True)
        assert ms.LAUNCHES_BY_ROUTE["wgmma"] == 2 * FUSED
        _same(sa, sb)
        assert packed.cpu().numpy()[3] == 0
        before = {k: {n: v.clone() for n, v in sb[k].items()}
                  for k in ("params", "aux", "opt")}
        faults.inject("guard.grad_nan", nth=1)
        sb, _, packed = b.step(sb, _batch(2), guard=True)
        sent = packed.cpu().numpy()
        assert sent[3] == 1 and sent[2] == 0
        for key, vals in before.items():
            for n, v in vals.items():
                assert torch.equal(v, sb[key][n]), (key, n)
        assert int(sb["step"]) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [True, "conv"])
def test_remat_launches_and_parameters_with_b1(monkeypatch, remat):
    _need_card()
    with _exact(monkeypatch):
        kw = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
                  compute_dtype="bfloat16")
        plain = TrainStep(_net(), **kw)
        re = TrainStep(_net(), remat=remat, **kw)
        sp = plain.init({"data": SHAPE}, {"softmax_label": (SHAPE[0],)})
        sr = re.init({"data": SHAPE}, {"softmax_label": (SHAPE[0],)})
        counts = []
        for step, st in ((plain, sp), (re, sr)):
            ms.reset_launches()
            for i in range(2):
                step.step(st, _batch(10 + i))
            torch.cuda.synchronize()
            counts.append(ms.LAUNCHES_BY_ROUTE["wgmma"])
        assert counts == [2 * FUSED, 4 * FUSED]
        _same(sp, sr)


@pytest.mark.gpu
def test_dropout_statistics_on_the_card():
    _need_card()
    x = torch.ones((4096, 4096), device="cuda")

    def drop(key, idx, p=0.5):
        return treg.get("Dropout").apply(
            treg.OpContext(is_train=True,
                           rng=node_generator(key, idx, x.device)),
            dict(p=p), [x], [])[0][0]

    a = drop(1, 0)
    kept = float((a != 0).float().mean())
    assert abs(kept - 0.5) <= 0.005, kept
    assert set(torch.unique(a).tolist()) <= {0.0, 2.0}
    assert torch.equal(a, drop(1, 0))
    assert not torch.equal(a, drop(2, 0))
    kept = float((drop(3, 0, p=0.2) != 0).float().mean())
    assert abs(kept - 0.8) <= 0.005, kept
