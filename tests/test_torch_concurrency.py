"""Repairs for entry points that run on several threads at once (each
serving replica's batching thread calls ``ServingEngine.infer``).

- ``ops.nn.conv_precision`` (and ``matmul_precision``, cuBLAS's switch,
  by the same counted rule): cuDNN's TF32 switch is process-global. Two
  threads run through the section with their interleaving fixed by
  events (A enters, B enters, A leaves while B is still inside): B must
  still see the switch at ``CONV_TF32`` when it runs, and after both the
  switch must be the caller's value again. The section's result is
  checked too: a float32 convolution run inside it on each thread
  equals, bit for bit, the same convolution run alone.
- the launch counters of ``ops/multibox_nms.py`` and
  ``ops/matmul_stats.py``: a launch is counted under the module's lock
  (a count blocks while the lock is held), and many threads counting at
  once lose no update.

The CUDA branch of ``conv_precision`` only sets the switch, so it is
driven here with a CUDA ``torch.device`` and no card; the convolution
itself runs on CPU tensors. Tolerance: none (flags and counts are exact,
the convolution is bitwise).
"""
import sys
import threading

import pytest
import torch
import torch.nn.functional as F

from mxnet_tpu_torch.ops import matmul_stats, multibox_nms
from mxnet_tpu_torch.ops import nn as tnn

CUDA = torch.device("cuda", 0)


@pytest.fixture
def caller_tf32():
    """The caller has TF32 on; restored after the test."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = prev


def test_conv_precision_holds_across_interleaved_threads(caller_tf32):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 9, 9, generator=g)
    w = torch.randn(4, 3, 3, 3, generator=g)
    alone = F.conv2d(x, w)
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen, outs, errs = {}, {}, []

    def thread_a():
        try:
            with tnn.conv_precision(CUDA):
                a_in.set()
                assert b_in.wait(5.0)
                outs["a"] = F.conv2d(x, w)
            a_out.set()
        except Exception as e:
            errs.append(e)

    def thread_b():
        try:
            assert a_in.wait(5.0)
            with tnn.conv_precision(CUDA):
                b_in.set()
                assert a_out.wait(5.0)      # A has left; B still runs
                seen["b"] = torch.backends.cudnn.allow_tf32
                outs["b"] = F.conv2d(x, w)
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=thread_a),
               threading.Thread(target=thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    assert not errs, errs
    assert seen["b"] is tnn.CONV_TF32
    assert torch.backends.cudnn.allow_tf32 is True       # the caller's
    for k in ("a", "b"):
        assert torch.equal(outs[k], alone)


def test_conv_precision_nests_and_restores(caller_tf32):
    with tnn.conv_precision(CUDA):
        assert torch.backends.cudnn.allow_tf32 is tnn.CONV_TF32
        with tnn.conv_precision(CUDA):
            assert torch.backends.cudnn.allow_tf32 is tnn.CONV_TF32
        assert torch.backends.cudnn.allow_tf32 is tnn.CONV_TF32
    assert torch.backends.cudnn.allow_tf32 is True
    with tnn.conv_precision(torch.device("cpu")):     # the CPU: untouched
        assert torch.backends.cudnn.allow_tf32 is True


def test_matmul_precision_holds_across_threads_and_restores():
    """``ops.nn.matmul_precision`` (cuBLAS's TF32 switch, held off while a
    decode loop steps) follows the same counted rule: a thread still
    inside sees the switch off after another thread left, nested sections
    keep it off, and the caller's value comes back after the last one;
    the CPU leaves it alone."""
    flag = torch.backends.cuda.matmul
    prev = flag.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    flag.allow_tf32 = True
    a_in, a_out = threading.Event(), threading.Event()
    seen, errs = {}, []

    def thread_a():
        try:
            with tnn.matmul_precision(CUDA):
                a_in.set()
                with tnn.matmul_precision(CUDA):     # nested
                    seen["a"] = flag.allow_tf32
            a_out.set()
        except Exception as e:
            errs.append(e)

    try:
        with tnn.matmul_precision(CUDA):
            t = threading.Thread(target=thread_a)
            t.start()
            assert a_in.wait(5.0) and a_out.wait(5.0)
            t.join(5.0)
            assert not t.is_alive()
            seen["main"] = flag.allow_tf32         # A has left
        assert not errs, errs
        assert seen == {"a": False, "main": False}
        assert flag.allow_tf32 is True
        with tnn.matmul_precision(torch.device("cpu")):
            assert flag.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 == cudnn  # untouched
    finally:
        flag.allow_tf32 = prev


@pytest.mark.parametrize("mod,route", [(multibox_nms, "smem"),
                                       (matmul_stats, "wgmma")])
def test_launch_count_waits_for_the_lock(mod, route):
    mod.reset_launches()
    done = threading.Event()

    def count():
        mod._count_launch(route)
        done.set()

    with mod._COUNT_LOCK:
        t = threading.Thread(target=count)
        t.start()
        assert not done.wait(0.2)          # blocked behind the lock
        assert mod.LAUNCHES == 0
    t.join(5.0)
    assert not t.is_alive() and done.is_set()
    assert mod.LAUNCHES == 1 and mod.LAUNCHES_BY_ROUTE[route] == 1
    mod.reset_launches()
    assert mod.LAUNCHES == 0 and not any(mod.LAUNCHES_BY_ROUTE.values())


@pytest.mark.parametrize("mod,route", [(multibox_nms, "l2"),
                                       (matmul_stats, "tf32x3")])
def test_launch_counts_lose_no_update_under_threads(mod, route):
    mod.reset_launches()
    nthreads, per = 16, 2000
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [mod._count_launch(route) for _ in range(per)])
            for _ in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(prev)
    assert mod.LAUNCHES == nthreads * per
    assert mod.LAUNCHES_BY_ROUTE[route] == nthreads * per
    mod.reset_launches()
