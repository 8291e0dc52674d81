"""Monitor: per-op output statistics for debugging
(ref: python/mxnet/monitor.py).

Counterpart of ``mxnet_tpu/monitor.py``. It installs a callback on each
executor (``Executor.set_monitor_callback``), which the graph runner calls
with every op output of a forward; on every ``interval``-th batch
(``tic``) the outputs whose names match ``pattern`` are recorded as
``stat_func`` of them (default: ``norm(x) / sqrt(size)``), and ``toc``
adds the matching arguments (the weights after the update) and returns
``(batch, name, value)`` rows. A module with a monitor installed trains
through its executor, as in the JAX package.
"""
from __future__ import annotations

import logging
import re

from .ndarray import NDArray
from . import ndarray as nd


class Monitor(object):
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return nd.norm(x) / (x.size ** 0.5)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        self.stat_helper = stat_helper

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch if it falls on the interval."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End this batch's collection; returns ``(batch, name, value)``
        rows, the values as strings."""
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
        for exe in self.exes:
            for name, array in exe.arg_dict.items():
                if self.re_prog.match(name):
                    self.queue.append((self.step, name, self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            assert isinstance(v_list, list)
            s = ",".join(str(v.asscalar() if v.size == 1 else v.asnumpy())
                         for v in v_list)
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """``toc`` and log each row."""
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
