"""The open-loop arrival client of the serving benchmarks.

The port's copy of ``open_loop_run`` from ``mxnet_tpu/autotune/harness.py``
(the JAX package's bench.py serving modes and its autotuner's serving
trials drive the batcher with it). The training harnesses and the memcheck
pruner of that module are not ported.
"""
from __future__ import annotations

import threading
import time


def open_loop_run(infer, inputs, qps, nreq, nclients=4):
    """Open-loop arrival client loop: request i is DUE at ``t0 + i/qps``
    regardless of how long earlier requests took — queueing delay shows up
    in the measured latency instead of silently lowering the offered
    load. ``infer`` is any blocking callable (``Batcher.infer``,
    ``FleetRouter.infer``); ``inputs`` is the request, or a callable
    ``inputs(i)`` giving request i. ``nclients`` threads share the
    requests (client c sends i = c, c + nclients, ...). Returns
    ``(latency-seconds list, error-repr list, wall seconds)``."""
    latencies = []
    errors = []
    lock = threading.Lock()
    interval = 1.0 / float(qps)
    t0 = time.perf_counter() + 0.05

    def client(cid):
        for i in range(cid, nreq, nclients):
            due = t0 + i * interval
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            t_start = time.perf_counter()
            try:
                infer(inputs(i) if callable(inputs) else inputs)
                dt = time.perf_counter() - t_start
                with lock:
                    latencies.append(dt)
            except Exception as e:
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(nclients)]
    wall0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return latencies, errors, time.perf_counter() - wall0
