"""KVStore server entry and the launcher's control plane (ref:
python/mxnet/kvstore_server.py).

The reference branches on ``DMLC_ROLE``: 'server' processes block applying
pickled optimizers to pushed gradients, 'worker' processes continue into
user code. The port has no server role: every process is a worker, and
aggregation is the control-plane ring's allreduce. This module opens that
plane from the launcher's environment (``tools/launch.py`` sets
``MXTPU_COORD``, ``MXTPU_RANK`` and ``MXTPU_NPROC``): a
``torch.distributed.TCPStore`` that rank 0 hosts at ``MXTPU_COORD`` and
every other rank reaches, bounded by ``MXTPU_INIT_TIMEOUT`` seconds (300),
and a gloo process group on that store for the legacy mesh transport
(``MXTPU_DIST_TRANSPORT=mesh``; ``MXTPU_DIST_GLOO=0`` opts out). A set
``MXTPU_COORD`` that cannot be reached raises; it never falls back to one
worker.
"""
from __future__ import annotations

import atexit
import datetime
import os
import time

from .base import MXNetError, env_float

_PLANE = {}


def plane():
    """The open control plane, ``{"store", "rank", "size", "host",
    "port", "timeout"}``, or None before :func:`init_distributed`."""
    return _PLANE.get("plane")


def init_distributed():
    """Open the control plane from the launcher's environment (once per
    process). Returns False without ``MXTPU_COORD``, True once open."""
    if plane() is not None:
        return True
    coord = os.environ.get("MXTPU_COORD")
    if not coord:
        return False
    import torch.distributed as dist
    rank = int(os.environ.get("MXTPU_RANK", "0"))
    size = int(os.environ.get("MXTPU_NPROC", "1"))
    host, _, port = coord.rpartition(":")
    host = host or "localhost"
    init_timeout = env_float("MXTPU_INIT_TIMEOUT", 300.0)
    try:
        store = dist.TCPStore(
            host, int(port), size, is_master=(rank == 0),
            timeout=datetime.timedelta(seconds=init_timeout),
            wait_for_workers=False)
    except Exception as e:
        raise MXNetError(
            "rank %d could not reach the control plane at %s within %.0fs "
            "(MXTPU_INIT_TIMEOUT): %s" % (rank, coord, init_timeout, e))
    # no store call outlives a ring op's deadline
    op_timeout = env_float("MXTPU_DIST_OP_TIMEOUT", 120.0)
    store.set_timeout(datetime.timedelta(seconds=op_timeout))
    if size > 1 and os.environ.get("MXTPU_DIST_GLOO", "1") != "0" \
            and not dist.is_initialized():
        dist.init_process_group(
            "gloo", store=dist.PrefixStore("mxtpu_gloo/", store),
            rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=init_timeout))
    _PLANE["plane"] = {"store": store, "rank": rank, "size": size,
                       "host": host, "port": int(port),
                       "timeout": op_timeout}
    atexit.register(_exit_sync)
    return True


def _exit_sync(timeout=60.0):
    """Rank 0 hosts the store, so it leaves last: every rank marks its
    exit, and rank 0 waits (bounded) for each peer that is still beating
    to mark its own."""
    p = plane()
    if p is None or p["size"] <= 1:
        return
    from .dist_ring import StoreClient
    client = StoreClient(p["store"])
    try:
        client.set("mxtpu_exit/%d" % p["rank"], b"ok", listed=False)
    except Exception:
        return
    if p["rank"] != 0:
        return
    deadline = time.time() + timeout
    pending = set(range(1, p["size"]))
    while pending and time.time() < deadline:
        for r in list(pending):
            if client.get("mxtpu_exit/%d" % r) is not None \
                    or not client.alive(r):
                pending.discard(r)
        time.sleep(0.05)


def _init_kvstore_server_module():
    """The reference's entry point: there it blocks server processes.
    Here it opens the control plane (when launched by ``tools/launch.py``)
    and returns: there are no server processes to block."""
    role = os.environ.get("DMLC_ROLE", os.environ.get("MXTPU_ROLE", "worker"))
    if role == "server":
        raise RuntimeError(
            "parameter-server roles do not exist on the TPU substrate: all "
            "processes are SPMD workers and gradient aggregation is an "
            "in-step psum (see mxnet_tpu.kvstore docs). Launch every process "
            "as a worker.")
    init_distributed()


_init_distributed = init_distributed
init = _init_kvstore_server_module
