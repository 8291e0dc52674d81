"""KVStore: the key-value store of data-parallel gradient aggregation
(ref: python/mxnet/kvstore.py, src/kvstore/kvstore_local.h,
kvstore_dist.h).

Counterpart of ``mxnet_tpu/kvstore.py``. The single-process semantics are
the reference's: ``push`` sums each key's values across the given device
list and applies the updater to the stored value (or stores the sum),
``pull`` copies the stored value into each output. ``set_optimizer``
round-trips the optimizer through pickle, as the reference's controller
command does, and the optimizer states save and load in the JAX package's
``.states`` layout. Every store carries the fault policy: op deadlines, a
retry budget with backoff, and the dead-node health check.

- 'local'/'device': one implementation (:class:`KVStore`).
- 'dist_sync'/'dist_device_sync': the reference's parameter server is
  replaced by the control-plane ring (:mod:`mxnet_tpu_torch.dist_ring`)
  over the launcher's ``TCPStore``: cross-process aggregation is a
  deterministic allreduce whose every wait aborts when a peer's heartbeat
  goes stale, so a lost worker surfaces as :class:`WorkerLostError` in
  bounded time and the survivors can re-form at N-1.
  ``MXTPU_DIST_TRANSPORT=mesh`` selects the legacy transport instead:
  gloo collectives over host tensors (:mod:`~mxnet_tpu_torch.parallel.mesh`'s
  multi-process helpers), which cannot re-form.
- 'dist_async': bounded-staleness (SSP) push/pull: each worker's pushes
  carry a version, and a pull blocks only while this worker is more than
  ``MXTPU_KV_STALENESS`` versions ahead of the slowest live peer.

Without the launcher's environment (``MXTPU_RANK``/``MXTPU_NPROC``) a dist
store is a one-worker store.
"""
from __future__ import annotations

import io
import logging
import os
import pickle
import struct
import threading
import time

import numpy as np
import torch

from .base import MXNetError
from .base import env_float as _env_float
from . import optimizer as opt
from .ndarray import NDArray


class KVStoreTimeoutError(MXNetError):
    """A kvstore operation blew its configured deadline (or an injected
    message drop). ``started`` records whether the underlying op had
    begun: pre-op failures (drops) are retried against the configured
    budget; a started-but-stuck op escalates at once — its abandoned
    watchdog thread may still be inside a collective, and re-entering the
    same barrier would corrupt the rendezvous."""

    def __init__(self, msg, started=False):
        super().__init__(msg)
        self.started = started


class WorkerLostError(MXNetError):
    """Peers stayed dead across consecutive health checks, or a ring wait
    found a peer dead: BSP training cannot make progress, so the run
    re-forms (elastic ``fit``) or checkpoints and surfaces."""


def _run_with_timeout(fn, timeout, site):
    """Run an IDEMPOTENT op under a watchdog: if it makes no progress
    within ``timeout`` seconds, raise KVStoreTimeoutError (the worker
    thread is abandoned — safe only because the op is idempotent and the
    caller retries or escalates)."""
    result = {}
    done = threading.Event()

    def runner():
        try:
            result["v"] = fn()
        except BaseException as e:  # surfaced to the caller below
            result["e"] = e
        finally:
            done.set()

    t = threading.Thread(target=runner, name="mxtpu-kv-watchdog",
                         daemon=True)
    t.start()
    if not done.wait(timeout):
        raise KVStoreTimeoutError(
            "%s: no progress after %.1fs deadline; a peer may be dead or "
            "partitioned — check num_dead_node() and resume from the last "
            "checkpoint" % (site, timeout), started=True)
    if "e" in result:
        raise result["e"]
    return result.get("v")


def _key_value(key, value):
    """Normalize to (keys, list of value lists)."""
    if isinstance(key, (int, str)):
        return [key], [value if isinstance(value, (list, tuple))
                       else [value]]
    if len(key) != len(value):
        raise MXNetError("kvstore: %d keys but %d values"
                         % (len(key), len(value)))
    return list(key), [v if isinstance(v, (list, tuple)) else [v]
                       for v in value]


def _local_sum(vlist, device):
    """The values of one key summed across the device list, on
    ``device``."""
    merged = vlist[0].data.to(device)
    for v in vlist[1:]:
        merged = merged + v.data.to(merged.device)
    return merged


def _from_host(arr, like):
    """A host array as a tensor on ``like``'s device and in its dtype."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device=like.device, dtype=like.dtype)


class KVStore(object):
    """Single-process KVStore (types ``local`` and ``device``), and the
    fault policy every store shares."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        # fault policy: env-seeded, overridable via set_fault_policy;
        # timeout=None disables deadlines
        self._timeout = _env_float("MXTPU_KV_TIMEOUT", None)
        self._retries = int(_env_float("MXTPU_KV_RETRIES", 2))
        self._backoff = _env_float("MXTPU_KV_BACKOFF", 0.02)
        self._backoff_max = _env_float("MXTPU_KV_BACKOFF_MAX", 0.5)
        self._health_interval = _env_float("MXTPU_KV_HEALTH_INTERVAL", 10.0)
        self._dead_timeout = _env_float("MXTPU_KV_DEAD_TIMEOUT", 60.0)
        self._dead_strikes = 0
        self._last_health = None

    def set_fault_policy(self, timeout="unset", retries=None, backoff=None,
                         backoff_max=None, health_interval=None,
                         dead_timeout=None):
        """Configure op deadlines, retry budget, backoff and health-check
        cadence (env defaults: MXTPU_KV_TIMEOUT / _RETRIES / _BACKOFF /
        _BACKOFF_MAX / _HEALTH_INTERVAL / _DEAD_TIMEOUT)."""
        if timeout != "unset":
            self._timeout = timeout
        if retries is not None:
            self._retries = int(retries)
        if backoff is not None:
            self._backoff = float(backoff)
        if backoff_max is not None:
            self._backoff_max = float(backoff_max)
        if health_interval is not None:
            self._health_interval = float(health_interval)
        if dead_timeout is not None:
            self._dead_timeout = float(dead_timeout)

    def _robust(self, op, fn, idempotent=False):
        """Run a kvstore op with the configured retry/backoff and (for
        idempotent ops) watchdog deadline. Only PRE-OP failures are
        retried — injected transients and drops, which fire before the op
        runs; budget exhaustion raises MXNetError naming the op and
        attempt count. A started-but-stuck op (watchdog timeout) escalates
        at once. Non-idempotent ops (push/pull) that complete but exceed
        the deadline only warn: retrying a completed push would
        double-apply the gradient."""
        from . import faults as _faults
        site = "kvstore.%s" % op
        attempt = 0
        while True:
            attempt += 1
            try:
                act = _faults.fire(site)
                if act == "drop":
                    raise KVStoreTimeoutError(
                        "%s: message dropped (injected)" % site)
                if idempotent and self._timeout:
                    return _run_with_timeout(fn, self._timeout, site)
                t0 = time.monotonic()
                out = fn()
                elapsed = time.monotonic() - t0
                if self._timeout and elapsed > self._timeout:
                    logging.warning(
                        "%s completed but took %.2fs (deadline %.2fs) — "
                        "peers may be degrading; check num_dead_node()",
                        site, elapsed, self._timeout)
                return out
            except (KVStoreTimeoutError,
                    _faults.InjectedTransientFault) as e:
                if getattr(e, "started", False):
                    raise MXNetError(
                        "%s timed out after it started (attempt %d): %s"
                        % (site, attempt, e)) from e
                if attempt > self._retries:
                    raise MXNetError(
                        "%s failed after %d attempts (retry budget %d "
                        "exhausted): %s" % (site, attempt, self._retries,
                                            e)) from e
                delay = min(self._backoff * (2.0 ** (attempt - 1)),
                            self._backoff_max)
                logging.warning("%s: transient failure (attempt %d/%d), "
                                "retrying in %.3fs: %s", site, attempt,
                                self._retries + 1, delay, e)
                if delay > 0:
                    time.sleep(delay)

    def check_health(self, on_degraded=None, force=False):
        """The dead-node degradation policy: feed ``num_dead_node`` into a
        strike counter — strike 1 warns, strike 2 warns and runs
        ``on_degraded`` (fit passes an emergency-checkpoint closure),
        strike 3+ raises :class:`WorkerLostError`. A healthy scan resets
        the strikes. Scans are throttled to one per
        ``MXTPU_KV_HEALTH_INTERVAL`` seconds unless ``force``."""
        from . import faults as _faults
        now = time.monotonic()
        if (not force and self._last_health is not None
                and now - self._last_health < self._health_interval):
            return 0
        self._last_health = now
        dead = self.num_dead_node(0, timeout_sec=self._dead_timeout)
        act = _faults.fire("kvstore.dead_node")
        if act and isinstance(act, str) and act.startswith("dead:"):
            dead = max(dead, int(act.split(":", 1)[1]))
        if not dead:
            self._dead_strikes = 0
            return 0
        self._dead_strikes += 1
        if self._dead_strikes == 1:
            logging.warning(
                "kvstore: %d dead worker(s) detected (strike 1/3: warn)",
                dead)
        elif self._dead_strikes == 2:
            logging.warning(
                "kvstore: %d worker(s) still dead (strike 2/3: emergency "
                "checkpoint)", dead)
            if on_degraded is not None:
                on_degraded()
        else:
            msg = ("%d dead worker(s) across %d consecutive health checks; "
                   "BSP training cannot progress — restart from the last "
                   "checkpoint (resume='auto') with a healthy worker set"
                   % (dead, self._dead_strikes))
            # the post-mortem before the escalation unwinds
            from .obs import flight as _flight
            _flight.dump("WorkerLostError: %s" % msg,
                         extra={"dead_workers": dead,
                                "strikes": self._dead_strikes,
                                "rank": self.rank})
            raise WorkerLostError(msg)
        return dead

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # ------------------------------------------------------------------
    def init(self, key, value):
        keys, values = _key_value(key, value)
        for k, vlist in zip(keys, values):
            if k in self._store:
                raise MXNetError("init: key %r already initialized" % (k,))
            self._store[k] = self._init_value(vlist[0].copy())

    def _init_value(self, value):
        """Hook: dist stores broadcast rank 0's copy so every worker
        starts from one authoritative value (ref: the server's single
        stored weight, kvstore_dist_server.h)."""
        return value

    def _cross_reduce(self, merged):
        """Hook: dist stores sum the locally-reduced value across
        workers."""
        return merged

    def push(self, key, value, priority=0):
        """Sum each key's values and update (or replace) the stored value.
        ``priority`` is accepted for parity; pushes run in call order."""
        self._robust("push", lambda: self._do_push(key, value, priority))

    def _do_push(self, key, value, priority=0):
        keys, values = _key_value(key, value)
        for k, vlist in zip(keys, values):
            if k not in self._store:
                raise MXNetError("push: key %r not initialized" % (k,))
            stored = self._store[k]
            merged = self._cross_reduce(_local_sum(vlist,
                                                   stored.data.device))
            if self._updater is not None:
                self._updater(k, NDArray(merged), stored)
            else:
                stored._set_data(merged)

    def pull(self, key, out=None, priority=0):
        if out is None:
            raise MXNetError("pull: out= is required")
        self._robust("pull", lambda: self._do_pull(key, out, priority))

    def _do_pull(self, key, out, priority=0):
        keys, outs = _key_value(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("pull: key %r not initialized" % (k,))
            for o in olist:
                self._store[k].copyto(o)

    # ------------------------------------------------------------------
    def set_optimizer(self, optimizer):
        """Update through an :class:`~mxnet_tpu_torch.optimizer.Updater`
        of a pickled copy of ``optimizer``."""
        self._set_updater(opt.get_updater(
            pickle.loads(pickle.dumps(optimizer))))

    def _set_updater(self, updater):
        self._updater = updater

    def _barrier(self):
        pass

    def barrier(self):
        """Block until every worker arrives (no-op single-process).
        Idempotent, so it runs under the watchdog deadline and retry
        budget when MXTPU_KV_TIMEOUT is set."""
        self._robust("barrier", self._barrier, idempotent=True)

    def save_optimizer_states(self, fname):
        """Write the updater's states; returns the bytes written."""
        if self._updater is None:
            raise MXNetError("save_optimizer_states: this kvstore has no "
                             "optimizer (call set_optimizer first)")
        from .model import atomic_write_bytes
        data = self._updater.get_states()
        atomic_write_bytes(fname, data)
        return data

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("load_optimizer_states: this kvstore has no "
                             "optimizer (call set_optimizer first)")
        from .model import apply_optimizer_states
        apply_optimizer_states(self._updater.set_states, fname)

    def num_dead_node(self, node_id, timeout_sec=60):
        """ref: kvstore_dist.h GetDeadNodes — the dead-node count. A
        single-process store has no peers: 0; the dist stores scan the
        heartbeats."""
        return 0


# --------------------------------------------------------------------------
# liveness
# --------------------------------------------------------------------------

class _Heartbeat(object):
    """Worker liveness over the launcher's store (ref: ps-lite's
    Postoffice::GetDeadNodes). A daemon thread stamps ``mxtpu_hb/<rank>``
    every ``interval`` seconds through its own store connection (a
    ``TCPStore`` client is not shared across threads); peers count ranks
    whose stamp is stale. ``client_factory`` makes that connection (the
    launcher's store by default); with no plane there is no beat."""

    KEY = "mxtpu_hb/%d"

    def __init__(self, rank, interval=2.0, startup_grace=None,
                 client_factory=None):
        self.rank = rank
        self.interval = interval
        self.startup_grace = startup_grace
        self._started = time.time()
        self._seen = set()  # ranks whose beat we have read at least once
        self._stop = None
        factory = client_factory or _plane_client
        client = factory()
        self._reader = factory() if client is not None else None
        if client is None:
            return
        self._stop = threading.Event()

        def beat():
            while not self._stop.wait(self.interval):
                self._publish(client)
        self._publish(client)
        threading.Thread(target=beat, name="mxtpu-heartbeat",
                         daemon=True).start()

    def _publish(self, client):
        from .dist_ring import DIST_HEALTH
        DIST_HEALTH.heartbeats += 1
        try:
            client.set(self.KEY % self.rank, repr(time.time()))
        except Exception:
            pass     # a lost plane shows as staleness to the peers

    def dead_nodes(self, size, timeout_sec):
        if self._reader is None or size <= 1:
            return 0
        now = time.time()
        # a peer that has never published is "not up yet", not dead: only
        # after the startup grace (default: the staleness timeout itself)
        # does silence from birth count as death
        grace = (self.startup_grace if self.startup_grace is not None
                 else timeout_sec)
        stamps = {}
        try:
            prefix = self.KEY.rsplit("%", 1)[0]
            for k, v in self._reader.dir(prefix).items():
                try:
                    stamps[int(str(k).rsplit("/", 1)[1])] = float(v)
                except (ValueError, IndexError):
                    pass
        except Exception:
            return 0                 # plane unreadable: cannot judge peers
        dead = 0
        for r in range(size):
            if r == self.rank:
                continue
            if r in stamps:
                self._seen.add(r)
                if now - stamps[r] > timeout_sec:
                    dead += 1
            elif r in self._seen or now - self._started > grace:
                dead += 1
        return dead

    def stop(self):
        if self._stop is not None:
            self._stop.set()


def _plane_client():
    """A new client connection to the launcher's store, None without
    one."""
    from . import kvstore_server
    plane = kvstore_server.plane()
    if plane is None:
        return None
    from .dist_ring import StoreClient
    return StoreClient.connect(plane["host"], plane["port"],
                               plane["timeout"])


_HB = None


def _shared_heartbeat(rank):
    """One heartbeat thread per process, stopped at exit — repeated
    KVStore creation must not accumulate beat threads."""
    global _HB
    if _HB is None:
        import atexit
        _HB = _Heartbeat(rank)
        atexit.register(_HB.stop)
    return _HB


# --------------------------------------------------------------------------
# dist_sync
# --------------------------------------------------------------------------

class KVStoreDistSync(KVStore):
    """BSP data-parallel store over the launcher's control plane.

    Within one process it behaves exactly like 'local'; across processes
    the locally-reduced value is summed over the control-plane ring in
    member order, so every worker computes the bitwise-identical aggregate
    (ref semantics: kvstore_dist.h sync mode). The ring also makes the
    store elastic: any wait on a dead peer raises :class:`WorkerLostError`
    in bounded time, and :meth:`reform` rebuilds the membership at N-1.
    ``MXTPU_DIST_TRANSPORT=mesh`` sums over the gloo process group instead
    (not elastic: a dead peer wedges the collective).
    """

    def __init__(self, kv_type="dist_sync"):
        super().__init__(kv_type)
        self._rank, self._size = _dist_rank_size()
        self._transport = os.environ.get("MXTPU_DIST_TRANSPORT", "ring")
        self._ring = None
        if self._size > 1:
            from . import kvstore_server
            kvstore_server.init_distributed()
            if self._transport != "mesh":
                from .dist_ring import shared_ring
                self._ring = shared_ring()
        self._heartbeat = (_shared_heartbeat(self._rank)
                           if self._size > 1 else None)
        self.max_reforms = int(_env_float("MXTPU_KV_MAX_REFORMS", 2))
        #: dist_sync is BSP: nobody is ever stale (Speedometer suffix)
        self.staleness_lag = 0

    def num_dead_node(self, node_id, timeout_sec=60):
        """Workers whose heartbeat is stale (ref contract: kvstore_dist.h
        GetDeadNodes)."""
        if self._heartbeat is None:
            return 0
        return self._heartbeat.dead_nodes(self._size, timeout_sec)

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        """The LIVE worker count: the ring membership's size, which
        shrinks on re-form (rescale_grad and throughput read it)."""
        if self._ring is not None:
            return len(self._ring.members)
        return self._size

    @property
    def worker_index(self):
        """This worker's position in the live membership, the data-shard
        index: ``rank`` stays the process id, and after a re-form the
        surviving ranks re-pack into 0..N-2 here."""
        if self._ring is not None:
            return self._ring.index
        return self._rank

    @property
    def reforms(self):
        """Ring re-forms survived so far (the ring's generation)."""
        return self._ring.gen if self._ring is not None else 0

    def _barrier(self):
        if self._size == 1:
            return
        if self._ring is not None:
            self._ring.barrier()
            return
        import torch.distributed as dist
        dist.barrier()

    def _do_push(self, key, value, priority=0):
        from . import faults as _faults
        # "delay" rules sleep inside fire(): a slow network push
        _faults.fire("kv.push_delay")
        super()._do_push(key, value, priority)

    # ------------------------------------------------------------------
    def _cross_sum(self, value):
        """Sum a value across every worker process (ref: the ps-lite
        server's aggregation). BSP: every worker pushes the same keys in
        the same order."""
        if self._size == 1:
            return value
        host = NDArray(value).asnumpy()
        if self._ring is not None:
            return _from_host(self._ring.allreduce_sum(host), value)
        from .parallel.mesh import grad_sync
        return _from_host(grad_sync({"v": host})["v"], value)

    # the cross-worker aggregation slots into the base push and init via
    # hooks: every worker applies the identical updater to the identical
    # aggregate of one authoritative initial value
    def _cross_reduce(self, merged):
        return self._cross_sum(merged)

    def _init_value(self, value):
        if self._size == 1:
            return value
        if self._ring is not None:
            arr = self._ring.broadcast(value.asnumpy(), root_index=0)
        else:
            from .parallel.mesh import global_data_mesh, host_broadcast0
            arr = host_broadcast0(global_data_mesh(
                "worker", local_devices=[value._data.device]),
                value.asnumpy())
        value._set_data(torch.from_numpy(np.ascontiguousarray(arr)))
        return value

    # ------------------------------------------------------------------
    # elastic membership
    def grad_reduce(self, vec):
        """Cross-worker sum of a flat host gradient vector: the fused
        TrainStep's per-step hook (ring transport only)."""
        if self._ring is None:
            return vec
        return self._ring.allreduce_sum(vec)

    def broadcast_bytes(self, payload, root_index=0):
        """Raw-bytes broadcast from the logical leader (checkpoint
        adoption after a re-form)."""
        if self._ring is None:
            return payload
        return self._ring.broadcast_bytes(payload, root_index=root_index)

    def reform(self):
        """Re-form the ring around the live members (plus any pending
        joiners); returns the new member list. Raises WorkerLostError when
        the store has no elastic transport; callers check
        :attr:`reforms` against :attr:`max_reforms` (MXTPU_KV_MAX_REFORMS)
        before calling."""
        if self._ring is None:
            raise WorkerLostError(
                "worker lost and no elastic transport: the '%s' transport "
                "cannot re-form (use MXTPU_DIST_TRANSPORT=ring)"
                % self._transport)
        return self._ring.reform()

    def pending_joiners(self):
        return self._ring.poll_joiners() if self._ring is not None else []

    def join(self, timeout=None):
        """Late-worker entry: request admission and block until the
        incumbents re-form us in at an epoch boundary; then warm-pull
        current params (kvstore broadcast) before the first step."""
        if self._ring is None:
            raise WorkerLostError("join requires the ring transport")
        return self._ring.request_join(timeout)

    def liveness_table(self):
        return (self._ring.liveness_table()
                if self._ring is not None else {})


# --------------------------------------------------------------------------
# dist_async
# --------------------------------------------------------------------------

class KVStoreDistAsync(KVStore):
    """Bounded-staleness (SSP) push/pull: the reference's fully-async
    parameter server (kvstore_dist_server.h async mode) made
    convergence-safe the Stale Synchronous Parallel way.

    Every worker owns a per-key record on the control plane, ``(version,
    last_push, cumulative_sum)``, overwritten in place on each push (one
    key per worker per parameter). ``push`` never blocks. ``pull`` blocks
    only while this worker is more than S = ``MXTPU_KV_STALENESS`` versions
    ahead of the slowest LIVE peer (dead laggards leave the window); a
    persistent stall ends in :class:`KVStoreTimeoutError`, never a hang.

    Aggregation at pull time: with an updater the store applies ``delta =
    sum_of_visible_cumulatives - already_applied`` (each worker's
    contribution lands exactly once, whatever the interleaving); without
    one the store becomes the sum of each worker's latest visible push.

    ``_plane=(client, rank, size)`` injects a control plane (a
    :class:`~mxnet_tpu_torch.dist_ring.LocalClient` in thread tests); real
    runs use the launcher's store.
    """

    def __init__(self, kv_type="dist_async", _plane=None, _ns="mxasync"):
        super().__init__(kv_type)
        self._ns = _ns
        if _plane is not None:
            self._client, self._rank, self._size = _plane
            self._heartbeat = None
        else:
            self._rank, self._size = _dist_rank_size()
            self._client = None
            self._heartbeat = None
            if self._size > 1:
                from . import kvstore_server
                from .dist_ring import StoreClient
                kvstore_server.init_distributed()
                self._client = StoreClient(kvstore_server.plane()["store"])
                self._heartbeat = _shared_heartbeat(self._rank)
        self.staleness = int(_env_float("MXTPU_KV_STALENESS", 4))
        self._poll = _env_float("MXTPU_DIST_POLL", 0.005)
        self._pull_timeout = _env_float("MXTPU_DIST_OP_TIMEOUT", 120.0)
        self._ver = {}        # key -> this worker's push count
        self._last = {}       # key -> np array of the latest local push
        self._cum = {}        # key -> np cumulative sum of local pushes
        self._applied = {}    # key -> np total already folded into store
        self._dead_ranks = set()
        self.staleness_lag = 0

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._size - len(self._dead_ranks)

    @property
    def worker_index(self):
        return self._rank

    def num_dead_node(self, node_id, timeout_sec=60):
        if self._heartbeat is not None:
            return self._heartbeat.dead_nodes(self._size, timeout_sec)
        return len(self._dead_ranks)

    # -- control-plane records --
    def _kpath(self, kind, k, rank=None):
        p = "%s/%s/%s" % (self._ns, kind, k)
        return p if rank is None else p + "/%d" % rank

    @staticmethod
    def _enc_state(ver, last, cum):
        bio = io.BytesIO()
        bio.write(struct.pack("<q", int(ver)))
        np.lib.format.write_array(bio, np.ascontiguousarray(last),
                                  allow_pickle=False)
        np.lib.format.write_array(bio, np.ascontiguousarray(cum),
                                  allow_pickle=False)
        return bio.getvalue()

    @staticmethod
    def _dec_state(data):
        bio = io.BytesIO(data)
        ver = struct.unpack("<q", bio.read(8))[0]
        last = np.lib.format.read_array(bio, allow_pickle=False)
        cum = np.lib.format.read_array(bio, allow_pickle=False)
        return ver, last, cum

    def _publish_state(self, k):
        if self._client is None:
            return
        self._client.set(self._kpath("v", k, self._rank),
                         self._enc_state(self._ver[k], self._last[k],
                                         self._cum[k]))

    def _peer_states(self, k):
        """Latest-visible (version, last, cum) per rank, dead ranks
        included: their landed contributions stay in the aggregate (only
        the staleness window stops gating on them). An unpublished rank
        reads as version 0 with zero contributions."""
        zero = np.zeros_like(self._cum[k])
        out = {r: (0, zero, zero) for r in range(self._size)}
        out[self._rank] = (self._ver[k], self._last[k], self._cum[k])
        if self._client is None:
            return out
        for key, data in self._client.dir(self._kpath("v", k) + "/").items():
            try:
                r = int(key.rsplit("/", 1)[1])
            except ValueError:
                continue
            if r == self._rank:
                continue
            out[r] = self._dec_state(data)
        return out

    # -- init/push/pull --
    def init(self, key, value):
        from .dist_ring import _decode_array, _encode_array
        keys, values = _key_value(key, value)
        for k, vlist in zip(keys, values):
            if k in self._store:
                raise MXNetError("init: key %r already initialized" % (k,))
            v = vlist[0].copy()
            if self._client is not None and self._size > 1:
                # rank 0's copy is authoritative (the server's single
                # stored weight, ref kvstore_dist_server.h)
                ikey = self._kpath("init", k)
                if self._rank == 0:
                    self._client.set(ikey, _encode_array(v.asnumpy()))
                else:
                    v._set_data(torch.from_numpy(
                        _decode_array(self._blocking_get(ikey))))
            arr = v.asnumpy()
            self._store[k] = v
            self._ver[k] = 0
            self._last[k] = np.zeros_like(arr)
            self._cum[k] = np.zeros_like(arr)
            self._applied[k] = np.zeros_like(arr)
            self._publish_state(k)

    def _blocking_get(self, key):
        deadline = time.monotonic() + self._pull_timeout
        while True:
            v = self._client.get(key)
            if v is not None:
                return v
            if time.monotonic() >= deadline:
                raise KVStoreTimeoutError(
                    "dist_async: %s not published within %.0fs (is rank 0 "
                    "up?)" % (key, self._pull_timeout), started=True)
            if self._poll:
                time.sleep(self._poll)

    def _do_push(self, key, value, priority=0):
        from . import faults as _faults
        _faults.fire("kv.push_delay")
        keys, values = _key_value(key, value)
        for k, vlist in zip(keys, values):
            if k not in self._store:
                raise MXNetError("push: key %r not initialized" % (k,))
            m = NDArray(_local_sum(vlist, vlist[0].data.device)).asnumpy()
            self._ver[k] += 1
            self._last[k] = m
            self._cum[k] = self._cum[k] + m
            self._publish_state(k)       # overwrite in place; non-blocking

    def _do_pull(self, key, out, priority=0):
        keys, outs = _key_value(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("pull: key %r not initialized" % (k,))
            self._refresh(k)
            for o in olist:
                self._store[k].copyto(o)

    def _refresh(self, k):
        """Enforce the staleness window, then fold the visible state of
        every peer into the stored value."""
        deadline = time.monotonic() + self._pull_timeout
        while True:
            states = self._peer_states(k)
            # the window gates on LIVE peers only; dead ranks' landed
            # contributions still aggregate below
            min_ver = min(v[0] for r, v in states.items()
                          if r not in self._dead_ranks)
            lag = self._ver[k] - min_ver
            self.staleness_lag = max(0, lag)
            from .dist_ring import DIST_HEALTH
            DIST_HEALTH.staleness_lag = self.staleness_lag
            if lag <= self.staleness:
                break
            laggards = [r for r, v in states.items()
                        if self._ver[k] - v[0] > self.staleness
                        and r != self._rank and r not in self._dead_ranks]
            dead = [r for r in laggards
                    if self._client is not None
                    and not self._client.alive(r)]
            if dead:
                # async tolerates loss: a dead laggard stops gating the
                # window (its landed contributions remain in the sums)
                logging.warning(
                    "dist_async: dropping dead laggard worker(s) %s from "
                    "the staleness window for key %r", dead, k)
                self._dead_ranks.update(dead)
                continue
            if time.monotonic() >= deadline:
                raise KVStoreTimeoutError(
                    "dist_async pull: worker %d is %d versions ahead of "
                    "the slowest peer (window S=%d) and no progress for "
                    "%.0fs" % (self._rank, lag, self.staleness,
                               self._pull_timeout), started=True)
            if self._poll:
                time.sleep(self._poll)
        ranks = sorted(states)
        stored = self._store[k]
        if self._updater is not None:
            total = None
            for r in ranks:
                c = states[r][2]
                total = c.copy() if total is None else total + c
            delta = total - self._applied[k]
            if np.any(delta != 0):
                self._updater(k, NDArray(_from_host(delta, stored.data)),
                              stored)
            self._applied[k] = total
        else:
            pushed = [states[r][1] for r in ranks if states[r][0] > 0]
            if pushed:
                total = None
                for p in pushed:
                    total = p.copy() if total is None else total + p
                stored._set_data(torch.from_numpy(
                    np.ascontiguousarray(total)))

    def _barrier(self):
        """Best-effort KV barrier (async training rarely needs one; launch
        scripts use it around setup and teardown)."""
        if self._client is None or self._size <= 1:
            return
        self._bar_n = getattr(self, "_bar_n", 0) + 1
        prefix = "%s/bar/%d/" % (self._ns, self._bar_n)
        self._client.set(prefix + "%d" % self._rank, b"ok")
        deadline = time.monotonic() + self._pull_timeout
        while True:
            have = self._client.dir(prefix)
            missing = [r for r in range(self._size)
                       if r not in self._dead_ranks
                       and (prefix + "%d" % r) not in have]
            if not missing:
                return
            for r in list(missing):
                if not self._client.alive(r):
                    self._dead_ranks.add(r)
            if time.monotonic() >= deadline:
                raise KVStoreTimeoutError(
                    "dist_async barrier %d: missing ranks %s"
                    % (self._bar_n, missing), started=True)
            if self._poll:
                time.sleep(self._poll)


def _dist_rank_size():
    """``(rank, size)`` from the launcher's environment (``MXTPU_RANK``,
    ``MXTPU_NPROC``; ``tools/launch.py`` sets both); ``(0, 1)`` without
    it."""
    try:
        size = int(os.environ.get("MXTPU_NPROC", "") or 1)
        rank = int(os.environ.get("MXTPU_RANK", "") or 0)
    except ValueError:
        raise MXNetError("MXTPU_RANK/MXTPU_NPROC must be integers, got "
                         "%r/%r" % (os.environ.get("MXTPU_RANK"),
                                    os.environ.get("MXTPU_NPROC")))
    if size <= 1 or not os.environ.get("MXTPU_COORD"):
        return 0, 1
    return rank, size


def create(name="local"):
    """Create a KVStore (ref: src/kvstore/kvstore.cc factory).

    'local'/'device' — single-process (one implementation).
    'dist_sync'/'dist_device_sync' — BSP over the control-plane ring
    (elastic; see :class:`KVStoreDistSync`).
    'dist_async' — bounded-staleness SSP push/pull (see
    :class:`KVStoreDistAsync`; window MXTPU_KV_STALENESS).
    """
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if "async" in name:
        return KVStoreDistAsync(name)
    if "dist" in name:
        return KVStoreDistSync(name)
    if name in ("local", "device", "local_allreduce_cpu",
                "local_allreduce_device"):
        return KVStore(name)
    raise MXNetError("unknown kvstore type %r" % name)
