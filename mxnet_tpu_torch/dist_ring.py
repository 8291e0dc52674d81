"""Control-plane ring for elastic multi-process training.

The port's own copy of ``mxnet_tpu/dist_ring.py`` (pure Python over numpy;
the port imports nothing of the JAX package). Cross-process gradient sums
are a bulk-synchronous exchange over a key-value plane, not gloo or NCCL
collectives: a peer that dies inside a collective leaves the survivors in
a wait they cannot cancel, while every wait loop here aborts the moment a
peer's heartbeat goes stale. Losing a worker surfaces as
:class:`~mxnet_tpu_torch.kvstore.WorkerLostError` in bounded time, never
a hang, and the surviving members can re-form the ring at N-1 and keep
training. (NCCL also refuses two ranks on one device, which is what a
one-card machine gives.)

Pieces:

* :class:`LocalClient`: in-memory, thread-safe KV plane with explicit
  liveness, the test double (threads stand in for processes).
* :class:`StoreClient`: the same interface over a
  ``torch.distributed.TCPStore`` (rank 0 hosts it at ``MXTPU_COORD``);
  liveness is heartbeat-stamp staleness.
* :class:`Ring`: ``allreduce_sum`` / ``broadcast`` / ``barrier`` over the
  KV plane, generation-tagged so a re-formed ring never reads a dead
  generation's keys, plus the first-write-wins re-form protocol and the
  epoch-boundary join protocol.

Fault sites: ``kv.worker_die`` fires at the top of every collective op
(``"die"`` SIGKILLs the process, the raising kinds propagate), and
``kv.partition`` fires in the per-peer poll loop (``"drop"`` models a
dropped control-plane message: the read is requeued and retried, so a
finite partition heals and a persistent one ends in
``KVStoreTimeoutError``, never a hang).
"""
from __future__ import annotations

import datetime
import io
import json
import os
import threading
import time

import numpy as np

from . import faults as _faults
from .base import MXNetError

__all__ = ["LocalClient", "StoreClient", "Ring", "DIST_HEALTH",
           "shared_ring"]

#: heartbeat key prefix shared with kvstore._Heartbeat
HB_PREFIX = "mxtpu_hb/"


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class DistHealth(object):
    """Process-global distributed-tier counters, mirrored into the obs
    registry as the ``dist_health`` view."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.rank = -1
        self.workers = 0
        self.generation = 0
        self.reforms = 0
        self.worker_lost = 0
        self.requeued = 0          # control-plane reads retried (partition)
        self.heartbeats = 0        # beats published by this process
        self.staleness_lag = 0     # dist_async: my_ver - min(peer_ver)
        self.joins = 0
        self.last_dead = ()

    def report(self):
        return {"rank": self.rank, "workers": self.workers,
                "generation": self.generation, "reforms": self.reforms,
                "worker_lost": self.worker_lost, "requeued": self.requeued,
                "heartbeats": self.heartbeats,
                "staleness_lag": self.staleness_lag, "joins": self.joins,
                "last_dead": ",".join(str(r) for r in self.last_dead)}


DIST_HEALTH = DistHealth()


def _flight_dump(reason, extra=None):
    try:
        from .obs import flight
        flight.dump(reason, extra=extra)
    except Exception:
        pass


# --------------------------------------------------------------------------
# KV-plane clients
# --------------------------------------------------------------------------

class LocalClient(object):
    """In-memory control plane for tests: threads play workers, liveness
    is explicit (:meth:`mark_dead`), and there is no clock in the loop —
    tests inject faults, not sleeps. ``listed`` is accepted for the
    :class:`StoreClient` interface (every key here is listed)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._store = {}
        self._dead = set()

    def set(self, key, value, overwrite=True, listed=True):
        if isinstance(value, str):
            value = value.encode()
        with self._lock:
            if not overwrite and key in self._store:
                return False
            self._store[key] = bytes(value)
            return True

    def get(self, key):
        with self._lock:
            return self._store.get(key)

    def dir(self, prefix):
        with self._lock:
            return {k: v for k, v in self._store.items()
                    if k.startswith(prefix)}

    def delete(self, key):
        with self._lock:
            self._store.pop(key, None)

    def alive(self, rank):
        with self._lock:
            return rank not in self._dead

    def mark_dead(self, rank):
        with self._lock:
            self._dead.add(rank)

    def revive(self, rank):
        with self._lock:
            self._dead.discard(rank)


#: value frames on the TCPStore: an inline value, a chunk header, a deleted
#: listed key
_INLINE, _CHUNKED, _TOMB = b"\x00", b"\x01", b"\x02"
#: the largest value one store message carries here (the libuv store
#: server drops the connection above 8 MiB)
CHUNK_BYTES = 4 << 20


class StoreClient(object):
    """The :class:`LocalClient` interface over a ``TCPStore``.

    The store has no directory read and its ``get`` blocks until the key
    lands, so: a read checks the key first (``check``) and returns None
    when it is absent; a key written with ``listed=True`` (the default) is
    appended to an index of its parent directory, which :meth:`dir` reads,
    and its deletion writes a tombstone (a peer may be between ``check``
    and ``get``); an unlisted key (the ring's exchange payloads, read only
    after they land and deleted only once every peer has read them) is
    deleted outright. A listed write is visible to every connection once
    the call returns, as in :class:`LocalClient`; an unlisted one is not
    waited for, since its readers poll until it lands (an exchange makes
    no round trip for its own writes). Values above :data:`CHUNK_BYTES`
    travel as chunks under a per-write tag, the head written last, so a
    reader that sees a head sees all its chunks (each key has one writer,
    which drops its earlier chunks). ``set(overwrite=False)`` is the
    store's ``compare_set`` against absence.

    Liveness: a rank is alive while its ``mxtpu_hb/<rank>`` stamp is
    fresher than ``dead_for`` seconds (``kvstore._Heartbeat`` publishes
    every 2 s). A rank with no stamp is given ``grace`` seconds from this
    client's creation: "not up yet" is not "dead". A client is used by
    one thread at a time; the heartbeat thread opens its own.

    The JAX package's coordination client frames every exchange payload
    to at least 2 bytes, writes "ok" for short values and reads one key
    through a scan of its parent directory, all for its binding (whose
    directory read crashes on values under 2 bytes and which has no
    single-key read that does not block). A ``TCPStore`` stores any bytes
    and reads one key, so the ring here writes payloads as they are."""

    def __init__(self, store, dead_for=None, grace=None):
        self._s = store
        self.dead_for = dead_for if dead_for is not None else \
            _env_float("MXTPU_DIST_DEAD_FOR", 6.0)
        self.grace = grace if grace is not None else \
            _env_float("MXTPU_DIST_GRACE", 30.0)
        self._started = time.time()
        self._tag = 0
        self._heads = {}    # key -> chunk head of this client's last write
        self._listed = set()    # keys this client entered in an index

    @classmethod
    def connect(cls, host, port, timeout, **kwargs):
        """A further client connection to the store at ``host:port``."""
        import torch.distributed as dist
        store = dist.TCPStore(host, int(port), is_master=False,
                              timeout=datetime.timedelta(seconds=timeout))
        return cls(store, **kwargs)

    # -- raw access --
    def _has(self, key):
        return self._s.check([key])

    def _raw(self, key):
        return self._s.get(key) if self._has(key) else None

    @staticmethod
    def _index(parent):
        return "__dir__/" + parent

    # -- kv --
    def set(self, key, value, overwrite=True, listed=True):
        if isinstance(value, str):
            value = value.encode()
        value = bytes(value)
        if len(value) > CHUNK_BYTES:
            self._tag += 1
            tag = "%d.%d.%d" % (os.getpid(), threading.get_ident(),
                                self._tag)
            n = 0
            for off in range(0, len(value), CHUNK_BYTES):
                self._s.set("%s#%s#%d" % (key, tag, n),
                            value[off:off + CHUNK_BYTES])
                n += 1
            head = _CHUNKED + ("%s:%d" % (tag, n)).encode()
        else:
            head = _INLINE + value
        if overwrite:
            self._s.set(key, head)
            ok = True
        else:
            ok = bytes(self._s.compare_set(key, b"", head)) == head
        if ok:
            old = self._heads.pop(key, None)
            if old is not None:
                self._drop_chunks(key, old)   # this client's earlier write
            if head[:1] == _CHUNKED:
                self._heads[key] = head
        elif head[:1] == _CHUNKED:
            self._drop_chunks(key, head)
        if listed and "/" in key and key not in self._listed:
            parent, name = key.rsplit("/", 1)
            self._s.append(self._index(parent + "/"),
                           (name + "\n").encode())
            self._listed.add(key)
        if listed:
            self._applied(key)
        return ok

    def _applied(self, key):
        """Wait until the store has applied this connection's writes.
        Its ``set`` and ``append`` send no reply, and the server reads its
        connections in no fixed order, so a write is not yet visible to a
        peer's connection when the call returns. A request that is
        answered (``check``) on the same connection is served after them."""
        self._s.check([key])

    def _drop_chunks(self, key, head):
        tag, n = head[1:].decode().rsplit(":", 1)
        for i in range(int(n)):
            self._s.delete_key("%s#%s#%d" % (key, tag, i))

    def get(self, key):
        for _ in range(16):
            head = self._raw(key)
            if head is None or head[:1] == _TOMB:
                return None
            if head[:1] == _INLINE:
                return bytes(head[1:])
            tag, n = head[1:].decode().rsplit(":", 1)
            keys = ["%s#%s#%d" % (key, tag, i) for i in range(int(n))]
            if self._s.check(keys):
                try:
                    return b"".join(bytes(self._s.get(k)) for k in keys)
                except Exception:
                    pass
            # a newer write replaced the chunks under us: read its head
        return None

    def dir(self, prefix):
        if not prefix.endswith("/"):
            raise MXNetError("StoreClient.dir: %r is not a directory "
                             "prefix (it must end with '/')" % prefix)
        idx = self._raw(self._index(prefix))
        out = {}
        if idx is None:
            return out
        for name in dict.fromkeys(bytes(idx).decode().split("\n")):
            if not name:
                continue
            v = self.get(prefix + name)
            if v is not None:
                out[prefix + name] = v
        return out

    def delete(self, key):
        head = self._heads.pop(key, None)
        if head is not None:
            self._drop_chunks(key, head)
        if not self._has(key):
            return
        parent = key.rsplit("/", 1)[0] + "/" if "/" in key else None
        if parent is not None and self._has(self._index(parent)):
            self._s.set(key, _TOMB)      # a listed key: a peer may read it
            self._applied(key)
        else:
            self._s.delete_key(key)

    # -- liveness --
    def alive(self, rank):
        v = self.get(HB_PREFIX + "%d" % rank)
        if v is None:
            return time.time() - self._started <= self.grace
        try:
            stamp = float(v.decode())
        except (ValueError, UnicodeDecodeError):
            return True
        return time.time() - stamp <= self.dead_for


# --------------------------------------------------------------------------
# array / payload codec
# --------------------------------------------------------------------------

def _encode_array(arr):
    bio = io.BytesIO()
    np.lib.format.write_array(bio, np.ascontiguousarray(arr),
                              allow_pickle=False)
    return bio.getvalue()


def _decode_array(data):
    return np.lib.format.read_array(io.BytesIO(data), allow_pickle=False)


# --------------------------------------------------------------------------
# the ring
# --------------------------------------------------------------------------

class Ring(object):
    """Bulk-synchronous exchange group over a KV plane.

    The BSP contract (every member runs the same collectives in the same
    order, which `dist_sync` training guarantees) makes a monotonic
    sequence number a sufficient message tag. Keys live under
    ``<ns>/g<gen>/...``: a re-formed ring bumps the generation, so
    stragglers of the old membership never read the new ring's traffic.
    Reductions sum in member order, so every worker computes a
    bitwise-identical result.
    """

    def __init__(self, client, rank, members, ns="mxring", poll=None,
                 op_timeout=None):
        self.client = client
        self.rank = int(rank)
        self.members = sorted(int(m) for m in members)
        assert self.rank in self.members
        self.ns = ns
        self.gen = 0
        self.seq = 0
        self.poll = poll if poll is not None else \
            _env_float("MXTPU_DIST_POLL", 0.005)
        self.op_timeout = op_timeout if op_timeout is not None else \
            _env_float("MXTPU_DIST_OP_TIMEOUT", 120.0)
        self.dead = ()          # ranks found dead by the last failed op
        self._published = []    # [(seq, [keys])] for trailing-edge GC
        DIST_HEALTH.rank = self.rank
        DIST_HEALTH.workers = len(self.members)

    # -- membership helpers --
    @property
    def size(self):
        return len(self.members)

    @property
    def index(self):
        """This worker's logical position in the live membership (the
        data-shard index after a re-form; the process rank is identity,
        this is placement)."""
        return self.members.index(self.rank)

    def liveness_table(self):
        return {str(r): ("self" if r == self.rank
                         else ("alive" if self.client.alive(r) else "dead"))
                for r in self.members}

    # -- key layout --
    def _key(self, kind, seq, rank):
        return "%s/g%d/%s/%d/%d" % (self.ns, self.gen, kind, seq, rank)

    # -- core exchange --
    def _exchange(self, kind, payload, roots=None):
        """Publish ``payload`` under this op's sequence number, collect
        every member's payload (or only ``roots``'), GC the trailing
        sequence. Raises WorkerLostError naming the dead ranks if a peer's
        key never lands and its heartbeat is stale."""
        act = _faults.fire("kv.worker_die")
        if act == "die":
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        seq = self.seq
        self.seq += 1
        mine = self._key(kind, seq, self.rank)
        if isinstance(payload, str):
            payload = payload.encode()
        self.client.set(mine, payload, listed=False)
        self._published.append((seq, [mine]))
        out = {self.rank: payload}
        want = self.members if roots is None else \
            [r for r in roots if r != self.rank]
        for r in want:
            if r == self.rank:
                continue
            out[r] = self._fetch(kind, seq, r)
        # trailing-edge GC: by BSP lockstep, once THIS op completed
        # everywhere a key two ops old has been read by every peer
        while self._published and self._published[0][0] <= seq - 2:
            _, keys = self._published.pop(0)
            for k in keys:
                self.client.delete(k)
        return out

    def _fetch(self, kind, seq, r):
        key = self._key(kind, seq, r)
        deadline = time.time() + self.op_timeout
        reform_prefix = "%s/reform/%d/prop/" % (self.ns, self.gen + 1)
        while True:
            act = _faults.fire("kv.partition")
            if act == "drop":
                # a dropped control-plane message: requeue the read,
                # falling through to the deadline check, so a persistent
                # partition ends in the timeout below, never a spin
                DIST_HEALTH.requeued += 1
            else:
                v = self.client.get(key)
                if v is not None:
                    return v
                # a peer already gave up on this generation: join the
                # re-form instead of waiting on traffic that never comes
                if self.client.dir(reform_prefix):
                    self._lost([],
                               "re-form of generation %d already proposed"
                               % (self.gen + 1))
                if not self.client.alive(r):
                    self._lost([r], "no heartbeat and no g%d/%s/%d key"
                               % (self.gen, kind, seq))
            if time.time() >= deadline:
                from .kvstore import KVStoreTimeoutError
                raise KVStoreTimeoutError(
                    "ring %s op (gen %d seq %d) timed out after %.0fs "
                    "waiting on rank %d" % (kind, self.gen, seq,
                                            self.op_timeout, r),
                    started=True)
            if self.poll:
                time.sleep(self.poll)

    def _lost(self, dead, why):
        from .kvstore import WorkerLostError
        self.dead = tuple(sorted(dead))
        DIST_HEALTH.worker_lost += 1
        DIST_HEALTH.last_dead = self.dead
        table = self.liveness_table()
        _flight_dump("ring worker lost (gen %d): %s" % (self.gen, why),
                     extra={"liveness": table, "generation": self.gen,
                            "members": list(self.members)})
        raise WorkerLostError(
            "worker(s) %s lost from ring generation %d (%s); liveness=%s"
            % (list(self.dead) or "?", self.gen, why, table))

    # -- collectives --
    def allreduce_sum(self, arr):
        """Deterministic cross-worker sum: every member's array, summed in
        member order (bitwise-identical on every worker)."""
        arr = np.asarray(arr)
        if self.size == 1:
            return arr.copy()
        got = self._exchange("red", _encode_array(arr))
        out = None
        for r in self.members:
            a = arr if r == self.rank else _decode_array(got[r])
            out = a.copy() if out is None else out + a
        return out

    def broadcast_bytes(self, payload, root_index=0):
        """Raw-bytes broadcast from the member at ``root_index``."""
        root = self.members[root_index]
        if self.size == 1:
            return payload
        data = payload if self.rank == root else b""
        got = self._exchange("bcast", data)
        return got[root]

    def broadcast(self, arr=None, root_index=0):
        root = self.members[root_index]
        if self.size == 1:
            return np.asarray(arr)
        data = _encode_array(arr) if self.rank == root else b""
        got = self._exchange("bcast", data)
        return np.asarray(arr) if self.rank == root \
            else _decode_array(got[root])

    def barrier(self):
        if self.size > 1:
            self._exchange("bar", b"1")

    # -- re-form protocol --
    def reform(self, extra_members=(), timeout=None):
        """Re-form the ring around the live members (plus any pending
        joiners). First-write-wins proposals under
        ``<ns>/reform/<gen+1>/prop/<attempt>`` converge every survivor on
        ONE membership; all-member acks double as the commit barrier.
        Returns the new member list.

        A member that died mid-reform is handled by attempt escalation:
        any member that sees a dead rank in the current proposal (and
        leads the live set) proposes attempt+1, and ack-waiters abort to
        the newer attempt.
        """
        gen2 = self.gen + 1
        deadline = time.time() + (timeout if timeout is not None
                                  else self.op_timeout)
        prop_prefix = "%s/reform/%d/prop/" % (self.ns, gen2)
        joiners = set(int(j) for j in extra_members)
        joiners |= set(self.poll_joiners())

        while True:
            if time.time() >= deadline:
                from .kvstore import KVStoreTimeoutError
                raise KVStoreTimeoutError(
                    "ring re-form to generation %d did not converge "
                    "within %.0fs" % (gen2, self.op_timeout), started=True)
            live = sorted(r for r in self.members
                          if r == self.rank or self.client.alive(r))
            props = self.client.dir(prop_prefix)
            attempts = sorted(int(k.rsplit("/", 1)[1]) for k in props)
            if not attempts:
                if self.rank == min(live):
                    # kv.reform_delay: a slow leader — the proposal lands
                    # late; followers keep polling (they converge once it
                    # appears) or hit the re-form deadline above
                    _faults.fire("kv.reform_delay")
                    prop = sorted(set(live) | joiners)
                    self.client.set(
                        prop_prefix + "0",
                        json.dumps({"members": prop,
                                    "joiners": sorted(joiners)}),
                        overwrite=False)
                if self.poll:
                    time.sleep(self.poll)
                continue
            att = attempts[-1]
            d = json.loads(props[prop_prefix + "%d" % att].decode())
            members = [int(m) for m in d["members"]]
            # the proposal's joiner list is the authoritative one: a
            # member whose own poll raced the join request still reaches
            # the same verdict as everyone else
            prop_joiners = set(int(j) for j in d.get("joiners", []))
            if self.rank not in members:
                self._lost([self.rank],
                           "this rank was evicted by re-form attempt %d"
                           % att)
            stale = [r for r in members
                     if r != self.rank and r not in prop_joiners
                     and not self.client.alive(r)]
            if stale:
                if self.rank == min(r for r in live if r in members):
                    _faults.fire("kv.reform_delay")
                    prop = sorted((set(members) - set(stale)) | joiners)
                    self.client.set(
                        prop_prefix + "%d" % (att + 1),
                        json.dumps({"members": prop,
                                    "joiners": sorted(joiners)}),
                        overwrite=False)
                if self.poll:
                    time.sleep(self.poll)
                continue
            # joiners don't ack — they learn the membership only from the
            # commit ticket; the barrier is across incumbents
            if self._ack_and_wait(
                    gen2, att,
                    [m for m in members if m not in prop_joiners],
                    deadline):
                self._commit(gen2, members, sorted(prop_joiners))
                return list(self.members)
            # a newer attempt superseded this one; loop and re-read

    def _ack_and_wait(self, gen2, att, members, deadline):
        ack = "%s/reform/%d/ack/%d/" % (self.ns, gen2, att)
        self.client.set(ack + "%d" % self.rank, b"ok")
        newer = "%s/reform/%d/prop/%d" % (self.ns, gen2, att + 1)
        while True:
            have = self.client.dir(ack)
            if all((ack + "%d" % r) in have for r in members):
                return True
            if self.client.get(newer) is not None:
                return False
            if time.time() >= deadline:
                from .kvstore import KVStoreTimeoutError
                raise KVStoreTimeoutError(
                    "re-form ack wait (gen %d attempt %d) timed out"
                    % (gen2, att), started=True)
            if self.poll:
                time.sleep(self.poll)

    def _commit(self, gen2, members, joiners):
        old = list(self.members)
        self.gen = gen2
        self.seq = 0
        self.members = sorted(members)
        self.dead = ()
        self._published = []
        DIST_HEALTH.reforms += 1
        DIST_HEALTH.workers = len(self.members)
        DIST_HEALTH.generation = self.gen
        # the new leader publishes the admission ticket for each joiner
        # and clears their requests
        if joiners and self.rank == self.members[0]:
            for j in joiners:
                self.client.set(
                    "%s/joined/%d" % (self.ns, j),
                    json.dumps({"gen": self.gen, "members": self.members}))
                self.client.delete("%s/join/%d" % (self.ns, j))
        _flight_dump(
            "ring re-formed: generation %d" % self.gen,
            extra={"members": list(self.members), "was": old,
                   "joiners": list(joiners),
                   "liveness": self.liveness_table()})

    # -- join protocol (late worker, epoch boundary) --
    def request_join(self, timeout=None):
        """Called by a late or rejoining worker: announce, then wait for
        an incumbent re-form to admit us. Adopts the committed generation
        and membership; the caller then warm-pulls current params
        (kvstore broadcast) before taking its first step."""
        self.client.set("%s/join/%d" % (self.ns, self.rank), b"ok")
        DIST_HEALTH.joins += 1
        key = "%s/joined/%d" % (self.ns, self.rank)
        deadline = time.time() + (timeout if timeout is not None
                                  else self.op_timeout)
        while True:
            v = self.client.get(key)
            if v is not None:
                d = json.loads(v.decode())
                self.gen = int(d["gen"])
                self.seq = 0
                self.members = sorted(int(m) for m in d["members"])
                self._published = []
                self.client.delete(key)
                DIST_HEALTH.workers = len(self.members)
                DIST_HEALTH.generation = self.gen
                return list(self.members)
            if time.time() >= deadline:
                from .kvstore import KVStoreTimeoutError
                raise KVStoreTimeoutError(
                    "join request was not admitted within %.0fs"
                    % self.op_timeout, started=True)
            if self.poll:
                time.sleep(self.poll)

    def poll_joiners(self):
        """Ranks currently requesting admission (non-blocking)."""
        prefix = "%s/join/" % self.ns
        out = []
        for k in self.client.dir(prefix):
            try:
                out.append(int(k.rsplit("/", 1)[1]))
            except ValueError:
                pass
        return sorted(r for r in out if r not in self.members)


# --------------------------------------------------------------------------
# the process-global ring over the launcher's store
# --------------------------------------------------------------------------

_shared = {}


def shared_ring():
    """The ONE process-wide ring over the launcher's ``TCPStore`` (every
    dist kvstore shares it, so the BSP sequence stream is unified), once
    ``kvstore_server.init_distributed`` has opened the store. Returns None
    with one worker."""
    r = _shared.get("ring")
    if r is not None:
        return r
    from . import kvstore_server
    plane = kvstore_server.plane()
    if plane is None or plane["size"] <= 1:
        return None
    ring = Ring(StoreClient(plane["store"]), plane["rank"],
                range(plane["size"]))
    _shared["ring"] = ring
    return ring


def _reset_shared_ring():
    _shared.pop("ring", None)
