"""Model-level helpers, fault-tolerant checkpoints and the FeedForward
estimator (ref: python/mxnet/model.py).

Counterpart of ``mxnet_tpu/model.py``: the kvstore decision table and
update helpers, the atomic file write, the optimizer-states reader,
``save_checkpoint``/``load_checkpoint`` in the dmlc ``.params`` layout,
:class:`CheckpointManager` (checksummed manifests binding a checkpoint to
its training cursor, retention, fallback to the previous valid
checkpoint), :class:`AsyncCheckpointWriter` and :class:`FeedForward`.
Every file name and the manifest's layout are the JAX package's, so a
checkpoint from either package opens and resumes in the other.
``load_checkpoint`` and :meth:`CheckpointManager.load` put the arrays on
the host; the module that binds them copies them to its device.

One difference in the manifest: the JAX package records its random key
under ``rng``; the port records its generators' states under
``torch_rng``, which the JAX package does not read. A resume keeps its
own random state when the manifest holds only the other package's (the
port warns).
"""
from __future__ import annotations

import atexit
import base64
import errno
import glob
import hashlib
import json
import logging
import os
import threading
import time
from collections import namedtuple

import numpy as np

from .base import MXNetError
from . import dmlc_serial
from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym
from .context import cpu

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """The reference's decision table (ref: model.py _create_kvstore):
    ``(kvstore or None, update_on_kvstore)``. One device needs no store."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(np.prod(param.shape)
                               for param in arg_params.values())
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """ref: model.py _initialize_kvstore."""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Push each gradient, pull the updated weight back (ref: model.py)."""
    for index, (arg, grad) in enumerate(zip(param_arrays, grad_arrays)):
        if grad is None:
            continue
        kvstore.push(index, grad, priority=-index)
        kvstore.pull(index, arg, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Aggregate on the kvstore (where there is one), update locally
    (ref: model.py _update_params)."""
    for index, (arg, grad) in enumerate(zip(param_arrays, grad_arrays)):
        if grad is None:
            continue
        if kvstore:
            kvstore.push(index, grad, priority=-index)
            kvstore.pull(index, grad, priority=-index)
        updater(index, grad, arg)


def _fsync_dir(dirname):
    """Make a rename durable (the directory entry needs its own fsync);
    best effort where directories cannot be opened."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path, data):
    """Publish ``data`` at ``path`` atomically: temp file, fsync, rename. A
    crash mid-write leaves the previous file, never a truncated one.

    Fault sites: ``checkpoint.write`` (before any byte; a raise leaves the
    live file untouched, ``"truncate"`` publishes half the payload, the
    torn write a manifest's checksum catches), ``checkpoint.write.mid``
    (after half the payload: only an orphaned temp file is left) and
    ``ckpt.disk_full`` (ENOSPC after half the payload: the temp file is
    removed and an :class:`MXNetError` names the path and the remedy; a
    real ENOSPC takes the same path)."""
    from . import faults as _faults
    path = os.fspath(path)
    act = _faults.fire("checkpoint.write")
    tmp = "%s.tmp-%d" % (path, os.getpid())
    if act == "truncate":
        data = data[:max(1, len(data) // 2)]
    try:
        with open(tmp, "wb") as f:
            half = len(data) // 2
            f.write(data[:half])
            _faults.fire("checkpoint.write.mid")
            if _faults.fire("ckpt.disk_full") is not None:
                raise OSError(errno.ENOSPC, "No space left on device", tmp)
            f.write(data[half:])
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
    except OSError as e:
        if e.errno == errno.ENOSPC:
            raise MXNetError(
                "checkpoint write to %r failed: no space left on device "
                "(ENOSPC). The partial temp file was removed and the "
                "previous checkpoint generation is intact — free disk "
                "space (or point checkpoint_prefix at another volume) and "
                "re-run; resume='auto' continues from the newest valid "
                "checkpoint" % (path,)) from e
        raise
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def apply_optimizer_states(set_states, fname):
    """Read an optimizer-states file and feed it to ``set_states``; read
    errors and unpickling failures become MXNetErrors naming the file."""
    try:
        with open(fname, "rb") as fin:
            data = fin.read()
    except OSError as e:
        raise MXNetError(
            "cannot read optimizer states %r: %s — save them with "
            "save_optimizer_states (or Module.save_checkpoint("
            "save_optimizer_states=True)) before loading" % (fname, e))
    try:
        set_states(data)
    except MXNetError:
        raise
    except Exception as e:
        raise MXNetError(
            "optimizer states file %r is corrupt or truncated (%s: %s); "
            "re-save it or fall back to an earlier checkpoint"
            % (fname, type(e).__name__, e))


def _sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _as_host(v):
    """One array (NDArray, tensor or numpy) as a host numpy array."""
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _param_save_bytes(arg_params, aux_params):
    """The dmlc ``.params`` bytes of ``arg:``/``aux:`` prefixed arrays."""
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    names = list(save_dict.keys())
    return dmlc_serial.dumps([_as_host(save_dict[k]) for k in names], names)


def _split_param_dict(save_dict, fname):
    """Split a loaded ``{prefix:name: NDArray}`` dict into (arg, aux),
    rejecting malformed keys with an error naming the file and key."""
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        if ":" not in k:
            raise MXNetError(
                "invalid parameter file %r: key %r is malformed (expected "
                "'arg:<name>' or 'aux:<name>')" % (fname, k))
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError(
                "invalid parameter file %r: key %r has unknown prefix %r "
                "(expected 'arg' or 'aux')" % (fname, k, tp))
    return arg_params, aux_params


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save ``prefix-symbol.json`` and ``prefix-%04d.params`` (each
    atomically)."""
    if symbol is not None:
        atomic_write_bytes("%s-symbol.json" % prefix,
                           symbol.tojson().encode())
    param_name = "%s-%04d.params" % (prefix, epoch)
    atomic_write_bytes(param_name, _param_save_bytes(arg_params, aux_params))
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the arrays on
    the host."""
    symbol = sym.load("%s-symbol.json" % prefix)
    fname = "%s-%04d.params" % (prefix, epoch)
    save_dict = nd.load(fname, ctx=cpu())
    arg_params, aux_params = _split_param_dict(save_dict, fname)
    return (symbol, arg_params, aux_params)


# ---------------------------------------------------------------------------
# fault-tolerant checkpoints: every file lands through atomic_write_bytes,
# and a checksummed manifest binds the file set to a training cursor (epoch,
# batches, optimizer clock, random state, metric sums), so a load can prove
# a checkpoint whole before trusting it and fall back to the previous one
# ---------------------------------------------------------------------------

#: manifest version; 2 adds ``known_good`` (finite parameters checked at
#: save time). Resume and rollback refuse a manifest without the bit.
CKPT_VERSION = 2


def _rng_snapshot():
    """The port's random state for a manifest: the seed and each device
    generator's state (base64)."""
    from . import random as _random
    seed, gens = _random.get_state()
    return {"seed": int(seed),
            "generators": {str(dev): base64.b64encode(
                st.cpu().numpy().tobytes()).decode("ascii")
                for dev, st in gens.items()}}


class CheckpointState(object):
    """A validated checkpoint loaded by :class:`CheckpointManager` (the JAX
    package's slots). ``rng`` is the manifest's ``torch_rng`` entry when the
    port wrote it, else the JAX package's ``rng`` key (or None)."""

    __slots__ = ("tag", "epoch", "batches_done", "num_update", "fused_step",
                 "arg_params", "aux_params", "opt_states_file", "rng",
                 "metric_state", "manifest", "known_good")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))

    def restore_rng(self):
        """Restore the port's generators to their save-time states. A
        manifest holding only the JAX package's key cannot: the port warns
        and keeps its own state. Generators of devices this process lacks
        are skipped."""
        if not self.rng:
            return
        if "generators" not in self.rng:
            logging.warning(
                "checkpoint %s holds the JAX package's random key, which "
                "the port's generators cannot take; keeping the current "
                "random state (params, optimizer states and the cursor are "
                "restored)", self.tag)
            return
        import torch
        from . import random as _random
        gens = {}
        for dev, b64 in self.rng["generators"].items():
            dev = torch.device(dev)
            if dev.type == "cuda" and not torch.cuda.is_available():
                continue
            gens[dev] = torch.frombuffer(bytearray(base64.b64decode(b64)),
                                         dtype=torch.uint8)
        _random.set_state((int(self.rng["seed"]), gens))


class AsyncCheckpointWriter(object):
    """Background checkpoint writer: the training thread pays only for a
    snapshot (device copies of the parameters, aux and optimizer states,
    taken before :meth:`CheckpointManager.save` returns, so the in-place
    updates of later steps cannot reach it); the copy to the host, the
    serialization, sha256, the known-good check and the atomic
    params/states/manifest/latest sequence run on ONE writer thread.

    At most one save is in flight. A save submitted while another is
    still writing is shed and counted (``skipped``, and in the attached
    health sink's ``record_ckpt_skip``): back-pressure drops cadence
    rather than queueing full-model snapshots behind a slow disk. The
    writer runs the same atomic write sequence as a synchronous save, so a
    crash mid-save leaves the previous generation valid. ``fit`` waits in
    :meth:`drain` at epoch ends, rollbacks and teardown; :meth:`close` is
    registered with ``atexit``.

    Fault sites: ``ckpt.async_write`` fires on the writer thread before a
    job's first byte (the save is dropped and counted in ``errors``);
    ``ckpt.async_die`` ``"die"`` ends the writer thread mid-job: the next
    submit or drain reaps it (an error) and a later submit starts a new
    thread (``restarts``).
    """

    def __init__(self, logger=None, health=None):
        self.logger = logger or logging
        #: TrainingHealth-like sink for back-pressure skips (or None)
        self.health = health
        self.submitted = 0
        self.written = 0
        self.skipped = 0
        self.errors = 0
        self.restarts = 0
        self._cond = threading.Condition()
        self._job = None          # pending (not yet started) job
        self._busy = False        # a job is being written right now
        self._closed = False
        self._thread = None
        atexit.register(self.close)

    def _reap_dead_locked(self):
        """A writer thread that died mid-job: clear the in-flight state so
        ``drain`` cannot hang and ``submit`` can start a new thread. The
        lost job's temp files are orphans; its manifest and ``latest``
        were never written."""
        if ((self._busy or self._job is not None)
                and self._thread is not None
                and not self._thread.is_alive()):
            self._busy = False
            self._job = None
            self.errors += 1
            self.logger.warning(
                "AsyncCheckpointWriter: writer thread died mid-save; the "
                "in-flight checkpoint is lost (previous generation remains "
                "valid)")
            return True
        return False

    def busy(self):
        """True when a save is queued or being written (a submit now would
        be shed)."""
        with self._cond:
            self._reap_dead_locked()
            return self._busy or self._job is not None

    def note_skip(self, tag=None):
        """Record a shed save, here and in the attached health sink."""
        with self._cond:
            self.skipped += 1
        rec = getattr(self.health, "record_ckpt_skip", None)
        if rec is not None:
            rec()
        self.logger.warning(
            "async checkpoint%s skipped: previous save still in flight "
            "(slow disk? lengthen checkpoint_every_n_batches)",
            (" %s" % tag) if tag else "")

    def submit(self, fn):
        """Queue ``fn`` (the whole write job) for the writer thread. False,
        without running anything, while a save is in flight."""
        with self._cond:
            if self._closed:
                raise MXNetError("AsyncCheckpointWriter is closed")
            self._reap_dead_locked()
            if self._busy or self._job is not None:
                return False
            self.submitted += 1
            self._job = fn
            if self._thread is None or not self._thread.is_alive():
                if self._thread is not None:
                    self.restarts += 1
                self._thread = threading.Thread(
                    target=self._run, name="mxtpu-async-ckpt", daemon=True)
                self._thread.start()
            self._cond.notify_all()
            return True

    def _run(self):
        from . import faults as _faults
        from .obs import trace as _obs
        while True:
            with self._cond:
                while self._job is None and not self._closed:
                    self._cond.wait()
                if self._job is None:
                    return  # closed and drained
                fn = self._job
                self._job = None
                self._busy = True
            if _faults.fire("ckpt.async_die") == "die":
                return  # an abrupt death: in flight until reaped
            try:
                _faults.fire("ckpt.async_write")
                with _obs.span("checkpoint_write", async_=True):
                    fn()
                with self._cond:
                    self.written += 1
            except Exception as exc:
                with self._cond:
                    self.errors += 1
                self.logger.error(
                    "async checkpoint save failed (%s: %s); the previous "
                    "checkpoint generation remains the newest valid one",
                    type(exc).__name__, exc)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def drain(self, timeout=None):
        """Block until no save is in flight. True when the writer emptied
        cleanly; False on timeout or when the writer died mid-save."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cond:
            while self._busy or self._job is not None:
                if self._reap_dead_locked():
                    return False
                wait = 0.05  # poll: a dying thread never notifies
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        return False
                self._cond.wait(timeout=wait)
            return True

    def close(self):
        """Drain and stop the writer thread (idempotent; also the atexit
        hook, so the interpreter's exit waits for the in-flight save)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self.drain()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        try:
            atexit.unregister(self.close)
        except Exception:
            pass


class CheckpointManager(object):
    """Atomic, checksummed, self-validating training checkpoints.

    One checkpoint is a tag ``e<epoch>-b<batches>`` owning
    ``<prefix>-<tag>.params`` (and ``.states`` when an optimizer is live)
    and ``<prefix>-<tag>.manifest.json``, which holds each file's sha256
    and size and the training cursor (epoch, batches done, the optimizer's
    update count, the fused step count, the random state, the metric's
    partial sums). ``<prefix>-latest`` names the newest tag; the last
    ``keep`` checkpoints are kept, never pruning the newest known-good one.
    :meth:`load_latest` validates checksums newest first and falls back,
    with a warning, past a torn or corrupt checkpoint.
    """

    def __init__(self, prefix, keep=3, logger=None, save_rng=True,
                 async_writer=None):
        self.prefix = os.fspath(prefix)
        self.keep = max(1, int(keep))
        self.logger = logger or logging
        self.save_rng = save_rng
        #: an :class:`AsyncCheckpointWriter`: ``save`` then only snapshots
        #: and submits
        self.async_writer = async_writer
        #: the writer a finished ``fit`` closed and detached (its counters
        #: stay readable)
        self.last_async_writer = None
        #: seconds ``save`` spent on the caller's thread in all (the whole
        #: write when synchronous; snapshot and submit when asynchronous)
        self.save_time = 0.0
        d = os.path.dirname(os.path.abspath(self.prefix))
        if d and not os.path.isdir(d):
            os.makedirs(d, exist_ok=True)

    # -- naming ----------------------------------------------------------
    @staticmethod
    def _tag(epoch, batches_done):
        return "e%04d-b%08d" % (epoch, batches_done)

    def _file(self, tag, suffix):
        return "%s-%s.%s" % (self.prefix, tag, suffix)

    @property
    def latest_path(self):
        return "%s-latest" % self.prefix

    # -- save --------------------------------------------------------------
    def save(self, module, epoch, batches_done, metric=None):
        """Checkpoint a module's training state at a batch boundary;
        ``batches_done`` counts the completed batches of ``epoch``. Returns
        the tag, or None when an asynchronous save was shed. With an async
        writer the tag is written later: :meth:`drain` before trusting it
        on disk."""
        t0 = time.perf_counter()
        try:
            if self.async_writer is not None:
                tag = self._tag(epoch, batches_done)
                if self.async_writer.busy():
                    self.async_writer.note_skip(tag)
                    return None
                job = self._snapshot(module, epoch, batches_done,
                                     metric=metric, decouple=True)
                if job["needs_module"] is not None:
                    # no decoupled optimizer snapshot for this module: write
                    # synchronously
                    return self._write_job(job)
                if self.async_writer.submit(lambda: self._write_job(job)):
                    return tag
                self.async_writer.note_skip(tag)
                return None
            return self._write_job(
                self._snapshot(module, epoch, batches_done, metric=metric))
        finally:
            self.save_time += time.perf_counter() - t0

    def drain(self):
        """Block until an in-flight async save has landed; False when it
        was lost (the writer died)."""
        if self.async_writer is not None:
            return self.async_writer.drain()
        return True

    def _snapshot(self, module, epoch, batches_done, metric=None,
                  decouple=False):
        """Everything a checkpoint needs, taken on the training thread: the
        arrays, the cursor, the random state and the metric's sums.
        ``decouple=True`` (async) copies every array on its device first,
        so later in-place updates cannot reach the writer thread."""
        arg_params, aux_params = module.get_params()
        arg_params = dict(arg_params or {})
        aux_params = dict(aux_params or {})
        if decouple:
            def cp(v):
                return v.copy() if hasattr(v, "copy") else v
            arg_params = {n: cp(v) for n, v in arg_params.items()}
            aux_params = {n: cp(v) for n, v in aux_params.items()}
        job = {"tag": self._tag(epoch, batches_done), "epoch": int(epoch),
               "batches_done": int(batches_done),
               "arg_params": arg_params, "aux_params": aux_params,
               "states_fn": None, "needs_module": None, "symbol_json": None}
        if getattr(module, "optimizer_initialized", False):
            states_fn = None
            if decouple:
                snap = getattr(module, "_snapshot_opt_states", None)
                states_fn = snap() if snap is not None else None
            if states_fn is not None:
                job["states_fn"] = states_fn
            else:
                job["needs_module"] = module
        if getattr(module, "symbol", None) is not None:
            if not os.path.exists("%s-symbol.json" % self.prefix):
                job["symbol_json"] = module.symbol.tojson().encode()
        opt = getattr(module, "_optimizer", None)
        job["num_update"] = int(getattr(opt, "num_update", 0) or 0)
        # the fused step counter trails num_update by the guard's skipped
        # steps; read from the module's host-side mirror, never the device
        fused_step = getattr(module, "_fused_step_count", None)
        job["fused_step"] = fused_step() if callable(fused_step) else None
        job["rng"] = _rng_snapshot() if self.save_rng else None
        job["metric"] = self._metric_state(metric)
        return job

    def _write_job(self, job):
        """The heavy half of a save: to the host, serialization, sha256,
        the known-good check and the atomic writes in the order params,
        states, symbol (first save), manifest, latest. Inline for a
        synchronous save, on the writer thread for an async one; the bytes
        are the same either way."""
        tag = job["tag"]
        files = {}
        params_f = self._file(tag, "params")
        params_bytes = _param_save_bytes(job["arg_params"],
                                         job["aux_params"])
        atomic_write_bytes(params_f, params_bytes)
        # hash the intended payload, not a re-read: a write torn between
        # publish and durability then fails validation at load time
        files["params"] = {
            "name": os.path.basename(params_f),
            "size": len(params_bytes),
            "sha256": hashlib.sha256(params_bytes).hexdigest(),
        }
        states_bytes = None
        if job["states_fn"] is not None:
            states_f = self._file(tag, "states")
            states_bytes = job["states_fn"]()
            atomic_write_bytes(states_f, states_bytes)
        elif job["needs_module"] is not None:
            states_f = self._file(tag, "states")
            states_bytes = job["needs_module"].save_optimizer_states(states_f)
            if not isinstance(states_bytes, (bytes, bytearray)):
                with open(states_f, "rb") as f:
                    states_bytes = f.read()
        if states_bytes is not None:
            files["states"] = {
                "name": os.path.basename(states_f),
                "size": len(states_bytes),
                "sha256": hashlib.sha256(bytes(states_bytes)).hexdigest(),
            }
        if job["symbol_json"] is not None:
            sym_f = "%s-symbol.json" % self.prefix
            if not os.path.exists(sym_f):
                atomic_write_bytes(sym_f, job["symbol_json"])
        known_good = self._params_finite(job["arg_params"],
                                         job["aux_params"])
        from . import faults as _faults
        if _faults.fire_flag("guard.param_nan"):
            known_good = False
        if not known_good:
            self.logger.warning(
                "checkpoint %s: params are NOT all finite — saving anyway "
                "(post-mortem value) but not marking it known-good; "
                "resume/rollback will skip it", tag)
        manifest = {
            "version": CKPT_VERSION,
            "tag": tag,
            "epoch": job["epoch"],
            "batches_done": job["batches_done"],
            "num_update": job["num_update"],
            "known_good": bool(known_good),
            "files": files,
        }
        if job["fused_step"] is not None:
            manifest["fused_step"] = int(job["fused_step"])
        if job["rng"] is not None:
            manifest["torch_rng"] = job["rng"]
        if job["metric"] is not None:
            manifest["metric"] = job["metric"]
        atomic_write_bytes(self._file(tag, "manifest.json"),
                           json.dumps(manifest, indent=1).encode())
        atomic_write_bytes(self.latest_path, tag.encode())
        self._prune()
        self.logger.info("Saved checkpoint %s (epoch %d, %d batches done)",
                         tag, job["epoch"], job["batches_done"])
        return tag

    @staticmethod
    def _params_finite(arg_params, aux_params):
        """Every floating parameter and aux array is finite."""
        for tree in (arg_params, aux_params):
            for v in (tree or {}).values():
                a = _as_host(v)
                if (np.issubdtype(a.dtype, np.floating)
                        and not np.isfinite(a).all()):
                    return False
        return True

    @staticmethod
    def _metric_state(metric):
        """An EvalMetric's partial sums when they are a plain JSON-able
        ``(sum_metric, num_inst)`` pair; composites skip."""
        if metric is None or not hasattr(metric, "sum_metric"):
            return None
        s, n = metric.sum_metric, metric.num_inst
        try:
            json.dumps([s, n])
        except (TypeError, ValueError):
            return None
        return [s, n]

    # -- load --------------------------------------------------------------
    def list_tags(self):
        """Every tag with a manifest on disk, oldest first."""
        # glob.escape: a prefix holding [ ? * must not read as a pattern
        pat = "%s-*.manifest.json" % glob.escape(self.prefix)
        plen = len(self.prefix) + 1
        return sorted(p[plen:-len(".manifest.json")] for p in glob.glob(pat))

    def load(self, tag):
        """Load and validate one checkpoint; an :class:`MXNetError` names
        the file and the failure (missing, truncated, checksum mismatch,
        unparseable manifest) when it is not whole."""
        man_f = self._file(tag, "manifest.json")
        try:
            with open(man_f, "rb") as f:
                manifest = json.loads(f.read().decode())
        except OSError as e:
            raise MXNetError("checkpoint %s: cannot read manifest %r: %s"
                             % (tag, man_f, e))
        except ValueError as e:
            raise MXNetError("checkpoint %s: manifest %r is corrupt: %s"
                             % (tag, man_f, e))
        if manifest.get("version", 0) > CKPT_VERSION:
            raise MXNetError(
                "checkpoint %s: manifest version %s is newer than this "
                "build supports (%d)" % (tag, manifest.get("version"),
                                         CKPT_VERSION))
        base_dir = os.path.dirname(os.path.abspath(self.prefix))
        paths = {}
        for role, info in manifest.get("files", {}).items():
            path = os.path.join(base_dir, info["name"])
            if not os.path.exists(path):
                raise MXNetError("checkpoint %s: file %r is missing"
                                 % (tag, path))
            size = os.path.getsize(path)
            if size != info["size"]:
                raise MXNetError(
                    "checkpoint %s: file %r is truncated (%d bytes, "
                    "manifest says %d)" % (tag, path, size, info["size"]))
            digest = _sha256_file(path)
            if digest != info["sha256"]:
                raise MXNetError(
                    "checkpoint %s: checksum mismatch for %r (sha256 %s, "
                    "manifest says %s)" % (tag, path, digest,
                                           info["sha256"]))
            paths[role] = path
        if "params" not in paths:
            raise MXNetError("checkpoint %s: manifest lists no params file"
                             % tag)
        save_dict = nd.load(paths["params"], ctx=cpu())
        arg_params, aux_params = _split_param_dict(save_dict,
                                                   paths["params"])
        return CheckpointState(
            tag=tag, epoch=int(manifest["epoch"]),
            batches_done=int(manifest["batches_done"]),
            num_update=int(manifest.get("num_update", 0)),
            fused_step=manifest.get("fused_step"),
            arg_params=arg_params, aux_params=aux_params,
            opt_states_file=paths.get("states"),
            rng=manifest.get("torch_rng") or manifest.get("rng"),
            metric_state=manifest.get("metric"),
            manifest=manifest, known_good=manifest.get("known_good"))

    def load_latest(self, require_known_good=True):
        """The newest valid checkpoint, or None: the entry point of resume
        and of the guard's rollback. Tags are tried newest first (the
        ``latest`` pointer only as a fallback: a crash between the manifest
        and the pointer leaves it one save behind); a torn or corrupt one
        is skipped with a warning, and so, with ``require_known_good``,
        is one whose manifest lacks ``known_good: true``."""
        candidates = list(reversed(self.list_tags()))
        try:
            with open(self.latest_path) as f:
                pointed = f.read().strip()
            if pointed and pointed not in candidates:
                candidates.append(pointed)
        except OSError:
            pass
        for tag in candidates:
            try:
                st = self.load(tag)
            except MXNetError as e:
                self.logger.warning(
                    "checkpoint %s failed validation (%s); falling back to "
                    "the previous checkpoint", tag, e)
                continue
            if require_known_good and st.known_good is not True:
                self.logger.warning(
                    "checkpoint %s is not marked known-good (non-finite "
                    "params at save time, or a pre-guard manifest); "
                    "skipping it for resume/rollback", tag)
                continue
            return st
        return None

    # -- adoption of another manager's checkpoint ---------------------------
    def export_latest(self):
        """The newest known-good checkpoint (manifest, its files and the
        symbol file) as one bytes blob; ``b""`` when none is loadable."""
        import pickle
        st = self.load_latest()
        if st is None:
            return b""
        base_dir = os.path.dirname(os.path.abspath(self.prefix))
        payload = {"tag": st.tag, "manifest": st.manifest, "files": {}}
        for info in st.manifest.get("files", {}).values():
            with open(os.path.join(base_dir, info["name"]), "rb") as f:
                payload["files"][info["name"]] = f.read()
        sym_f = "%s-symbol.json" % self.prefix
        if os.path.exists(sym_f):
            with open(sym_f, "rb") as f:
                payload["files"][os.path.basename(sym_f)] = f.read()
        return pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)

    def import_blob(self, blob):
        """Install a checkpoint from :meth:`export_latest` under this
        manager's directory in a native save's order (files, manifest,
        ``latest`` last), so a crash mid-import publishes nothing partial.
        Returns the tag."""
        import pickle
        payload = pickle.loads(blob)
        base_dir = os.path.dirname(os.path.abspath(self.prefix))
        manifest = payload["manifest"]
        listed = {i["name"] for i in manifest.get("files", {}).values()}
        for name, data in payload["files"].items():
            path = os.path.join(base_dir, name)
            # the symbol file is shared across tags: the first write wins
            if name in listed or not os.path.exists(path):
                atomic_write_bytes(path, data)
        atomic_write_bytes(self._file(payload["tag"], "manifest.json"),
                           json.dumps(manifest, indent=1).encode())
        atomic_write_bytes(self.latest_path, payload["tag"].encode())
        self.logger.info("Adopted checkpoint %s", payload["tag"])
        return payload["tag"]

    # -- retention -----------------------------------------------------------
    def _read_manifest(self, tag):
        try:
            with open(self._file(tag, "manifest.json"), "rb") as f:
                return json.loads(f.read().decode())
        except (OSError, ValueError):
            return None

    def _prune(self):
        tags = self.list_tags()
        old = tags[:-self.keep]
        if not old:
            return
        # a run whose params went non-finite keeps writing post-mortem
        # checkpoints; age-only retention would push the last resumable one
        # out, so the newest known-good tag is never pruned
        newest_good = None
        for tag in reversed(tags):
            man = self._read_manifest(tag)
            if man is not None and man.get("known_good") is True:
                newest_good = tag
                break
        base_dir = os.path.dirname(os.path.abspath(self.prefix))
        for tag in old:
            if tag == newest_good:
                continue
            manifest = self._read_manifest(tag)
            if manifest is not None:
                victims = [os.path.join(base_dir, i["name"])
                           for i in manifest.get("files", {}).values()]
            else:
                victims = [self._file(tag, "params"),
                           self._file(tag, "states")]
            for path in victims + [self._file(tag, "manifest.json")]:
                try:
                    os.unlink(path)
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# FeedForward: the legacy estimator, a thin shell over Module
# ---------------------------------------------------------------------------

def _init_iter(X, y, batch_size, is_train=True):
    from . import io
    if isinstance(X, io.DataIter):
        return X
    if isinstance(X, nd.NDArray):
        X = X.asnumpy()
    X = np.asarray(X)
    if y is not None:
        if isinstance(y, nd.NDArray):
            y = y.asnumpy()
        y = np.asarray(y)
    if is_train:
        return io.NDArrayIter(X, y, min(X.shape[0], batch_size),
                              shuffle=is_train, last_batch_handle="roll_over")
    return io.NDArrayIter(X, y, min(X.shape[0], batch_size), shuffle=False)


class FeedForward(object):
    """Legacy estimator API (ref: model.py FeedForward), deprecated in the
    reference too: ``fit``, ``predict``, ``score``, ``save``, ``load`` and
    ``create`` over a :class:`~mxnet_tpu_torch.module.Module` on ``ctx``
    (the current context, the card, by default)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .context import current_context
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = ctx if ctx is not None else [current_context()]
        if not isinstance(self.ctx, list):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = (initializer if initializer is not None
                            else Uniform(0.01))
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    def _label_names(self):
        args = set(self.symbol.list_arguments())
        for cand in ("softmax_label", "label", "lro_label"):
            if cand in args:
                return [cand]
        labels = [a for a in self.symbol.list_arguments()
                  if a.endswith("_label") or a == "label"]
        return labels or ["softmax_label"]

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        from . import io
        from .module.module import Module
        data = _init_iter(X, y, self.numpy_batch_size, is_train=True)
        if eval_data is not None and not isinstance(eval_data, io.DataIter):
            ex, ey = eval_data
            eval_data = _init_iter(ex, ey, self.numpy_batch_size,
                                   is_train=False)
        if self.epoch_size is not None:
            data = io.ResizeIter(data, self.epoch_size)
        label_names = [d.name for d in (data.provide_label or [])] \
            or self._label_names()
        self._module = Module(self.symbol,
                              data_names=[d.name for d in data.provide_data],
                              label_names=label_names,
                              context=self.ctx, logger=logger or logging)
        self._module.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, optimizer=self.optimizer,
                         optimizer_params=dict(self.kwargs),
                         eval_end_callback=eval_end_callback,
                         eval_batch_end_callback=eval_batch_end_callback,
                         initializer=self.initializer,
                         arg_params=self.arg_params,
                         aux_params=self.aux_params,
                         begin_epoch=self.begin_epoch,
                         num_epoch=self.num_epoch, monitor=monitor)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        from .module.module import Module
        data = _init_iter(X, None, self.numpy_batch_size, is_train=False)
        if self._module is None or not self._module.binded:
            self._module = Module(self.symbol,
                                  data_names=[d.name
                                              for d in data.provide_data],
                                  label_names=None, context=self.ctx)
            self._module.bind(data_shapes=data.provide_data,
                              label_shapes=None, for_training=False)
            # with label_names=None the label variable counts as a parameter
            # the checkpoint never stores; only label variables may be
            # absent: a missing weight must fail, not predict garbage
            data_names = set(d.name for d in data.provide_data)
            missing = [n for n in self.symbol.list_arguments()
                       if n not in data_names
                       and n not in self._label_names()
                       and n not in (self.arg_params or {})]
            missing += [n for n in self.symbol.list_auxiliary_states()
                        if n not in (self.aux_params or {})]
            if missing:
                raise MXNetError(
                    "predict: loaded params are missing weight/aux "
                    "state(s) %s — wrong or incomplete checkpoint?"
                    % (missing,))
            self._module.set_params(self.arg_params, self.aux_params or {},
                                    allow_missing=True)
        out = self._module.predict(data, num_batch=num_batch, reset=reset)
        if isinstance(out, list):
            return [o.asnumpy() for o in out]
        return out.asnumpy()

    def score(self, X, y=None, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        data = _init_iter(X, y, self.numpy_batch_size, is_train=False)
        if self._module is None:
            raise MXNetError("FeedForward.score: fit or predict first")
        res = self._module.score(data, eval_metric, num_batch=num_batch,
                                 batch_end_callback=batch_end_callback,
                                 reset=reset)
        return res[0][1]

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
