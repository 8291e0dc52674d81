"""One metrics registry for the process.

The port's own copy of ``mxnet_tpu/obs/registry.py`` (pure Python; the
port imports nothing of the JAX package):

- **Typed instruments**: :class:`Counter` (monotonic), :class:`Gauge`
  (set-to-latest), :class:`Histogram` (count/sum/min/max) created through
  :meth:`Registry.counter` etc. The serving tier counts
  ``serving.param_reloads`` here, the tuning-DB resolvers
  ``autotune.db_resolutions`` and ``autotune.db_mismatches``.
- **Views**: a named callable returning a flat ``{key: value}`` dict. The
  process-global counter objects are registered as views:
  ``io.DATA_HEALTH`` (``data_health``), ``guard.TRAINING_HEALTH``
  (``training_health``), ``serving.SERVING_HEALTH`` (``serving_health``),
  ``data.PIPELINE_STATS`` (``pipeline_stats``),
  ``tracecheck.retrace_count()`` (``retrace_events``) and
  ``dist_ring.DIST_HEALTH`` (``dist_health``).
- **Snapshots**: :meth:`Registry.snapshot` flattens everything to
  ``{"view.key": value}`` (the flight recorder's dump carries one);
  :meth:`Registry.to_prometheus` renders the same snapshot as a
  Prometheus textfile exposition.
- **Windowed deltas**: :class:`Window` wraps any snapshot-shaped callable
  (:meth:`Registry.window`) and gives per-window differences; the flight
  recorder's per-dispatch counter deltas read one.
"""
from __future__ import annotations

import threading

from ..base import MXNetError

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "Window",
           "REGISTRY", "register_default_views"]


class _Instrument(object):
    __slots__ = ("name", "help", "_lock")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotonically increasing count (Prometheus ``counter``)."""

    __slots__ = ("_value",)
    kind = "counter"

    def __init__(self, name, help=""):
        super().__init__(name, help)
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise MXNetError("Counter %r: inc() must be >= 0, got %r"
                             % (self.name, n))
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def values(self):
        return {"": self.value}


class Gauge(_Instrument):
    """Set-to-latest value (Prometheus ``gauge``)."""

    __slots__ = ("_value",)
    kind = "gauge"

    def __init__(self, name, help=""):
        super().__init__(name, help)
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = float(v)

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    def values(self):
        return {"": self.value}


class Histogram(_Instrument):
    """Aggregated distribution: count / sum / min / max (enough for
    p-less latency accounting without per-sample storage; full quantiles
    ride the trace file, where every span IS a sample)."""

    __slots__ = ("_count", "_sum", "_min", "_max")
    kind = "histogram"

    def __init__(self, name, help=""):
        super().__init__(name, help)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def values(self):
        with self._lock:
            return {"_count": self._count, "_sum": self._sum,
                    "_min": self._min if self._min is not None else 0.0,
                    "_max": self._max if self._max is not None else 0.0}


class Registry(object):
    """Instrument + view namespace with one flat snapshot.

    Names are dot-separated (``serve.request_latency``); a snapshot key is
    ``<name>`` for instruments and ``<view>.<key>`` for view entries.
    Registering a taken name raises (a silent shadow would split counts
    between two objects)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments = {}
        self._views = {}

    # -- instruments ---------------------------------------------------
    def _add(self, cls, name, help):
        with self._lock:
            cur = self._instruments.get(name)
            if cur is not None:
                if type(cur) is not cls:
                    raise MXNetError(
                        "registry: %r already registered as %s"
                        % (name, cur.kind))
                return cur  # idempotent re-get (module reimport, tests)
            if name in self._views:
                raise MXNetError("registry: %r is a registered view" % name)
            inst = cls(name, help)
            self._instruments[name] = inst
            return inst

    def counter(self, name, help=""):
        return self._add(Counter, name, help)

    def gauge(self, name, help=""):
        return self._add(Gauge, name, help)

    def histogram(self, name, help=""):
        return self._add(Histogram, name, help)

    # -- views ---------------------------------------------------------
    def register_view(self, name, fn):
        """Register ``fn() -> {key: value}`` under ``name``. Re-registering
        the same name replaces the callable (the legacy globals are
        process singletons; a test reloading a module must not brick the
        registry)."""
        with self._lock:
            if name in self._instruments:
                raise MXNetError(
                    "registry: %r is a registered instrument" % name)
            self._views[name] = fn

    def view_names(self):
        with self._lock:
            return sorted(self._views)

    # -- reading -------------------------------------------------------
    def snapshot(self):
        """One flat dict over every instrument and view. View callables
        that raise contribute an ``<name>.error`` marker instead of
        breaking the snapshot (a snapshot is a diagnostic read — it must
        never take down the path asking for it)."""
        with self._lock:
            instruments = list(self._instruments.values())
            views = list(self._views.items())
        out = {}
        for inst in instruments:
            for suffix, v in inst.values().items():
                out[inst.name + suffix] = v
        for name, fn in views:
            try:
                vals = fn()
            except Exception as e:
                out["%s.error" % name] = "%s: %s" % (type(e).__name__, e)
                continue
            for k, v in (vals or {}).items():
                out["%s.%s" % (name, k)] = v
        return out

    def window(self, source=None):
        """A :class:`Window` over this registry's snapshot (or any other
        snapshot-shaped callable)."""
        return Window(source if source is not None else self.snapshot)

    def to_prometheus(self):
        """Prometheus textfile exposition of :meth:`snapshot`. Non-numeric
        values (last_error strings) are skipped, as Prometheus samples are
        float64, and key characters outside ``[a-zA-Z0-9_:]`` become
        ``_``. Instruments get a ``# TYPE`` line (a histogram's is
        ``untyped``, its four keys being plain samples)."""
        lines = []
        with self._lock:
            instruments = sorted(self._instruments.values(),
                                 key=lambda i: i.name)
        typed = {}
        for inst in instruments:
            typed[_prom_name(inst.name)] = inst.kind
        snap = self.snapshot()
        seen_types = set()
        for key in sorted(snap):
            v = snap[key]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            name = _prom_name(key)
            base = name
            for suf in ("_count", "_sum", "_min", "_max"):
                if base.endswith(suf):
                    base = base[:-len(suf)]
                    break
            kind = typed.get(base)
            if kind and base not in seen_types:
                seen_types.add(base)
                lines.append("# TYPE %s %s"
                             % (base, "untyped" if kind == "histogram"
                                else kind))
            lines.append("%s %s" % (name, repr(float(v))
                                    if isinstance(v, float) else v))
        return "\n".join(lines) + "\n"


def _prom_name(key):
    out = []
    for ch in key:
        out.append(ch if (ch.isalnum() and ch.isascii()) or ch in "_:"
                   else "_")
    name = "".join(out)
    if name and name[0].isdigit():
        name = "_" + name
    return name


class Window(object):
    """Windowed-delta reader over a snapshot-shaped callable.

    ``delta()`` returns ``{key: current - baseline}`` for every numeric
    key and advances the baseline; non-numeric values (a last_error
    string) ride through as their current value. ``rebase()`` resets the
    baseline to now without reporting, so a consumer reused for a second
    run does not count the first run's accumulation in its first window.
    A window made with ``key=`` folds ``delta(src)`` only when ``src`` is
    that key, so an observation of another source (a ``score()`` in the
    middle of a ``fit``) does not advance its baseline.
    """

    def __init__(self, source, key=None):
        if not callable(source):
            raise MXNetError("Window: source must be callable")
        self._source = source
        #: identity key: delta(src=...) only folds when src matches
        self._key = key
        self._base = dict(source() or {})

    def rebase(self):
        self._base = dict(self._source() or {})

    def matches(self, src):
        return self._key is None or src is self._key

    def peek(self):
        """Current minus baseline without advancing the baseline: the
        cumulative reading since the window began, beside :meth:`delta`'s
        per-window one."""
        cur = dict(self._source() or {})
        out = {}
        for k, v in cur.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                out[k] = v
                continue
            b = self._base.get(k)
            out[k] = v - b if isinstance(b, (int, float)) \
                and not isinstance(b, bool) else v
        return out

    def delta(self, src=None):
        """Current minus baseline for numeric keys; advances the baseline.
        When the window is keyed and ``src`` does not match, returns None
        and leaves the baseline as it is."""
        if src is not None and not self.matches(src):
            return None
        cur = dict(self._source() or {})
        out = {}
        for k, v in cur.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                out[k] = v
                continue
            b = self._base.get(k)
            out[k] = v - b if isinstance(b, (int, float)) \
                and not isinstance(b, bool) else v
        self._base = cur
        return out


#: the process-global registry (the flight recorder's dump snapshots it)
REGISTRY = Registry()

_default_views_done = False


def register_default_views(registry=None):
    """Register the process-global counter objects as views
    (``data_health``, ``training_health``, ``serving_health``,
    ``pipeline_stats``, ``retrace_events``, ``dist_health``). Each view imports its owner when it is read (obs
    must stay importable before io, the guard and the serving tier); the
    call is idempotent. Called from the ``mxnet_tpu_torch.obs`` import."""
    global _default_views_done
    reg = registry or REGISTRY
    if registry is None and _default_views_done:
        return reg

    def data_health():
        from .. import io as _io
        return _io.DATA_HEALTH.report()

    def training_health():
        from .. import guard as _guard
        return _guard.TRAINING_HEALTH.report()

    def serving_health():
        from ..serving import health as _sh
        return _sh.SERVING_HEALTH.report()

    def pipeline_stats():
        from ..data import stats as _st
        return _st.PIPELINE_STATS.report()

    def retrace_events():
        from .. import tracecheck as _tc
        return {"count": _tc.retrace_count()}

    def dist_health():
        from .. import dist_ring as _dr
        return _dr.DIST_HEALTH.report()

    reg.register_view("data_health", data_health)
    reg.register_view("training_health", training_health)
    reg.register_view("serving_health", serving_health)
    reg.register_view("pipeline_stats", pipeline_stats)
    reg.register_view("retrace_events", retrace_events)
    reg.register_view("dist_health", dist_health)
    if registry is None:
        _default_views_done = True
    return reg
