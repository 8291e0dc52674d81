"""Declarative bench-knob table.

The port's copy of ``mxnet_tpu/autotune/benchcfg.py``. Every ``BENCH_*``
env knob of the repo's bench is declared here ONCE with its name, type
and default, and read through :func:`benv` — which routes integers and
floats through ``base.env_int``/``env_float`` so a junk spelling
(``BENCH_BATCH=12q``) raises :class:`~mxnet_tpu_torch.base.MXNetError`
naming the variable instead of a bare ``ValueError`` (or, worse, a silent
``int()`` truncation). The autotuner's programmatic path reads the same
table for harness defaults, so the CLI env path and the tuner can never
disagree about what a knob means.

A handful of defaults are mode-dependent (``BENCH_STEPS_PER_DISPATCH`` is
1 for the headline bench but 4 for the host-overhead/zoo/realdata modes);
call sites pass the mode default explicitly — the table records the
headline default.
"""
from __future__ import annotations

from collections import namedtuple

from ..base import MXNetError, env_float, env_int, env_str

BenchKnob = namedtuple("BenchKnob", ["name", "typ", "default"])

_UNSET = object()

#: the one declarative table: name -> (type, built-in default)
BENCH_KNOBS = {k.name: k for k in [
    # headline training bench
    BenchKnob("BENCH_BATCH", "int", 128),
    BenchKnob("BENCH_ROUNDS", "int", 3),
    BenchKnob("BENCH_DEPTH", "int", 50),
    BenchKnob("BENCH_IMAGE", "int", 224),
    BenchKnob("BENCH_DTYPE", "str", "bfloat16"),
    BenchKnob("BENCH_STEPS_PER_DISPATCH", "int", 1),
    BenchKnob("BENCH_DP_DEVICES", "int", 0),
    BenchKnob("BENCH_REMAT", "str", "off"),
    BenchKnob("BENCH_LAYOUT", "str", "NCHW"),
    BenchKnob("BENCH_STORAGE_DTYPE", "str", "float32"),
    # host-overhead mode
    BenchKnob("BENCH_HOST_OVERHEAD", "flag", False),
    BenchKnob("BENCH_HO_BATCH", "int", 64),
    BenchKnob("BENCH_HO_IMAGE", "int", 112),
    BenchKnob("BENCH_HO_BATCHES", "int", 32),
    BenchKnob("BENCH_CKPT_CADENCES", "str", "8,16"),
    # zoo-dispatch mode
    BenchKnob("BENCH_ZOO_DISPATCH", "flag", False),
    BenchKnob("BENCH_ZD_DEVICES", "int", 8),
    BenchKnob("BENCH_ZD_BATCH", "int", 0),        # 0 = 8 * devices
    BenchKnob("BENCH_ZD_DISPATCHES", "int", 6),
    BenchKnob("BENCH_ZD_IMAGE", "int", 64),
    BenchKnob("BENCH_ZD_SEQ", "int", 32),
    BenchKnob("BENCH_ZD_MODELS", "str", "ssd,transformer"),
    # real-data input-tier mode
    BenchKnob("BENCH_REAL_DATA", "flag", False),
    BenchKnob("BENCH_RD_BATCH", "int", 128),
    BenchKnob("BENCH_RD_IMAGE", "int", 224),
    BenchKnob("BENCH_RD_IMAGES", "int", 0),       # 0 = batch * k * 8
    BenchKnob("BENCH_RD_QUALITY", "int", 90),
    BenchKnob("BENCH_RD_MODEL", "str", "resnet"),
    BenchKnob("BENCH_RD_MEASURE", "str", "12,60"),
    # flagship-LM mode
    BenchKnob("BENCH_LM", "flag", False),
    BenchKnob("BENCH_LM_BATCH", "int", 32),
    BenchKnob("BENCH_LM_SEQ", "int", 128),
    BenchKnob("BENCH_LM_VOCAB", "int", 1024),
    BenchKnob("BENCH_LM_EMBED", "int", 256),
    BenchKnob("BENCH_LM_LAYERS", "int", 4),
    BenchKnob("BENCH_LM_HEADS", "int", 8),
    BenchKnob("BENCH_LM_DTYPE", "str", "bfloat16"),
    BenchKnob("BENCH_LM_MESHES", "str", "data=2;seq=2;data=2,seq=2"),
    # serving latency mode
    BenchKnob("BENCH_SERVE", "flag", False),
    BenchKnob("BENCH_SERVE_MODEL", "str", "mlp"),
    BenchKnob("BENCH_SERVE_QPS", "float", 200.0),
    BenchKnob("BENCH_SERVE_REQS", "int", 400),
    BenchKnob("BENCH_SERVE_CLIENTS", "int", 4),
    # decode-path mode (sampling / quantization / prefix / speculative)
    BenchKnob("BENCH_DECODE", "flag", False),
    BenchKnob("BENCH_DECODE_REQS", "int", 8),
    BenchKnob("BENCH_DECODE_NEW", "int", 24),
    BenchKnob("BENCH_DECODE_SLOTS", "int", 4),
    BenchKnob("BENCH_DECODE_VOCAB", "int", 64),
    BenchKnob("BENCH_DECODE_EMBED", "int", 32),
    BenchKnob("BENCH_DECODE_LAYERS", "int", 2),
    BenchKnob("BENCH_DECODE_HEADS", "int", 2),
    BenchKnob("BENCH_DECODE_LEN", "int", 64),
    BenchKnob("BENCH_DECODE_SPEC_K", "int", 2),
    # fleet mode
    BenchKnob("BENCH_FLEET", "flag", False),
    BenchKnob("BENCH_FLEET_REPLICAS", "int", 2),
    BenchKnob("BENCH_FLEET_QPS", "float", 500.0),
    BenchKnob("BENCH_FLEET_REQS", "int", 600),
    BenchKnob("BENCH_FLEET_SINGLE_REQS", "int", 200),
    BenchKnob("BENCH_FLEET_BATCH_FRAC", "float", 0.25),
    BenchKnob("BENCH_FLEET_DEVICE_MS", "float", 40.0),
    BenchKnob("BENCH_FLEET_DEADLINE_MS", "float", 20000.0),
    BenchKnob("BENCH_FLEET_MAX_BATCH", "int", 8),
    BenchKnob("BENCH_FLEET_MODEL", "str", "mlp"),
    BenchKnob("BENCH_FLEET_DRAIN", "flag", True),
]}


def benv(name, default=_UNSET):
    """Read one declared bench knob from the environment.

    Integer/float knobs parse through ``env_int``/``env_float`` (junk
    spellings raise :class:`MXNetError` naming the variable); ``flag``
    knobs treat blank/0/false/off/no as False, anything else True.
    ``default`` overrides the table default for mode-dependent knobs."""
    knob = BENCH_KNOBS.get(name)
    if knob is None:
        raise MXNetError("benv: %r is not a declared bench knob "
                         "(add it to autotune.benchcfg.BENCH_KNOBS)"
                         % (name,))
    d = knob.default if default is _UNSET else default
    if knob.typ == "int":
        return env_int(name, d)
    if knob.typ == "float":
        return env_float(name, d)
    if knob.typ == "flag":
        v = env_str(name)
        if not v:
            return bool(d)
        return v.lower() not in ("0", "false", "off", "no")
    return env_str(name, d)


def env_set(name):
    """Whether the knob is explicitly present (non-blank) in the
    environment — the precedence probe for env > tuning DB."""
    return bool(env_str(name))


def bench_defaults():
    """``{name: default}`` for the whole table (the autotuner's
    programmatic view of bench's built-in configuration)."""
    return {k.name: k.default for k in BENCH_KNOBS.values()}
