"""Base types and helpers for mxnet_tpu_torch.

The port's own copy of ``mxnet_tpu/base.py``: the error type, the attribute
coercion that lets symbol JSON round-trip (op attrs arrive either as native
Python values or as their string forms), and the environment-knob readers.
"""
from __future__ import annotations

import os

__version__ = "0.1.0"


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch (parity: dmlc error -> Python)."""


_NULL = object()  # sentinel for "unset" attr values


def attr_bool(v, default=None):
    if v is _NULL or v is None:
        return default
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1"):
        return True
    if s in ("false", "0"):
        return False
    raise MXNetError("cannot parse bool attr: %r" % (v,))


def attr_int(v, default=None):
    if v is _NULL or v is None:
        return default
    if isinstance(v, bool):
        return int(v)
    return int(v)


def attr_float(v, default=None):
    if v is _NULL or v is None:
        return default
    return float(v)


def attr_str(v, default=None):
    if v is _NULL or v is None:
        return default
    return str(v)


def attr_tuple(v, default=None, typ=int):
    """Parse '(2, 2)' / '[2,2]' / (2, 2) / 2 into a tuple."""
    if v is _NULL or v is None:
        return default
    if isinstance(v, (tuple, list)):
        return tuple(typ(x) for x in v)
    if isinstance(v, (int, float)):
        return (typ(v),)
    s = str(v).strip()
    if s.startswith(("(", "[")):
        s = s[1:-1]
    s = s.strip()
    if not s:
        return ()
    return tuple(typ(float(x)) if typ is int and ("." in x) else typ(x)
                 for x in (p.strip() for p in s.split(",")) if x)


def env_float(name, default):
    """Parse an env var as a float knob; unset or blank means ``default``."""
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise MXNetError("%s must be a number, got %r" % (name, v))


def env_int(name, default):
    """Parse an env var as an integer knob; unset or blank means
    ``default``. Non-integer spellings raise an :class:`MXNetError` naming
    the variable instead of silently truncating."""
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    try:
        return int(v.strip())
    except ValueError:
        raise MXNetError("%s must be an integer, got %r" % (name, v))


def env_bool(name):
    """Parse an env var as an on/off switch: unset, blank, and the usual
    "off" spellings are False, anything else True."""
    return os.environ.get(name, "").strip().lower() \
        not in ("", "0", "false", "off", "no")


def env_str(name, default=""):
    """Read an env var as a stripped string knob; unset or blank means
    ``default``."""
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    return v.strip()


def shape_str(shape):
    return "(" + ",".join(str(int(x)) for x in shape) + ")"
