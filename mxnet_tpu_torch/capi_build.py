"""Build the port's C API library and its C client.

``csrc/capi/libmxnet_tpu_torch.c`` embeds CPython and marshals each
exported ``MX*`` function into :mod:`mxnet_tpu_torch.c_api`;
``csrc/capi/card_client.c`` is a pure-C client of it. Both are compiled
with ``cc`` and the flags of ``python3-config --includes`` and
``--ldflags --embed`` into one directory under ``_build/`` whose name is a
digest of the sources and the flags (a changed source builds anew):

- ``libmxnet_tpu_torch.so``, the library (``-fvisibility=hidden``: only
  the ``MX*`` functions are exported);
- ``card_client``, the client's executable;
- ``libcard_client.so``, the same client with ``card_client_run(argc,
  argv)`` in place of ``main``, for a process that already runs Python
  (``ctypes``), where the library finds the interpreter initialised.

The directory is built under a private name and renamed into place, so
processes that build at once never see half of it. The build runs at first
use, never at import; a failed build raises :class:`MXNetError` with the
compiler's output. ``python -m mxnet_tpu_torch.capi_build`` builds and
prints the library's path.

A C program that links the library runs its own interpreter, which knows
only the installation's own ``sys.path``: :func:`client_env` gives it this
interpreter's path (the repository and its site-packages).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading

from .base import MXNetError

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc", "capi")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = "libmxnet_tpu_torch.c"
CLIENT = "card_client.c"
#: the JAX package's ``src/capi/Makefile`` flags for the library
LIB_FLAGS = ("-O2", "-fPIC", "-shared", "-fvisibility=hidden")
CLIENT_FLAGS = ("-O2", "-pthread")

_LOCK = threading.Lock()
_BUILT = {}


def _config_script():
    """The ``python3-config`` of this interpreter's version."""
    ver = "python%d.%d-config" % sys.version_info[:2]
    for cand in (os.path.join(os.path.dirname(sys.executable), ver),
                 os.path.join(sys.base_prefix, "bin", ver),
                 shutil.which(ver), shutil.which("python3-config")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("no python3-config for Python %d.%d: the C API "
                     "library embeds CPython and links libpython"
                     % sys.version_info[:2])


def python_flags():
    """``(includes, ldflags)`` of ``python3-config --includes`` and
    ``--ldflags --embed``, with an rpath for each ``-L`` directory so the
    library finds libpython where the linker did."""
    script = _config_script()

    def ask(*args):
        p = subprocess.run([script, *args], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if p.returncode != 0:
            raise MXNetError("%s %s failed (exit %d): %s"
                             % (script, " ".join(args), p.returncode,
                                p.stdout))
        return p.stdout.split()
    includes = ask("--includes")
    ldflags = ask("--ldflags", "--embed")
    rpaths = ["-Wl,-rpath,%s" % f[2:] for f in ldflags
              if f.startswith("-L") and os.path.isdir(f[2:])]
    return includes, ldflags + rpaths


def _cc():
    cc = os.environ.get("CC") or shutil.which("cc")
    if not cc:
        raise MXNetError("no C compiler found (cc or $CC): the C API "
                         "library is built from %s at first use" % SRC_DIR)
    return cc


def _commands(out, includes, ldflags):
    """The three compile lines, writing into directory ``out``."""
    cc = _cc()
    lib = os.path.join(SRC_DIR, LIBRARY)
    client = os.path.join(SRC_DIR, CLIENT)
    link = ["-L%s" % out, "-lmxnet_tpu_torch", "-Wl,-rpath,$ORIGIN"]
    return [
        [cc, *LIB_FLAGS, *includes, "-o",
         os.path.join(out, "libmxnet_tpu_torch.so"), lib, *ldflags],
        [cc, *CLIENT_FLAGS, "-o", os.path.join(out, "card_client"), client,
         *link, "-lm"],
        [cc, *CLIENT_FLAGS, "-fPIC", "-shared", "-DCARD_CLIENT_NO_MAIN",
         "-o", os.path.join(out, "libcard_client.so"), client, *link,
         "-lm"],
    ]


def _target(includes, ldflags):
    """The build directory of the current sources and these flags."""
    h = hashlib.sha256()
    for name in (LIBRARY, CLIENT):
        path = os.path.join(SRC_DIR, name)
        if not os.path.exists(path):
            raise MXNetError("no C API source %s" % path)
        with open(path, "rb") as f:
            h.update(f.read())
    for cmd in _commands("OUT", includes, ldflags):
        h.update(" ".join(cmd).encode())
    return os.path.join(BUILD_DIR, "capi-%s" % h.hexdigest()[:16])


def build():
    """Build the library and the client if they are missing; returns
    ``{"dir", "library", "client", "client_lib"}``. Raises
    :class:`MXNetError` with the compiler's output on a failed build."""
    with _LOCK:
        includes, ldflags = python_flags()
        out = _target(includes, ldflags)
        if out not in _BUILT:
            if not os.path.isdir(out):
                _build_into(out, includes, ldflags)
            _BUILT[out] = {
                "dir": out,
                "library": os.path.join(out, "libmxnet_tpu_torch.so"),
                "client": os.path.join(out, "card_client"),
                "client_lib": os.path.join(out, "libcard_client.so")}
        return dict(_BUILT[out])


def _build_into(out, includes, ldflags):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(out) + ".tmp",
                           dir=BUILD_DIR)
    try:
        for cmd in _commands(tmp, includes, ldflags):
            p = subprocess.run(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            if p.returncode != 0:
                raise MXNetError("cc failed building the C API (exit %d): "
                                 "%s\n%s" % (p.returncode, " ".join(cmd),
                                             p.stdout))
        # the clients' rpath is $ORIGIN, so the directory moves whole
        try:
            os.rename(tmp, out)
        except OSError:
            if not os.path.isdir(out):    # not a concurrent build's win
                raise
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def client_env(env=None, **extra):
    """``env`` (default ``os.environ``) for a C program that links the
    library: ``PYTHONPATH`` leads with this interpreter's ``sys.path``, so
    its embedded interpreter imports the same ``mxnet_tpu_torch``, torch
    and numpy. ``extra`` entries are added as strings."""
    env = dict(os.environ if env is None else env)
    paths = [os.path.dirname(_PKG)] + [p for p in sys.path if p]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    env.update({k: str(v) for k, v in extra.items()})
    return env


if __name__ == "__main__":
    print(build()["library"])
