"""``python -m mxnet_tpu_torch.chaos --audit-sites`` — registry, site table
and tests three-way cross-check.

The port's own copy of ``mxnet_tpu/chaos/audit.py``, held against the
port's own inventory. Fault sites rot in two directions: a new site lands
in ``faults.py`` without documentation or coverage, or code moves and a
documented site no longer exists. This audit pins three views of the
inventory to each other:

1. the live registry (:data:`mxnet_tpu_torch.faults.SITES`),
2. the site table of ``mxnet_tpu_torch/faults.py``'s docstring (the
   first double-backticked token of each row),
3. the port's tests — every registered site must appear as a literal
   string in some ``tests/test_torch_*.py``.
"""
from __future__ import annotations

import os
import re

from .. import faults as _faults

_RULE = re.compile(r"^=+\s+=+$")


def repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def doc_sites(doc_text=None):
    """Site names in the site table of ``faults.py``'s docstring (between
    its second and third ``====`` rule lines), or of ``doc_text``."""
    text = _faults.__doc__ if doc_text is None else doc_text
    rules = [i for i, line in enumerate(text.splitlines())
             if _RULE.match(line.strip())]
    if len(rules) < 3:
        raise ValueError("faults.py docstring: the site table's rule lines "
                         "are missing")
    lines = text.splitlines()[rules[1] + 1:rules[2]]
    sites = set()
    for line in lines:
        m = re.match(r"``([^`]+)``\s", line)
        if m:
            sites.add(m.group(1))
    return sites


def test_sites(tests_dir=None):
    """Registered sites referenced as a literal string in the port's test
    files (``test_torch_*.py``)."""
    root = tests_dir or os.path.join(repo_root(), "tests")
    registered = set(_faults.SITES)
    found = set()
    for fn in sorted(os.listdir(root)):
        if not (fn.startswith("test_torch_") and fn.endswith(".py")):
            continue
        try:
            with open(os.path.join(root, fn)) as f:
                text = f.read()
        except OSError:
            continue
        for site in registered - found:
            if ('"%s"' % site) in text or ("'%s'" % site) in text:
                found.add(site)
        if found == registered:
            break
    return found


def audit_sites(doc_text=None, tests_dir=None):
    """Run the three-way check; returns a list of problem strings
    (empty = clean)."""
    registered = set(_faults.SITES)
    problems = []

    documented = doc_sites(doc_text)
    for site in sorted(registered - documented):
        problems.append(
            "site %r is registered in faults.SITES but missing from the "
            "faults.py site table" % site)
    for site in sorted(documented - registered):
        problems.append(
            "site %r appears in the faults.py site table but is not "
            "registered in faults.SITES" % site)

    tested = test_sites(tests_dir)
    for site in sorted(registered - tested):
        problems.append(
            "site %r is registered but no tests/test_torch_*.py file "
            "references it as a literal string" % site)

    # scenario strings must be ones the runner knows how to drive
    from .runner import SCENARIOS
    for name, info in sorted(_faults.SITES.items()):
        for scen in info.scenarios:
            if scen not in SCENARIOS:
                problems.append(
                    "site %r names unknown chaos scenario %r (runner "
                    "knows: %s)" % (name, scen, ", ".join(SCENARIOS)))
    return problems


def main(out=print):
    problems = audit_sites()
    registered = sorted(_faults.SITES)
    out("chaos site audit: %d registered site(s)" % len(registered))
    if problems:
        for p in problems:
            out("PROBLEM: %s" % p)
        out("AUDIT FAILED: %d problem(s)" % len(problems))
        return 1
    out("registry == faults.py site table == test coverage: OK")
    return 0
