"""Random state for mxnet_tpu_torch.

Counterpart of ``mxnet_tpu/random.py``. The JAX package keeps one root key
and splits it; here the state is explicit ``torch.Generator``s, one per
device, created at first use from the current seed. ``seed`` reseeds them
all; ``get_state``/``set_state`` snapshot and restore them (scoped seeding,
as ``TrainStep.init`` uses it). PyTorch's own global generators are never
touched. The numbers differ from the JAX package's for the same seed.

The samplers (``uniform``, ``normal``, ``gamma``, ``exponential``,
``poisson``, ``negative_binomial``) run the ``_random_*`` ops through
``nd``, on ``ctx`` or the current context, drawing from that device's
generator.
"""
from __future__ import annotations

import threading

import torch

_DEFAULT_SEED = 0

# process-global, like the JAX package's root key (seed() must reach every
# thread); the lock serializes access
_lock = threading.Lock()
_seed = _DEFAULT_SEED
_gens = {}


def _device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(seed_state):
    """Seed every device's generator (parity: mx.random.seed)."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        for dev, gen in _gens.items():
            gen.manual_seed(_seed)


def generator(device="cpu"):
    """The generator of ``device``, seeded from the current seed at first
    use. Draws advance it."""
    dev = _device(device)
    with _lock:
        gen = _gens.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_seed)
            _gens[dev] = gen
        return gen


def get_state():
    """Snapshot of the seed and of every device generator's state."""
    with _lock:
        return _seed, {dev: gen.get_state() for dev, gen in _gens.items()}


def set_state(state):
    """Restore a snapshot taken by :func:`get_state`; generators created
    since are dropped, so they start again from the restored seed."""
    global _seed
    seed_state, gen_states = state
    with _lock:
        _seed = seed_state
        for dev in list(_gens):
            if dev not in gen_states:
                del _gens[dev]
        for dev, st in gen_states.items():
            gen = _gens.get(dev)
            if gen is None:
                gen = _gens[dev] = torch.Generator(device=dev)
            gen.set_state(st)


_tls = threading.local()


def np_rng():
    """A numpy Generator seeded from the CPU generator (host-side draws:
    ``io.NDArrayIter``'s shuffle, the image augmenters). Inside a
    :class:`scoped_np_rng` block the scoped Generator is returned instead:
    the data tier's decode workers pin each batch's augmentation draws to a
    Generator made from (seed, epoch, batch index), so the stream does not
    depend on which worker decodes a batch."""
    ov = getattr(_tls, "np_rng", None)
    if ov is not None:
        return ov
    import numpy as np
    return np.random.default_rng(randint63())


class scoped_np_rng(object):
    """Thread-local override of :func:`np_rng` for the calling thread::

        with random.scoped_np_rng(np.random.default_rng(s)):
            ...   # every np_rng() here returns that Generator

    Scopes nest; the override reaches neither other threads nor past the
    block."""

    def __init__(self, rng):
        self._rng = rng

    def __enter__(self):
        self._prev = getattr(_tls, "np_rng", None)
        _tls.np_rng = self._rng
        return self._rng

    def __exit__(self, *exc):
        _tls.np_rng = self._prev
        return False


def randint63():
    """One integer in [0, 2**62) from the CPU generator: the key of a run's
    per-node streams (``executor.node_generator``)."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator("cpu")))


# ---------------------------------------------------------------------------
# sampling API (ref: python/mxnet/random.py): the _random_* ops of
# ops/tensor.py; the tensor-parameter _sample_* family is nd._sample_*
# ---------------------------------------------------------------------------

def _sample(op_name, ctx=None, out=None, **attrs):
    from . import ndarray as nd
    from .ops import registry as _reg
    if ctx is None and out is not None:
        ctx = out.context
    return nd.invoke(_reg.get(op_name), [], attrs, out=out, ctx=ctx)


def uniform(low=0, high=1, shape=None, ctx=None, out=None):
    return _sample("_random_uniform", ctx, out, low=low, high=high,
                   shape=shape or (1,))


def normal(loc=0, scale=1, shape=None, ctx=None, out=None):
    return _sample("_random_normal", ctx, out, loc=loc, scale=scale,
                   shape=shape or (1,))


def gamma(alpha=1, beta=1, shape=None, ctx=None, out=None):
    return _sample("_random_gamma", ctx, out, alpha=alpha, beta=beta,
                   shape=shape or (1,))


def exponential(lam=1, shape=None, ctx=None, out=None):
    return _sample("_random_exponential", ctx, out, lam=lam,
                   shape=shape or (1,))


def poisson(lam=1, shape=None, ctx=None, out=None):
    return _sample("_random_poisson", ctx, out, lam=lam, shape=shape or (1,))


def negative_binomial(k=1, p=1, shape=None, ctx=None, out=None):
    return _sample("_random_negative_binomial", ctx, out, k=k, p=p,
                   shape=shape or (1,))
