"""Random state for mxnet_tpu_torch.

Counterpart of ``mxnet_tpu/random.py``. The JAX package keeps one root key
and splits it; here the state is explicit ``torch.Generator``s, one per
device, created at first use from the current seed. ``seed`` reseeds them
all; ``get_state``/``set_state`` snapshot and restore them (scoped seeding,
as ``TrainStep.init`` uses it). PyTorch's own global generators are never
touched. The numbers differ from the JAX package's for the same seed.
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


def randint63():
    """One integer in [0, 2**62) from the CPU generator: the key of a run's
    per-node streams (``executor.node_generator``)."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator("cpu")))
