"""devspec: one per-device-kind capability table for every roofline.

Counterpart of ``mxnet_tpu/devspec.py`` (same API: :class:`DeviceSpec`,
:func:`lookup`, :func:`peak_flops`, :func:`hbm_bandwidth`,
:func:`link_bandwidth`, :func:`ridge_intensity`, :func:`peak_source`).
The rates live here once and every consumer reads them through the same
prefix-matched lookup, so a bound in ``chip_smoke.py`` and an analyzer's
roofline cannot drift apart:

==============  ===========  ===========  ===========
device kind     peak bf16    HBM          NVLink
                FLOP/s       bytes/s      bytes/s
==============  ===========  ===========  ===========
NVIDIA H100     989e12       3.35e12      450e9
==============  ===========  ===========  ===========

The H100 row is the SXM5 card's, from NVIDIA's H100 Tensor Core GPU data
sheet at the 700 W limit: dense (not sparse) bf16 tensor-core rate, HBM3
bandwidth, and NVLink 4's 900 GB/s counted one way. :data:`PEAK_BY_DTYPE`
adds the same sheet's dense TF32 tensor-core rate and the FP32 rate of the
CUDA cores, which the kernels' bounds use. The JAX package's TPU rows are
not copied: the port states no rate for a TPU.

CPU and unknown kinds fall back to :data:`DEFAULT_SPEC`, the JAX package's
nominal figures (ridge at 10 FLOP/byte); :func:`peak_source` says which
case a caller got (``"spec"`` or ``"nominal-fallback"``), so a roofline
number is never silently a guess. The device kind is
``torch.cuda.get_device_name`` for a CUDA device and ``"cpu"`` for the CPU.
"""
from __future__ import annotations

from collections import namedtuple

__all__ = [
    "DeviceSpec", "DEVICE_SPECS", "DEFAULT_SPEC", "PEAK_BY_DTYPE",
    "device_kind", "lookup", "kind_spec", "compute_peak", "peak_flops",
    "hbm_bandwidth", "link_bandwidth", "ridge_intensity", "peak_source",
]

#: one device kind's capability row (all rates are per card):
#: ``peak_flops_per_s`` dense bf16, ``hbm_bytes_per_s`` main-memory
#: bandwidth, ``link_bytes_per_s`` one-directional card-to-card link
DeviceSpec = namedtuple("DeviceSpec", ["peak_flops_per_s",
                                       "hbm_bytes_per_s",
                                       "link_bytes_per_s"])

#: per-device-kind table, matched by ``device_kind`` prefix (the SXM card
#: reports "NVIDIA H100 80GB HBM3")
DEVICE_SPECS = {
    "NVIDIA H100": DeviceSpec(989e12, 3.35e12, 450e9),
}

#: peak operations/s by compute type (:func:`compute_peak`: the kernels'
#: bounds and ``flopcheck``'s per-kernel time): dense bf16 and TF32 on the
#: tensor cores, FP32 on the CUDA cores
PEAK_BY_DTYPE = {
    "NVIDIA H100": {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12},
}

#: CPU / unknown backends: the JAX package's nominal few-core figures (the
#: ratio puts the ridge at 10 FLOP/byte, so low-intensity kernels classify
#: memory-bound on a test host as they do on a card)
DEFAULT_SPEC = DeviceSpec(5.0e10, 5.0e9, 1.0e10)


def device_kind(device=None):
    """The device-kind string of a ``torch.device``, Context or string:
    ``torch.cuda.get_device_name`` for a CUDA device, ``"cpu"`` for the
    CPU, else the device type. ``device=None`` is ``cuda:0``
    (``context.resolve_device``: without CUDA it raises; the CPU's row is
    read only where a caller asks for it)."""
    import torch
    from .context import Context, resolve_device
    if isinstance(device, Context):
        device = device.to_device()
    dev = (resolve_device(None, "devspec") if device is None
           else torch.device(device))
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev.index or 0)
    return dev.type


def kind_spec(kind):
    """``(DeviceSpec, peak_source)`` of a device-kind string: the
    data-sheet row matched by prefix (``"spec"``), or the nominal fallback
    (``"nominal-fallback"``)."""
    for k, spec in DEVICE_SPECS.items():
        if kind.startswith(k):
            return spec, "spec"
    return DEFAULT_SPEC, "nominal-fallback"


def lookup(device=None):
    """``(DeviceSpec, peak_source)`` for a device (:func:`kind_spec` of its
    :func:`device_kind`)."""
    return kind_spec(device_kind(device))


def compute_peak(kind, compute):
    """Peak operations/s of a compute type (``"bfloat16"``, ``"float16"``,
    ``"tf32"``, ``"float32"``) on a device kind, from
    :data:`PEAK_BY_DTYPE` (float16 at the bf16 tensor-core rate); a kind
    without a row there, or a type its row lacks, takes the kind's
    :func:`kind_spec` peak."""
    for k, row in PEAK_BY_DTYPE.items():
        if kind.startswith(k):
            rate = row.get("bfloat16" if compute == "float16" else compute)
            if rate is not None:
                return rate
    return kind_spec(kind)[0].peak_flops_per_s


def peak_flops(device=None):
    """Peak dense bf16 FLOP/s by device kind (nominal fallback for the CPU
    and unknown kinds: check :func:`peak_source` before headlining it)."""
    return lookup(device)[0].peak_flops_per_s


def hbm_bandwidth(device=None):
    """Main-memory (HBM) bandwidth in bytes/s by device kind."""
    return lookup(device)[0].hbm_bytes_per_s


def link_bandwidth(device=None):
    """One-directional card-to-card link bandwidth in bytes/s by device
    kind."""
    return lookup(device)[0].link_bytes_per_s


def ridge_intensity(device=None):
    """The roofline ridge point in FLOP/byte: kernels whose arithmetic
    intensity sits below it are memory-bound at any utilization."""
    spec, _ = lookup(device)
    return spec.peak_flops_per_s / spec.hbm_bytes_per_s


def peak_source(device=None):
    """``"spec"`` when the device kind matched a data-sheet row,
    ``"nominal-fallback"`` otherwise."""
    return lookup(device)[1]
