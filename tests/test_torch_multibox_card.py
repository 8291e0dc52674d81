"""Kernel B2 on the card: both routes of ``nms_alive`` (``smem``, one
cluster launch with the mask in shared memory; ``l2``, two launches through
a scratch) against the plain version at the served k and at the route
boundary, for one image and for 32, and the launches counted by route.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_multibox_card.py -q

Without CUDA each test skips, with its reason. Tolerance: exact (the
kernel's IoU uses explicitly rounded operations in the plain version's
order, so the masks are equal bit for bit).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import multibox_nms as mnms

THRESH = 0.5
#: the served k (nms_topk 400) and the route boundary
KS = [400, mnms.SMEM_MAX_K - 1, mnms.SMEM_MAX_K, mnms.SMEM_MAX_K + 1]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NMS kernel launches only on "
                    "the card (chip_smoke.py phase 3 runs it)")


def _inputs(b, k, seed):
    """Score-sorted boxes on the card with duplicates (IoU exactly 1) and
    trailing zero scores."""
    rng = np.random.default_rng(seed)
    c = rng.random((b, k, 2), dtype=np.float32)
    wh = rng.random((b, k, 2), dtype=np.float32) * np.float32(0.3)
    boxes = np.clip(np.concatenate([c - wh / 2, c + wh / 2], 2), 0, 1)
    score = -np.sort(-rng.random((b, k), dtype=np.float32), axis=1)
    cls = rng.integers(0, 3, (b, k)).astype(np.float32)
    boxes[:, 1::7] = boxes[:, 0::7][:, :boxes[:, 1::7].shape[1]]
    cls[:, 1::7] = cls[:, 0::7][:, :cls[:, 1::7].shape[1]]
    score[:, k - k // 5:] = 0.0
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .cuda() for a in (boxes, score, cls))


@pytest.mark.gpu
@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("b", [1, 32])
def test_both_routes_equal_the_plain_version(b, k, force):
    _need_card()
    boxes, score, cls = _inputs(b, k, seed=7 * k + b + force)
    want = mnms.nms_alive_reference(boxes, score, cls, THRESH, force)
    route = mnms.kernel_route(b, k)
    assert route == ("smem" if k <= mnms.SMEM_MAX_K else "l2")
    before = dict(mnms.LAUNCHES_BY_ROUTE)
    got = mnms.nms_alive(boxes, score, cls, THRESH, force)
    torch.cuda.synchronize()
    assert mnms.LAUNCHES_BY_ROUTE[route] == before[route] + 1
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int((score > 0).sum())
    # the l2 route at every k, on the same tensors
    assert torch.equal(mnms._launch(boxes, score, cls, THRESH, force, "l2"),
                       want)
    if route == "l2":
        with pytest.raises(MXNetError, match="shared memory"):
            mnms._launch(boxes, score, cls, THRESH, force, "smem")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 40])
def test_cluster_sizes_launch(b):
    """Clusters of 8, 8 and 3 blocks (B = 1, 8, 40 on 132 SMs)."""
    _need_card()
    boxes, score, cls = _inputs(b, 400, seed=b)
    got = mnms.nms_alive(boxes, score, cls, THRESH)
    assert torch.equal(got, mnms.nms_alive_reference(boxes, score, cls,
                                                     THRESH))
