"""Kernel B2's route choice in the PyTorch port (``ops/multibox_nms.py``):
which route a (B, k) takes, the smem route's cluster size and shared
memory, against what ``csrc/multibox_nms.cu`` states. Pure functions of the
shape: nothing here launches a kernel, so it runs on the CPU; the kernel
itself is held against the plain version on the card
(``tests/test_torch_multibox_card.py``, ``chip_smoke.py`` phase 3).
"""
import os
import re

import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import multibox_nms as mnms

SRC = os.path.join(os.path.dirname(mnms.__file__), os.pardir, "csrc",
                   "multibox_nms.cu")
#: a block's shared memory on Hopper: 227 KB
H100_SMEM = 227 * 1024


def test_limits():
    assert mnms.MAX_K == 65536
    assert mnms.SMEM_LIMIT == 232448 == H100_SMEM
    assert mnms.H100_SMS == 132
    assert mnms.MAX_CLUSTER == 8


@pytest.mark.parametrize("k,want", [
    (1, "smem"), (64, "smem"), (400, "smem"),
    (mnms.SMEM_MAX_K - 1, "smem"), (mnms.SMEM_MAX_K, "smem"),
    (mnms.SMEM_MAX_K + 1, "l2"), (29272, "l2"), (mnms.MAX_K, "l2")])
@pytest.mark.parametrize("b", [1, 32])
def test_route_at_the_boundary(b, k, want):
    assert mnms.kernel_route(b, k) == want


@pytest.mark.parametrize("b,k", [(1, mnms.MAX_K + 1), (-1, 400), (1, -1)])
def test_route_rejects_what_no_kernel_takes(b, k):
    with pytest.raises(MXNetError, match="no kernel route"):
        mnms.kernel_route(b, k)


def test_smem_bytes_fit_227_kb_up_to_the_boundary():
    kmax = mnms.SMEM_MAX_K
    assert mnms.smem_bytes(kmax) <= H100_SMEM < mnms.smem_bytes(kmax + 1)
    assert all(mnms.smem_bytes(k) < mnms.smem_bytes(k + 1)
               for k in range(1, kmax + 64))
    # k = 400 (the served nms_topk): boxes in 464 slots, 7 words of 400
    # rows, 7 alive words, 64 words of slack
    assert mnms.smem_bytes(400) == 24 * 464 + 8 * (7 * 400 + 7 + 64)


def test_boundary_is_the_source_note():
    with open(SRC) as f:
        note = f.read()
    stated = re.findall(r"shared memory \(k <= (\d+);", note)
    assert [int(k) for k in stated] == [mnms.SMEM_MAX_K]


@pytest.mark.parametrize("b,want", [(1, 8), (8, 8), (16, 8), (32, 4),
                                    (40, 3), (66, 2), (132, 1), (500, 1)])
def test_cluster_size(b, want):
    c = mnms.cluster_size(b)
    assert c == want
    assert 1 <= c <= mnms.MAX_CLUSTER
    assert b * c <= mnms.H100_SMS or c == 1


def test_cluster_size_follows_the_sm_count():
    assert mnms.cluster_size(32, sms=64) == 2
    assert mnms.cluster_size(1, sms=4) == 4


def test_cpu_tensors_take_the_plain_version():
    before = dict(mnms.LAUNCHES_BY_ROUTE), mnms.LAUNCHES
    boxes = torch.tensor([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 0.9]]])
    got = mnms.nms_alive(boxes, torch.tensor([[0.9, 0.8]]),
                         torch.zeros(1, 2), 0.5)
    assert got.tolist() == [[1.0, 0.0]]
    assert (dict(mnms.LAUNCHES_BY_ROUTE), mnms.LAUNCHES) == before
