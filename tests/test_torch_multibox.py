"""The port's MultiBox NMS (``mxnet_tpu_torch/ops/multibox_nms.py``) and
MultiBoxDetection against the JAX package.

- The plain ``nms_alive_reference`` equals, exactly, both JAX forms of the
  greedy sweep: the Pallas kernel ``nms_alive`` run in interpret mode and
  the ``fori_loop`` form of ``ops/contrib.py:238-247``.
- MultiBoxDetection on identical cls_prob/loc_pred/anchor inputs: class ids
  and row order exact, scores and boxes to ``atol=1e-6`` (``exp`` differs by
  about an ulp between XLA:CPU and PyTorch). The JAX op runs once with
  ``MXTPU_PALLAS_MULTIBOX`` unset and once set to ``interpret``.
- CPU tensors take the plain version: the kernel's launch count stays 0.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import contrib as jcontrib
from mxnet_tpu.ops import pallas_multibox as jpmb
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import multibox_nms as tnms

THRESH = 0.5


def _sorted_boxes(rng, b, k):
    """Score-sorted boxes per image with score ties, duplicate boxes (IoU
    exactly 1), heavy overlap and trailing zero scores."""
    c = rng.random((b, k, 2), dtype=np.float32)
    wh = (0.05 + 0.4 * rng.random((b, k, 2))).astype(np.float32)
    boxes = np.clip(np.concatenate([c - wh / 2, c + wh / 2], 2), 0, 1)
    score = -np.sort(-rng.random((b, k), dtype=np.float32), axis=1)
    cls = rng.integers(0, 3, (b, k)).astype(np.float32)
    if k > 3:
        boxes[:, 1::4] = boxes[:, 0::4][:, :boxes[:, 1::4].shape[1]]
        cls[:, 1::4] = cls[:, 0::4][:, :cls[:, 1::4].shape[1]]
        score[:, 2::4] = score[:, 1::4][:, :score[:, 2::4].shape[1]]
        score[:, k - k // 4:] = 0.0
    return boxes.astype(np.float32), score, cls


def _jax_fori(sboxes, sscore, scls, force):
    """The JAX package's default NMS form (ops/contrib.py:238-247)."""
    k = sboxes.shape[0]
    ious = jcontrib._iou(sboxes, sboxes)
    same_cls = (scls[:, None] == scls[None, :]) | force
    sup_matrix = (ious > THRESH) & same_cls

    def body(i, alive):
        sup = sup_matrix[i] & alive[i] & (jnp.arange(k) > i)
        return alive & ~sup

    return jax.lax.fori_loop(0, k, body, sscore > 0).astype(jnp.float32)


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("k", [1, 7, 64, 65, 400])
def test_nms_reference_equals_jax_forms(k, force):
    rng = np.random.default_rng(1000 * k + force)
    boxes, score, cls = _sorted_boxes(rng, 3, k)
    got = tnms.nms_alive_reference(torch.from_numpy(boxes),
                                   torch.from_numpy(score),
                                   torch.from_numpy(cls), THRESH, force)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, k)
    got = got.numpy()
    for b in range(3):
        jb, js, jc = (jnp.asarray(a[b]) for a in (boxes, score, cls))
        pallas = np.asarray(jpmb.nms_alive(jb, js, jc, THRESH, force=force,
                                           interpret=True))
        fori = np.asarray(_jax_fori(jb, js, jc, force))
        np.testing.assert_array_equal(got[b], pallas)
        np.testing.assert_array_equal(got[b], fori)
    if k >= 64:     # the cases carry real suppression and survivors
        assert 0 < got.sum() < (score > 0).sum()


def _detection_inputs(rng, b, a, ncls=4):
    logits = rng.standard_normal((b, ncls, a)).astype(np.float32) * 2
    logits[:, :, 5::7] = logits[:, :, 4::7][:, :, :logits[:, :, 5::7].shape[2]]
    cls_prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    cls_prob[:, 1:, ::9] = 0.001                   # below threshold: score 0
    loc = (rng.standard_normal((b, a * 4)) * 0.5).astype(np.float32)
    c = rng.random((1, a, 2), dtype=np.float32)
    wh = (0.1 + 0.3 * rng.random((1, a, 2))).astype(np.float32)
    anchors = np.concatenate([c - wh / 2, c + wh / 2], 2).astype(np.float32)
    return cls_prob.astype(np.float32), loc, anchors


@pytest.mark.parametrize("pallas", ["unset", "interpret"])
@pytest.mark.parametrize("topk,force", [(-1, False), (60, False), (60, True)])
def test_multibox_detection_matches_jax(monkeypatch, pallas, topk, force):
    if pallas == "unset":
        monkeypatch.delenv("MXTPU_PALLAS_MULTIBOX", raising=False)
    else:
        monkeypatch.setenv("MXTPU_PALLAS_MULTIBOX", "interpret")
    rng = np.random.default_rng(7 + topk + force)
    cls_prob, loc, anchors = _detection_inputs(rng, 2, 150)
    attrs = dict(nms_threshold=0.45, nms_topk=topk, force_suppress=force,
                 variances=(0.1, 0.1, 0.2, 0.2))
    want = mx.nd.MultiBoxDetection(
        mx.nd.array(cls_prob), mx.nd.array(loc), mx.nd.array(anchors),
        **attrs).asnumpy()
    before = tnms.LAUNCHES
    got = tcontrib.multibox_detection(
        torch.from_numpy(cls_prob), torch.from_numpy(loc),
        torch.from_numpy(anchors), **attrs).numpy()
    assert tnms.LAUNCHES == before == 0        # CPU tensors: plain version
    assert got.shape == want.shape == (2, 150, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=1e-6)
    kept = (want[..., 0] >= 0).sum()
    assert 0 < kept < (want[..., 1] > 0).size


def test_nms_wrapper_rejects_bad_shapes():
    boxes = torch.zeros(2, 5, 4)
    with pytest.raises(MXNetError, match="sscore"):
        tnms.nms_alive(boxes, torch.zeros(2, 4), torch.zeros(2, 5), THRESH)
    with pytest.raises(MXNetError, match="sboxes"):
        tnms.nms_alive(torch.zeros(2, 5, 3), torch.zeros(2, 5),
                       torch.zeros(2, 5), THRESH)
    with pytest.raises(MXNetError, match="no kernel"):
        tnms.nms_alive(boxes.to("meta"), torch.zeros(2, 5, device="meta"),
                       torch.zeros(2, 5, device="meta"), THRESH)
