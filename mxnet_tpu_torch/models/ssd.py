"""SSD: Single-Shot MultiBox Detector, inference net.

Counterpart of ``mxnet_tpu/models/ssd.py`` (ref: example/ssd/symbol/
common.py:110-190 multibox_layer, symbol_vgg16_ssd_300.py:157-190 eval
head): a compact VGG-style backbone with taps at strides 8/16/32, per-tap
loc/cls conv heads and MultiBoxPrior anchors, then softmax, decode and NMS
in MultiBoxDetection. Built here, the symbol has the same JSON and the same
parameter names as the JAX package's. The training net
(``get_symbol_train``) comes in a later slice.
"""
from ..base import MXNetError
from .. import symbol as sym


def _conv_act(data, num_filter, kernel, stride, pad, name):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name=name)
    return sym.Activation(data=c, act_type="relu")


def _backbone(data, width=32):
    """Small VGG-style feature extractor returning taps at strides 8/16/32."""
    x = _conv_act(data, width, (3, 3), (1, 1), (1, 1), "conv1_1")
    x = sym.Pooling(data=x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = _conv_act(x, width * 2, (3, 3), (1, 1), (1, 1), "conv2_1")
    x = sym.Pooling(data=x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = _conv_act(x, width * 4, (3, 3), (1, 1), (1, 1), "conv3_1")
    tap1 = _conv_act(x, width * 4, (3, 3), (1, 1), (1, 1), "conv3_2")
    x = sym.Pooling(data=tap1, kernel=(2, 2), stride=(2, 2),
                    pool_type="max")
    tap2 = _conv_act(x, width * 8, (3, 3), (1, 1), (1, 1), "conv4_1")
    x = sym.Pooling(data=tap2, kernel=(2, 2), stride=(2, 2),
                    pool_type="max")
    tap3 = _conv_act(x, width * 8, (3, 3), (1, 1), (1, 1), "conv5_1")
    return [tap1, tap2, tap3]


def multibox_layer(from_layers, num_classes, sizes, ratios, clip=False,
                   normalization=-1):
    """Per-feature-map loc/cls heads + anchors
    (ref: example/ssd/symbol/common.py:110-190)."""
    loc_layers, cls_layers, anchor_layers = [], [], []
    num_classes += 1                     # + background class
    for k, from_layer in enumerate(from_layers):
        name = "mb%d" % k
        norm = (normalization[k] if isinstance(normalization, (list, tuple))
                else normalization)
        if norm > 0:
            raise MXNetError("multibox_layer: normalization > 0 needs "
                             "L2Normalization, which is not ported yet")
        size, ratio = sizes[k], ratios[k]
        na = len(size) + len(ratio) - 1
        loc = sym.Convolution(data=from_layer, num_filter=na * 4,
                              kernel=(3, 3), pad=(1, 1),
                              name=name + "_loc_pred_conv")
        loc = sym.transpose(data=loc, axes=(0, 2, 3, 1))
        loc_layers.append(sym.Flatten(data=loc))
        cls = sym.Convolution(data=from_layer, num_filter=na * num_classes,
                              kernel=(3, 3), pad=(1, 1),
                              name=name + "_cls_pred_conv")
        cls = sym.transpose(data=cls, axes=(0, 2, 3, 1))
        cls_layers.append(sym.Flatten(data=cls))
        anchors = sym.MultiBoxPrior(from_layer,
                                    sizes=",".join(str(s) for s in size),
                                    ratios=",".join(str(r) for r in ratio),
                                    clip=clip, name=name + "_anchors")
        anchor_layers.append(sym.Flatten(data=anchors))
    loc_preds = sym.Concat(*loc_layers, dim=1, name="multibox_loc_pred")
    cls_preds = sym.Concat(*cls_layers, dim=1)
    cls_preds = sym.Reshape(data=cls_preds, shape=(0, -1, num_classes))
    cls_preds = sym.transpose(data=cls_preds, axes=(0, 2, 1),
                              name="multibox_cls_pred")
    anchors = sym.Concat(*anchor_layers, dim=1)
    anchors = sym.Reshape(data=anchors, shape=(0, -1, 4),
                          name="multibox_anchors")
    return loc_preds, cls_preds, anchors


_DEFAULT_SIZES = [[0.2, 0.27], [0.37, 0.44], [0.54, 0.62]]
_DEFAULT_RATIOS = [[1.0, 2.0, 0.5]] * 3


def _heads(num_classes, width, sizes, ratios):
    data = sym.Variable("data")
    taps = _backbone(data, width)
    sizes = sizes or _DEFAULT_SIZES
    ratios = ratios or _DEFAULT_RATIOS
    return multibox_layer(taps, num_classes, sizes, ratios, clip=True)


def get_symbol(num_classes=4, width=32, sizes=None, ratios=None,
               nms_thresh=0.5, nms_topk=400, **kwargs):
    """Inference net: softmax + decode + NMS
    (ref: symbol_vgg16_ssd_300.py:157-190)."""
    loc_preds, cls_preds, anchors = _heads(num_classes, width, sizes, ratios)
    cls_prob = sym.SoftmaxActivation(data=cls_preds, mode="channel",
                                     name="cls_prob")
    return sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                 nms_threshold=nms_thresh,
                                 variances="0.1,0.1,0.2,0.2",
                                 nms_topk=nms_topk, name="detection")
