"""SSD: Single-Shot MultiBox Detector, training and inference nets.

Counterpart of ``mxnet_tpu/models/ssd.py`` (ref: example/ssd/symbol/
common.py:110-190 multibox_layer, symbol_vgg16_ssd_300.py:124-190 train
and eval heads): a compact VGG-style backbone with taps at strides 8/16/32,
per-tap loc/cls conv heads and MultiBoxPrior anchors. The inference net
ends in softmax, decode and NMS (MultiBoxDetection); the training net
matches anchors and mines hard negatives (MultiBoxTarget), scores the
classes with SoftmaxOutput (ignore label -1) and the boxes with a smooth-L1
MakeLoss, and keeps the detections as a zero-gradient head. Built here,
each symbol has the same JSON and the same parameter names as the JAX
package's.
"""
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
            # channel L2-norm with fixed scale (ref uses a learnable scale
            # initialized to `norm`; the constant matches its init state)
            from_layer = sym.L2Normalization(data=from_layer,
                                             mode="channel",
                                             name=name + "_norm") * norm
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


def get_symbol_train(num_classes=4, width=32, sizes=None, ratios=None,
                     nms_thresh=0.5, nms_topk=400, **kwargs):
    """Training net: losses wired exactly like the reference head
    (symbol_vgg16_ssd_300.py:129-155). Outputs ``cls_prob_output``,
    ``loc_loss_output``, ``cls_label_output`` and ``det_out_output``."""
    loc_preds, cls_preds, anchors = _heads(num_classes, width, sizes, ratios)
    label = sym.Variable("label")
    tmp = sym.MultiBoxTarget(anchors, label, cls_preds,
                             overlap_threshold=0.5, ignore_label=-1,
                             negative_mining_ratio=3,
                             negative_mining_thresh=0.5,
                             variances="0.1,0.1,0.2,0.2",
                             name="multibox_target")
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]
    cls_prob = sym.SoftmaxOutput(data=cls_preds, label=cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 multi_output=True, normalization="valid",
                                 name="cls_prob")
    loc_loss_ = sym.smooth_l1(data=loc_target_mask * (loc_preds - loc_target),
                              scalar=1.0, name="loc_loss_")
    loc_loss = sym.MakeLoss(loc_loss_, normalization="valid",
                            name="loc_loss")
    cls_label = sym.MakeLoss(data=cls_target, grad_scale=0.0,
                             name="cls_label")
    det = sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                nms_threshold=nms_thresh,
                                variances="0.1,0.1,0.2,0.2",
                                nms_topk=nms_topk, name="detection")
    det = sym.MakeLoss(data=det, grad_scale=0.0, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


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
