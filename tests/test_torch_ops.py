"""Every operator of the PyTorch port's SSD serving slice against the JAX
package's ``mx.nd.<op>`` on the same numpy inputs.

Tolerance: float32 ``rtol=1e-5, atol=1e-6`` (XLA:CPU and PyTorch's CPU
kernels sum convolutions, window sums and softmax normalisers in different
orders). The port's shape inference (meta tensors or a custom rule) must
give the shape the op really returns.
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6

# (case id, op, input shapes, attrs); inputs are N(0, 1) from a seed
CASES = [
    ("conv_pad_bias", "Convolution", [(2, 3, 9, 9), (4, 3, 3, 3), (4,)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=4)),
    ("conv_stride2_nobias", "Convolution", [(2, 3, 10, 11), (5, 3, 3, 3)],
     dict(kernel=(3, 3), stride=(2, 2), num_filter=5, no_bias=True)),
    ("conv_rect_dilate", "Convolution", [(1, 2, 12, 9), (3, 2, 3, 1), (3,)],
     dict(kernel=(3, 1), pad=(2, 0), dilate=(2, 1), num_filter=3)),
    ("conv_group", "Convolution", [(2, 4, 7, 7), (6, 2, 3, 3), (6,)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=6, num_group=2)),
    ("conv_nhwc", "Convolution", [(2, 8, 8, 3), (4, 3, 3, 3), (4,)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=4, layout="NHWC")),
    ("pool_max_valid_odd", "Pooling", [(2, 3, 75, 75)],
     dict(kernel=(2, 2), stride=(2, 2), pool_type="max")),
    ("pool_max_full_odd", "Pooling", [(2, 3, 75, 74)],
     dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
          pooling_convention="full")),
    ("pool_max_pad", "Pooling", [(1, 2, 9, 11)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")),
    ("pool_avg_valid_pad", "Pooling", [(2, 3, 9, 11)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg")),
    ("pool_avg_full", "Pooling", [(2, 3, 10, 7)],
     dict(kernel=(3, 2), stride=(2, 2), pool_type="avg",
          pooling_convention="full")),
    ("pool_sum", "Pooling", [(1, 2, 8, 8)],
     dict(kernel=(2, 3), stride=(1, 2), pool_type="sum")),
    ("pool_global_max", "Pooling", [(2, 3, 5, 7)],
     dict(kernel=(1, 1), global_pool=True, pool_type="max")),
    ("pool_global_avg", "Pooling", [(2, 3, 5, 7)],
     dict(kernel=(1, 1), global_pool=True, pool_type="avg")),
    ("pool_max_nhwc", "Pooling", [(2, 9, 9, 3)],
     dict(kernel=(2, 2), stride=(2, 2), pool_type="max", layout="NHWC")),
    ("act_relu", "Activation", [(3, 4, 5)], dict(act_type="relu")),
    ("act_sigmoid", "Activation", [(3, 4, 5)], dict(act_type="sigmoid")),
    ("act_tanh", "Activation", [(3, 4, 5)], dict(act_type="tanh")),
    ("act_softrelu", "Activation", [(3, 4, 5)], dict(act_type="softrelu")),
    ("softmax_channel", "SoftmaxActivation", [(2, 5, 7)],
     dict(mode="channel")),
    ("softmax_channel_4d", "SoftmaxActivation", [(2, 5, 3, 4)],
     dict(mode="channel")),
    ("softmax_instance", "SoftmaxActivation", [(3, 4, 5)],
     dict(mode="instance")),
    ("concat_dim1", "Concat", [(2, 3, 4), (2, 5, 4), (2, 1, 4)],
     dict(dim=1, num_args=3)),
    ("concat_dim2", "Concat", [(2, 3, 4), (2, 3, 2)], dict(dim=2, num_args=2)),
    ("reshape_0_m1", "Reshape", [(2, 3, 4, 5)], dict(shape=(0, -1))),
    ("reshape_0_m1_k", "Reshape", [(2, 60)], dict(shape=(0, -1, 4))),
    ("reshape_m2", "Reshape", [(2, 3, 4, 5)], dict(shape=(2, -1, -2))),
    ("reshape_m3", "Reshape", [(2, 3, 4, 5)], dict(shape=(-3, -2))),
    ("reshape_m4", "Reshape", [(6, 4, 5)], dict(shape=(-4, 2, -1, -2))),
    ("reshape_m4_right", "Reshape", [(6, 4, 5)], dict(shape=(-4, -1, 3, 0, 5))),
    ("reshape_str", "Reshape", [(2, 3, 4)], dict(shape="(0, 0, 2, 2)")),
    ("flatten", "Flatten", [(2, 3, 4, 5)], {}),
    ("transpose_axes", "transpose", [(2, 3, 4, 5)], dict(axes=(0, 2, 3, 1))),
    ("transpose_default", "transpose", [(2, 3, 4)], {}),
    ("prior_default", "MultiBoxPrior", [(1, 3, 5, 6)], {}),
    ("prior_sizes_ratios_clip", "MultiBoxPrior", [(2, 3, 19, 19)],
     dict(sizes="0.2,0.27", ratios="1.0,2.0,0.5", clip=True)),
    ("prior_steps_offsets", "MultiBoxPrior", [(1, 3, 4, 7)],
     dict(sizes=(0.3,), ratios=(1.0, 3.0), steps=(0.25, 0.125),
          offsets=(0.25, 0.75))),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op, shapes, attrs = case
    rng = np.random.default_rng(zlib.crc32(case[0].encode()))
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = getattr(mx.nd, op)(*[mx.nd.array(x) for x in xs], **attrs)
    want = want.asnumpy()
    opdef = treg.get(op)
    got, aux_updates = opdef.apply(treg.OpContext(), attrs,
                                   [torch.from_numpy(x) for x in xs], [])
    assert len(got) == 1 and aux_updates is None
    got = got[0].numpy()
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _, out_shapes, _ = opdef.infer_shape(attrs, shapes)
    assert tuple(out_shapes[0]) == want.shape
