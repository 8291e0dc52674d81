"""Plugins (ref: plugin/{torch,caffe,warpctc,opencv,sframe}).

Counterpart of ``mxnet_tpu/plugin/__init__.py``:

- torch: PyTorch modules as operators (ref: plugin/torch TorchModule),
  :mod:`mxnet_tpu_torch.plugin.torch_module`, here native: the module runs
  on the op's own device tensors.
- warpctc: the CTC loss is an operator of its own (``sym.CTCLoss``).
- opencv: image ops live in :mod:`mxnet_tpu_torch.image`.
- caffe/sframe: not reproduced, as in the JAX package.
"""
from . import torch_module  # noqa: F401
