"""Operator library of the port: one registry serving the symbolic
and imperative namespaces (counterpart of ``mxnet_tpu/ops``)."""
from . import registry
from . import tensor        # noqa: F401  (registers tensor ops)
from . import nn            # noqa: F401  (registers nn layer ops)
from . import optimizer_op  # noqa: F401  (registers the update ops)
from . import contrib       # noqa: F401  (MultiBox, CTCLoss, fft, quantize)
from . import spatial       # noqa: F401  (ROIPooling, Correlation, samplers)
from . import rnn_op        # noqa: F401  (registers the fused RNN op)
from . import attention     # noqa: F401  (MultiHeadAttention, LayerNorm)
from . import transformer_stack  # noqa: F401  (registers TransformerStack)
from . import multibox_nms  # noqa: F401  (the NMS kernel and its plain version)
from . import matmul_stats  # noqa: F401  (the matmul+stats kernel)
from . import dtype_rules   # noqa: F401  (attaches per-op InferType rules)


get = registry.get
exists = registry.exists
list_ops = registry.list_ops
OpContext = registry.OpContext
OpDef = registry.OpDef
register = registry.register
register_def = registry.register_def
