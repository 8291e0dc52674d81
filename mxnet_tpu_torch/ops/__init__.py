"""Operator library of the port: one registry serving the symbolic
namespace (counterpart of ``mxnet_tpu/ops``)."""
from . import registry
from . import tensor        # noqa: F401  (registers tensor ops)
from . import nn            # noqa: F401  (registers nn layer ops)
from . import contrib       # noqa: F401  (registers the MultiBox ops)
from . import multibox_nms  # noqa: F401  (the NMS kernel and its plain version)
from . import matmul_stats  # noqa: F401  (the matmul+stats kernel)

