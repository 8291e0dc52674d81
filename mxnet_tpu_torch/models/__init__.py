"""Model zoo of the port (counterpart of ``mxnet_tpu/models``)."""
from . import ssd

__all__ = ["ssd"]
