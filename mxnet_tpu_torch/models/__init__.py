"""Model zoo of the port (counterpart of ``mxnet_tpu/models``)."""
from . import ssd
from .resnet import get_symbol as resnet

__all__ = ["resnet", "ssd"]
