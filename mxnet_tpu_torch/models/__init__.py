"""Model zoo of the port (counterpart of ``mxnet_tpu/models``)."""
from . import ssd
from .lenet import get_symbol as lenet
from .mlp import get_symbol as mlp
from .resnet import get_symbol as resnet

__all__ = ["lenet", "mlp", "resnet", "ssd"]
