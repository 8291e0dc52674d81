"""Model zoo of the port (counterpart of ``mxnet_tpu/models``): symbol
builders for the reference's flagship configurations, and
:func:`get_symbol`, the factory by name."""
from . import ssd
from .lenet import get_symbol as lenet
from .mlp import get_symbol as mlp
from .resnet import get_symbol as resnet
from .alexnet import get_symbol as alexnet
from .vgg import get_symbol as vgg
from .inception_bn import get_symbol as inception_bn
from .transformer import get_symbol as transformer
from .ssd import get_symbol_train as ssd_train


_FACTORIES = {
    "transformer": transformer,
    "lenet": lenet,
    "mlp": mlp,
    "resnet": resnet,
    "alexnet": alexnet,
    "vgg": vgg,
    "inception-bn": inception_bn,
    # the training symbol (MultiBoxTarget matching and the loss heads)
    "ssd": ssd_train,
}


def get_symbol(network, **kwargs):
    """Factory by name (ref: example/image-classification/train_*.py
    --network flag)."""
    if network not in _FACTORIES:
        raise ValueError("unknown network %r; have %s"
                         % (network, sorted(_FACTORIES)))
    return _FACTORIES[network](**kwargs)


__all__ = ["alexnet", "get_symbol", "inception_bn", "lenet", "mlp",
           "resnet", "ssd", "ssd_train", "transformer", "vgg"]
