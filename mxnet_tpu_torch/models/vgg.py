"""VGG-11/13/16/19 (Simonyan & Zisserman 2014; ref: symbols/vgg.py), the
port's copy of ``mxnet_tpu/models/vgg.py``."""
from .. import symbol as sym

_CONFIGS = {
    11: ((1, 64), (1, 128), (2, 256), (2, 512), (2, 512)),
    13: ((2, 64), (2, 128), (2, 256), (2, 512), (2, 512)),
    16: ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)),
    19: ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512)),
}


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **kwargs):
    if num_layers not in _CONFIGS:
        raise ValueError("vgg depth must be one of %s" % sorted(_CONFIGS))
    data = sym.Variable("data")
    net = data
    for stage, (n_convs, width) in enumerate(_CONFIGS[num_layers]):
        for i in range(n_convs):
            net = sym.Convolution(data=net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=width,
                                  name="conv%d_%d" % (stage + 1, i + 1))
            if batch_norm:
                net = sym.BatchNorm(data=net, fix_gamma=False,
                                    name="bn%d_%d" % (stage + 1, i + 1))
            net = sym.Activation(data=net, act_type="relu")
        net = sym.Pooling(data=net, kernel=(2, 2), stride=(2, 2),
                          pool_type="max")
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=4096, name="fc6")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=4096, name="fc7")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(data=net, name="softmax")
