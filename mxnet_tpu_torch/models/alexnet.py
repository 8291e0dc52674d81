"""AlexNet (Krizhevsky 2012; ref: symbols/alexnet.py), the port's copy of
``mxnet_tpu/models/alexnet.py``."""
from .. import symbol as sym


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    conv1 = sym.Convolution(data=data, kernel=(11, 11), stride=(4, 4),
                            num_filter=96, name="conv1")
    relu1 = sym.Activation(data=conv1, act_type="relu")
    lrn1 = sym.LRN(data=relu1, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    pool1 = sym.Pooling(data=lrn1, kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    conv2 = sym.Convolution(data=pool1, kernel=(5, 5), pad=(2, 2),
                            num_filter=256, name="conv2")
    relu2 = sym.Activation(data=conv2, act_type="relu")
    lrn2 = sym.LRN(data=relu2, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    pool2 = sym.Pooling(data=lrn2, kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    conv3 = sym.Convolution(data=pool2, kernel=(3, 3), pad=(1, 1),
                            num_filter=384, name="conv3")
    relu3 = sym.Activation(data=conv3, act_type="relu")
    conv4 = sym.Convolution(data=relu3, kernel=(3, 3), pad=(1, 1),
                            num_filter=384, name="conv4")
    relu4 = sym.Activation(data=conv4, act_type="relu")
    conv5 = sym.Convolution(data=relu4, kernel=(3, 3), pad=(1, 1),
                            num_filter=256, name="conv5")
    relu5 = sym.Activation(data=conv5, act_type="relu")
    pool3 = sym.Pooling(data=relu5, kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    flatten = sym.Flatten(data=pool3)
    fc1 = sym.FullyConnected(data=flatten, num_hidden=4096, name="fc1")
    relu6 = sym.Activation(data=fc1, act_type="relu")
    dropout1 = sym.Dropout(data=relu6, p=0.5)
    fc2 = sym.FullyConnected(data=dropout1, num_hidden=4096, name="fc2")
    relu7 = sym.Activation(data=fc2, act_type="relu")
    dropout2 = sym.Dropout(data=relu7, p=0.5)
    fc3 = sym.FullyConnected(data=dropout2, num_hidden=num_classes,
                             name="fc3")
    return sym.SoftmaxOutput(data=fc3, name="softmax")
