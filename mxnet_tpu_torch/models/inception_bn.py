"""Inception with BatchNorm (Ioffe & Szegedy 2015; ref: symbols/
inception-bn.py), the port's copy of ``mxnet_tpu/models/inception_bn.py``."""
from .. import symbol as sym


def _conv_factory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                  name=None):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, no_bias=True,
                           name="conv_%s" % name)
    bn = sym.BatchNorm(data=conv, fix_gamma=False, name="bn_%s" % name)
    return sym.Activation(data=bn, act_type="relu")


def _inception_a(data, n1, n3r, n3, d3r, d3, pool_type, np_, name):
    c1 = _conv_factory(data, n1, (1, 1), name="%s_1x1" % name)
    c3 = _conv_factory(data, n3r, (1, 1), name="%s_3x3r" % name)
    c3 = _conv_factory(c3, n3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
    cd = _conv_factory(data, d3r, (1, 1), name="%s_d3x3r" % name)
    cd = _conv_factory(cd, d3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    cd = _conv_factory(cd, d3, (3, 3), pad=(1, 1), name="%s_d3x3b" % name)
    pool = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                       pool_type=pool_type)
    cp = _conv_factory(pool, np_, (1, 1), name="%s_proj" % name)
    return sym.Concat(c1, c3, cd, cp, name="ch_concat_%s" % name)


def _inception_b(data, n3r, n3, d3r, d3, name):
    c3 = _conv_factory(data, n3r, (1, 1), name="%s_3x3r" % name)
    c3 = _conv_factory(c3, n3, (3, 3), stride=(2, 2), pad=(1, 1),
                       name="%s_3x3" % name)
    cd = _conv_factory(data, d3r, (1, 1), name="%s_d3x3r" % name)
    cd = _conv_factory(cd, d3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    cd = _conv_factory(cd, d3, (3, 3), stride=(2, 2), pad=(1, 1),
                       name="%s_d3x3b" % name)
    pool = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    return sym.Concat(c3, cd, pool, name="ch_concat_%s" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    body = _conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3),
                         name="1")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    body = _conv_factory(body, 64, (1, 1), name="2r")
    body = _conv_factory(body, 192, (3, 3), pad=(1, 1), name="2")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    body = _inception_a(body, 64, 64, 64, 64, 96, "avg", 32, "3a")
    body = _inception_a(body, 64, 64, 96, 64, 96, "avg", 64, "3b")
    body = _inception_b(body, 128, 160, 64, 96, "3c")
    body = _inception_a(body, 224, 64, 96, 96, 128, "avg", 128, "4a")
    body = _inception_a(body, 192, 96, 128, 96, 128, "avg", 128, "4b")
    body = _inception_a(body, 160, 128, 160, 128, 160, "avg", 128, "4c")
    body = _inception_a(body, 96, 128, 192, 160, 192, "avg", 128, "4d")
    body = _inception_b(body, 128, 192, 192, 256, "4e")
    body = _inception_a(body, 352, 192, 320, 160, 224, "avg", 128, "5a")
    body = _inception_a(body, 352, 192, 320, 192, 224, "max", 128, "5b")
    body = sym.Pooling(data=body, kernel=(7, 7), global_pool=True,
                       pool_type="avg")
    flat = sym.Flatten(data=body)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")
