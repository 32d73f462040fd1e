"""Inception-v3 (role of reference example/image-classification/symbols/
inception-v3.py; Szegedy et al., "Rethinking the Inception Architecture").

Stem -> 3x inception-A (5x5 factorized as double 3x3) -> grid reduction ->
4x inception-B (factorized 7x1/1x7) -> reduction -> 2x inception-C
(expanded 3x1+1x3 branches) -> global average pool.  299x299 input.
"""
from .. import symbol as sym


def conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name="%s_conv2d" % name)
    bn = sym.BatchNorm(data=c, fix_gamma=True, eps=0.001,
                       name="%s_batchnorm" % name)
    return sym.Activation(data=bn, act_type="relu", name="%s_relu" % name)


def block_a(data, pool_proj, name):
    b1 = conv(data, 64, (1, 1), name="%s_b1x1" % name)
    b2 = conv(data, 48, (1, 1), name="%s_b5x5_r" % name)
    b2 = conv(b2, 64, (5, 5), pad=(2, 2), name="%s_b5x5" % name)
    b3 = conv(data, 64, (1, 1), name="%s_b3x3_r" % name)
    b3 = conv(b3, 96, (3, 3), pad=(1, 1), name="%s_b3x3_1" % name)
    b3 = conv(b3, 96, (3, 3), pad=(1, 1), name="%s_b3x3_2" % name)
    b4 = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name="%s_pool" % name)
    b4 = conv(b4, pool_proj, (1, 1), name="%s_bproj" % name)
    return sym.Concat(b1, b2, b3, b4, name="%s_concat" % name)


def reduction_a(data, name):
    b1 = conv(data, 384, (3, 3), stride=(2, 2), name="%s_b3x3" % name)
    b2 = conv(data, 64, (1, 1), name="%s_bd3x3_r" % name)
    b2 = conv(b2, 96, (3, 3), pad=(1, 1), name="%s_bd3x3_1" % name)
    b2 = conv(b2, 96, (3, 3), stride=(2, 2), name="%s_bd3x3_2" % name)
    b3 = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="%s_pool" % name)
    return sym.Concat(b1, b2, b3, name="%s_concat" % name)


def block_b(data, c7, name):
    b1 = conv(data, 192, (1, 1), name="%s_b1x1" % name)
    b2 = conv(data, c7, (1, 1), name="%s_b7x7_r" % name)
    b2 = conv(b2, c7, (1, 7), pad=(0, 3), name="%s_b7x7_1" % name)
    b2 = conv(b2, 192, (7, 1), pad=(3, 0), name="%s_b7x7_2" % name)
    b3 = conv(data, c7, (1, 1), name="%s_bd7x7_r" % name)
    b3 = conv(b3, c7, (7, 1), pad=(3, 0), name="%s_bd7x7_1" % name)
    b3 = conv(b3, c7, (1, 7), pad=(0, 3), name="%s_bd7x7_2" % name)
    b3 = conv(b3, c7, (7, 1), pad=(3, 0), name="%s_bd7x7_3" % name)
    b3 = conv(b3, 192, (1, 7), pad=(0, 3), name="%s_bd7x7_4" % name)
    b4 = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name="%s_pool" % name)
    b4 = conv(b4, 192, (1, 1), name="%s_bproj" % name)
    return sym.Concat(b1, b2, b3, b4, name="%s_concat" % name)


def reduction_b(data, name):
    b1 = conv(data, 192, (1, 1), name="%s_b3x3_r" % name)
    b1 = conv(b1, 320, (3, 3), stride=(2, 2), name="%s_b3x3" % name)
    b2 = conv(data, 192, (1, 1), name="%s_b7x7_r" % name)
    b2 = conv(b2, 192, (1, 7), pad=(0, 3), name="%s_b7x7_1" % name)
    b2 = conv(b2, 192, (7, 1), pad=(3, 0), name="%s_b7x7_2" % name)
    b2 = conv(b2, 192, (3, 3), stride=(2, 2), name="%s_b7x7_3" % name)
    b3 = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="%s_pool" % name)
    return sym.Concat(b1, b2, b3, name="%s_concat" % name)


def block_c(data, name):
    b1 = conv(data, 320, (1, 1), name="%s_b1x1" % name)
    b2 = conv(data, 384, (1, 1), name="%s_b3x3_r" % name)
    b2a = conv(b2, 384, (1, 3), pad=(0, 1), name="%s_b3x3_a" % name)
    b2b = conv(b2, 384, (3, 1), pad=(1, 0), name="%s_b3x3_b" % name)
    b3 = conv(data, 448, (1, 1), name="%s_bd3x3_r" % name)
    b3 = conv(b3, 384, (3, 3), pad=(1, 1), name="%s_bd3x3" % name)
    b3a = conv(b3, 384, (1, 3), pad=(0, 1), name="%s_bd3x3_a" % name)
    b3b = conv(b3, 384, (3, 1), pad=(1, 0), name="%s_bd3x3_b" % name)
    b4 = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name="%s_pool" % name)
    b4 = conv(b4, 192, (1, 1), name="%s_bproj" % name)
    return sym.Concat(b1, b2a, b2b, b3a, b3b, b4, name="%s_concat" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    # stem (299 -> 35)
    net = conv(data, 32, (3, 3), stride=(2, 2), name="stem1")
    net = conv(net, 32, (3, 3), name="stem2")
    net = conv(net, 64, (3, 3), pad=(1, 1), name="stem3")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    net = conv(net, 80, (1, 1), name="stem4")
    net = conv(net, 192, (3, 3), name="stem5")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    # 3x A
    for i, proj in enumerate((32, 64, 64)):
        net = block_a(net, proj, name="mixed_a%d" % i)
    net = reduction_a(net, name="red_a")
    # 4x B
    for i, c7 in enumerate((128, 160, 160, 192)):
        net = block_b(net, c7, name="mixed_b%d" % i)
    net = reduction_b(net, name="red_b")
    # 2x C
    for i in range(2):
        net = block_c(net, name="mixed_c%d" % i)
    net = sym.Pooling(net, kernel=(8, 8), global_pool=True, pool_type="avg")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")
