"""GoogLeNet / Inception-v1 (role of reference
example/image-classification/symbols/googlenet.py; Szegedy et al.,
"Going Deeper with Convolutions").  Plain conv+relu factories (v1 has no
BatchNorm); the four-branch inception module concatenates 1x1, 3x3, 5x5
and pooled-projection paths."""
from .. import symbol as sym


def conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name="conv_%s" % name)
    return sym.Activation(data=c, act_type="relu", name="relu_%s" % name)


def inception(data, n1x1, n3x3r, n3x3, n5x5r, n5x5, proj, name):
    b1 = conv(data, n1x1, (1, 1), name="%s_1x1" % name)
    b2 = conv(data, n3x3r, (1, 1), name="%s_3x3_reduce" % name)
    b2 = conv(b2, n3x3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
    b3 = conv(data, n5x5r, (1, 1), name="%s_5x5_reduce" % name)
    b3 = conv(b3, n5x5, (5, 5), pad=(2, 2), name="%s_5x5" % name)
    b4 = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="max", name="max_pool_%s_pool" % name)
    b4 = conv(b4, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(b1, b2, b3, b4, name="ch_concat_%s_chconcat" % name)


# (n1x1, n3x3reduce, n3x3, n5x5reduce, n5x5, pool_proj) per module
_CFG = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    net = conv(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="1")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    net = conv(net, 64, (1, 1), name="2_reduce")
    net = conv(net, 192, (3, 3), pad=(1, 1), name="2")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    for m in ("3a", "3b"):
        net = inception(net, *_CFG[m], name="in%s" % m)
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    for m in ("4a", "4b", "4c", "4d", "4e"):
        net = inception(net, *_CFG[m], name="in%s" % m)
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    for m in ("5a", "5b"):
        net = inception(net, *_CFG[m], name="in%s" % m)
    net = sym.Pooling(net, kernel=(7, 7), stride=(1, 1), global_pool=True,
                      pool_type="avg")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")
