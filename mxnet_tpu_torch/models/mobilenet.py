"""MobileNet (reference example/image-classification/symbols/mobilenet.py):
depthwise-separable convs via num_group."""
from .. import symbol as sym


def conv_block(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
               num_group=1, name=""):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           num_group=num_group, stride=stride, pad=pad,
                           no_bias=True, name="%s_conv" % name)
    bn = sym.BatchNorm(data=conv, fix_gamma=False, name="%s_bn" % name)
    return sym.Activation(data=bn, act_type="relu", name="%s_relu" % name)


def separable_conv(data, in_ch, out_ch, stride, name):
    dw = conv_block(data, in_ch, kernel=(3, 3), stride=stride, pad=(1, 1),
                    num_group=in_ch, name="%s_dw" % name)
    return conv_block(dw, out_ch, name="%s_pw" % name)


def get_symbol(num_classes=1000, alpha=1.0, **kwargs):
    def ch(n):
        return max(8, int(n * alpha))
    data = sym.Variable("data")
    body = conv_block(data, ch(32), kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      name="conv1")
    cfg = [(ch(32), ch(64), 1), (ch(64), ch(128), 2), (ch(128), ch(128), 1),
           (ch(128), ch(256), 2), (ch(256), ch(256), 1),
           (ch(256), ch(512), 2)] + \
          [(ch(512), ch(512), 1)] * 5 + \
          [(ch(512), ch(1024), 2), (ch(1024), ch(1024), 1)]
    for i, (cin, cout, s) in enumerate(cfg):
        body = separable_conv(body, cin, cout, (s, s), "sep%d" % i)
    pool = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="global_pool")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(data=fc, name="softmax")
