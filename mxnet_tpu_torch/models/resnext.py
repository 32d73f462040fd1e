"""ResNeXt (role of reference example/image-classification/symbols/
resnext.py; Xie et al., "Aggregated Residual Transformations") — ResNet
bottleneck with the 3x3 conv split into ``num_group`` cardinal paths
(a grouped convolution).
"""
from .. import symbol as sym


def resnext_unit(data, num_filter, stride, dim_match, name, num_group=32,
                 bottle_width=0.5, bn_mom=0.9):
    """post-activation bottleneck: conv1x1 -> grouped conv3x3 -> conv1x1,
    identity (or projected) shortcut added before the final relu."""
    mid = int(num_filter * bottle_width)
    c1 = sym.Convolution(data=data, num_filter=mid, kernel=(1, 1),
                         no_bias=True, name=name + "_conv1")
    b1 = sym.BatchNorm(data=c1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                       name=name + "_bn1")
    a1 = sym.Activation(data=b1, act_type="relu", name=name + "_relu1")
    c2 = sym.Convolution(data=a1, num_filter=mid, kernel=(3, 3),
                         stride=stride, pad=(1, 1), num_group=num_group,
                         no_bias=True, name=name + "_conv2")
    b2 = sym.BatchNorm(data=c2, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                       name=name + "_bn2")
    a2 = sym.Activation(data=b2, act_type="relu", name=name + "_relu2")
    c3 = sym.Convolution(data=a2, num_filter=num_filter, kernel=(1, 1),
                         no_bias=True, name=name + "_conv3")
    b3 = sym.BatchNorm(data=c3, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                       name=name + "_bn3")
    if dim_match:
        shortcut = data
    else:
        sc = sym.Convolution(data=data, num_filter=num_filter, kernel=(1, 1),
                             stride=stride, no_bias=True, name=name + "_sc")
        shortcut = sym.BatchNorm(data=sc, fix_gamma=False, eps=2e-5,
                                 momentum=bn_mom, name=name + "_sc_bn")
    return sym.Activation(data=b3 + shortcut, act_type="relu",
                          name=name + "_relu")


_UNITS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def get_symbol(num_classes=1000, num_layers=50, num_group=32, **kwargs):
    if num_layers not in _UNITS:
        raise ValueError("resnext supports num_layers in %s"
                         % sorted(_UNITS))
    units = _UNITS[num_layers]
    filters = (256, 512, 1024, 2048)

    data = sym.Variable("data")
    net = sym.Convolution(data=data, num_filter=64, kernel=(7, 7),
                          stride=(2, 2), pad=(3, 3), no_bias=True,
                          name="conv0")
    net = sym.BatchNorm(data=net, fix_gamma=False, eps=2e-5, momentum=0.9,
                        name="bn0")
    net = sym.Activation(data=net, act_type="relu", name="relu0")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    for stage, (n, f) in enumerate(zip(units, filters)):
        for i in range(n):
            stride = (1, 1) if stage == 0 or i > 0 else (2, 2)
            net = resnext_unit(net, f, stride, dim_match=(i > 0),
                               name="stage%d_unit%d" % (stage + 1, i + 1),
                               num_group=num_group)
    net = sym.Pooling(net, kernel=(7, 7), global_pool=True, pool_type="avg")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")
