"""Model zoo — symbol builders (port of ``mxnet_tpu/models/__init__.py``).

``get_symbol(name, num_classes, **kwargs)`` dispatches by name like the
reference's fit.py does (example/image-classification/common/fit.py), over
the JAX package's names; every builder emits the JAX package's graph JSON
byte for byte.  ``models.lstm_lm`` builds the LSTM language model
(``lstm_lm_sym``, ``make_sym_gen``); ``models.long_context_lm`` is the
long-context causal LM of example/long-context/train_lm.py (``build_params``,
``apply_model``, ``make_step``).
"""
from . import lenet, mlp, alexnet, vgg, resnet, inception_bn, mobilenet
from . import googlenet, inception_v3, resnext
from . import long_context_lm, lstm_lm

_BUILDERS = {
    "lenet": lenet.get_symbol,
    "mlp": mlp.get_symbol,
    "alexnet": alexnet.get_symbol,
    "vgg": vgg.get_symbol,
    "vgg16": lambda num_classes=1000, **kw: vgg.get_symbol(num_classes, 16, **kw),
    "vgg19": lambda num_classes=1000, **kw: vgg.get_symbol(num_classes, 19, **kw),
    "resnet": resnet.get_symbol,
    "resnet-18": lambda num_classes=1000, **kw: resnet.get_symbol(num_classes, 18, **kw),
    "resnet-34": lambda num_classes=1000, **kw: resnet.get_symbol(num_classes, 34, **kw),
    "resnet-50": lambda num_classes=1000, **kw: resnet.get_symbol(num_classes, 50, **kw),
    "resnet-101": lambda num_classes=1000, **kw: resnet.get_symbol(num_classes, 101, **kw),
    "resnet-152": lambda num_classes=1000, **kw: resnet.get_symbol(num_classes, 152, **kw),
    "inception-bn": inception_bn.get_symbol,
    "mobilenet": mobilenet.get_symbol,
    "googlenet": googlenet.get_symbol,
    "inception-v3": inception_v3.get_symbol,
    "resnext": resnext.get_symbol,
    "resnext-50": lambda num_classes=1000, **kw: resnext.get_symbol(
        num_classes, 50, **kw),
    "resnext-101": lambda num_classes=1000, **kw: resnext.get_symbol(
        num_classes, 101, **kw),
}


def get_symbol(name, num_classes=1000, **kwargs):
    key = name.lower()
    if key not in _BUILDERS:
        raise KeyError("unknown model %r; available: %s"
                       % (name, sorted(_BUILDERS)))
    return _BUILDERS[key](num_classes=num_classes, **kwargs)
