"""Model zoo — symbol builders (port of ``mxnet_tpu/models/__init__.py``).

``get_symbol(name, num_classes, **kwargs)`` dispatches by name over the
ResNet family; ``models.lstm_lm`` builds the LSTM language model
(``lstm_lm_sym``, ``make_sym_gen``); ``models.long_context_lm`` is the
long-context causal LM of example/long-context/train_lm.py (``build_params``,
``apply_model``, ``make_step``).  The other builders come with the slices
that serve them.
"""
from . import long_context_lm, lstm_lm, resnet

_BUILDERS = {
    "resnet": resnet.get_symbol,
    "resnet-18": lambda num_classes=1000, **kw: resnet.get_symbol(num_classes, 18, **kw),
    "resnet-34": lambda num_classes=1000, **kw: resnet.get_symbol(num_classes, 34, **kw),
    "resnet-50": lambda num_classes=1000, **kw: resnet.get_symbol(num_classes, 50, **kw),
    "resnet-101": lambda num_classes=1000, **kw: resnet.get_symbol(num_classes, 101, **kw),
    "resnet-152": lambda num_classes=1000, **kw: resnet.get_symbol(num_classes, 152, **kw),
}


def get_symbol(name, num_classes=1000, **kwargs):
    key = name.lower()
    if key not in _BUILDERS:
        raise KeyError("unknown model %r; available: %s"
                       % (name, sorted(_BUILDERS)))
    return _BUILDERS[key](num_classes=num_classes, **kwargs)
