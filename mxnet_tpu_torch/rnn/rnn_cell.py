"""RNN cells (port of ``mxnet_tpu/rnn/rnn_cell.py``; reference
python/mxnet/rnn/rnn_cell.py:60-608).

Cells build symbolic graphs step by step through ``unroll``;
``FusedRNNCell`` emits the fused ``RNN`` op (one hoisted input
projection and a loop over time per layer, ``ops/nn.py``) and ``unfuse()``
turns it into a ``SequentialRNNCell`` of explicit cells: ``RNNCell``,
``LSTMCell`` or ``GRUCell`` by mode, ``BidirectionalCell`` pairs for a
bidirectional stack and ``DropoutCell``s between layers.  Weight layout
pack/unpack between the fused vector and per-cell i2h/h2h matrices
round-trips (gate order LSTM [i, f, c, o], GRU [r, z, n]).  The modifier
cells (``ZoneoutCell``, ``ResidualCell``) wrap another cell.  ``LSTMCell``
emits the
``_FusedLSTMCell`` op (``kernels/lstm_cell.py``) when
``MXTPU_FUSED_KERNELS`` enables ``lstm_cell`` at symbol-build time, and
the JAX package's exact slice/activation graph otherwise.
"""
from __future__ import annotations

import json

import numpy as np

from .. import ndarray as nd
from .. import symbol
from ..base import MXNetError
from ..ops.nn import rnn_param_size

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]


class RNNParams(object):
    """Container for cell parameters (reference rnn_cell.py:RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract cell (reference rnn_cell.py:BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, init_sym=None, **kwargs):
        """One ``Variable`` per state, named ``<prefix>begin_state_<k>``
        (the JAX package's form: ``func`` is accepted and unused)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        states = []
        for _info in self.state_info:
            self._init_counter += 1
            states.append(symbol.Variable(
                "%sbegin_state_%d" % (self._prefix, self._init_counter)))
        return states

    def _zeros_begin_state(self, ref_batch_first):
        """Default zero initial states, shaped from a reference input symbol
        whose axis 0 is the batch: ``ref * 0 -> Reshape -> sum -> tile``
        (the JAX package's :86-113; a NaN in ``ref`` makes the state NaN,
        in both packages)."""
        states = []
        for info in self.state_info:
            shape = info["shape"]
            known = [int(d) for d in shape if d != 0]
            total = 1
            for d in known:
                total *= d
            base = symbol.Reshape(ref_batch_first * 0, shape=(0, -1))
            z = symbol.sum(base, axis=1, keepdims=True)       # (B, 1)
            z = symbol.tile(z, reps=(1, total))               # (B, prod)
            if len(shape) == 2:
                pass                                          # (B, H)
            elif len(shape) == 3 and shape[1] == 0:
                # fused layout (L*D, B, H): batch in the middle
                z = symbol.Reshape(z, shape=(0, shape[0], shape[2]))
                z = symbol.SwapAxis(z, dim1=0, dim2=1)
            else:
                raise MXNetError(
                    "cannot derive a zero begin state for state shape %s"
                    % (shape,))
            states.append(z)
        return states

    def unpack_weights(self, args):
        """Stacked i2h/h2h weights and biases -> one entry per gate
        (rnn_cell.py:unpack_weights)."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """One entry per gate -> stacked i2h/h2h weights and biases."""
        args = args.copy()
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args["%s%s_weight" % (self._prefix, group_name)] = \
                nd.concatenate(weight)
            args["%s%s_bias" % (self._prefix, group_name)] = \
                nd.concatenate(bias)
        return args

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Unroll the cell over ``length`` steps (rnn_cell.py:unroll)."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs) == 1
            inputs = symbol.SliceChannel(inputs, axis=axis,
                                         num_outputs=length,
                                         squeeze_axis=1)
            inputs = [inputs[i] for i in range(length)]
        if begin_state is None:
            # reference default: zeros (begin_state(func=symbol.zeros));
            # shaped from the data so shapes resolve forward
            begin_state = self._zeros_begin_state(inputs[0])
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=axis) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        """``Activation`` of the named type, or ``activation(inputs)``
        for a callable."""
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (rnn_cell.py:RNNCell): ``act(i2h + h2h)``."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (rnn_cell.py:LSTMCell); gate order [i, f, c, o]."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        # forget gate opens at sigmoid(forget_bias) via the LSTMBias
        # initializer attr (reference rnn_cell.py:388 init.LSTMBias)
        self._iB = self.params.get(
            "i2h_bias",
            __init__=json.dumps(["lstmbias", {"forget_bias": forget_bias}]))
        self._hB = self.params.get("h2h_bias")
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        from ..kernels import fused_enabled
        if fused_enabled("lstm_cell"):
            # one-kernel gate math (kernels/lstm_cell.py);
            # MXTPU_FUSED_KERNELS=0 at symbol-build time gives the exact
            # slice/activation graph below
            fused = symbol._FusedLSTMCell(gates, states[1],
                                          name="%sfused" % name)
            next_h, next_c = fused[0], fused[1]
            return next_h, [next_h, next_c]
        slice_gates = symbol.SliceChannel(gates, num_outputs=4, axis=1,
                                          name="%sslice" % name)
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid",
                                    name="%si" % name)
        forget_gate = symbol.Activation(slice_gates[1], act_type="sigmoid",
                                        name="%sf" % name)
        in_transform = symbol.Activation(slice_gates[2], act_type="tanh",
                                         name="%sc" % name)
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid",
                                     name="%so" % name)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh",
                                              name="%sstate" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (rnn_cell.py:GRUCell); gate order [r, z, n], the new
    gate's h2h part inside the reset product."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=prev_state_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h = symbol.SliceChannel(i2h, num_outputs=3, axis=1,
                                  name="%si2h_slice" % name)
        h2h = symbol.SliceChannel(h2h, num_outputs=3, axis=1,
                                  name="%sh2h_slice" % name)
        reset_gate = symbol.Activation(i2h[0] + h2h[0], act_type="sigmoid",
                                       name="%sr_act" % name)
        update_gate = symbol.Activation(i2h[1] + h2h[1], act_type="sigmoid",
                                        name="%sz_act" % name)
        next_h_tmp = symbol.Activation(i2h[2] + reset_gate * h2h[2],
                                       act_type="tanh", name="%sh_act" % name)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN (rnn_cell.py:FusedRNNCell): emits the ``RNN``
    op."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._parameter = self.params.get("parameters")
        self._directions = ["l", "r"] if bidirectional else ["l"]

    @property
    def state_info(self):
        b = self._num_layers * (2 if self._bidirectional else 1)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_weights(self, arr, li, lh):
        """Slice the fused vector into per-layer/direction/gate views
        (rnn_cell.py:_slice_weights) — mirrors ops/nn.py
        ``_rnn_split_params``."""
        args = {}
        gate_names = self._gate_names
        directions = self._directions
        b = len(directions)
        p = 0
        for layer in range(self._num_layers):
            for direction in directions:
                for gate in gate_names:
                    name = "%s%s%d_i2h%s_weight" % (self._prefix, direction,
                                                    layer, gate)
                    size = (li if layer == 0 else lh * b) * lh
                    args[name] = arr[p:p + size].reshape(
                        (lh, li if layer == 0 else lh * b))
                    p += size
                for gate in gate_names:
                    name = "%s%s%d_h2h%s_weight" % (self._prefix, direction,
                                                    layer, gate)
                    size = lh ** 2
                    args[name] = arr[p:p + size].reshape((lh, lh))
                    p += size
        for layer in range(self._num_layers):
            for direction in directions:
                for gate in gate_names:
                    name = "%s%s%d_i2h%s_bias" % (self._prefix, direction,
                                                  layer, gate)
                    args[name] = arr[p:p + lh]
                    p += lh
                for gate in gate_names:
                    name = "%s%s%d_h2h%s_bias" % (self._prefix, direction,
                                                  layer, gate)
                    args[name] = arr[p:p + lh]
                    p += lh
        assert p == arr.size, "Invalid parameters size for FusedRNNCell"
        return args

    def unpack_weights(self, args):
        """The fused vector -> one (H, in) weight and (H,) bias per layer,
        direction, i2h/h2h and gate, each a copy."""
        args = args.copy()
        arr = args.pop(self._parameter.name)
        b = len(self._directions)
        h = self._num_hidden
        g = self._num_gates
        L = self._num_layers
        # solve input size from total param count
        # total = b*g*h*(i + h + 2) + (L-1)*b*g*h*(b*h + h + 2)
        rest = arr.size - (L - 1) * b * g * h * (b * h + h + 2)
        num_input = rest // (b * g * h) - h - 2
        nargs = self._slice_weights(arr, num_input, self._num_hidden)
        args.update({name: a.copy() for name, a in nargs.items()})
        return args

    def pack_weights(self, args):
        """The inverse of :meth:`unpack_weights`: one float32 vector on the
        first weight's context."""
        args = args.copy()
        w0 = args["%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])]
        num_input = w0.shape[1]
        total = rnn_param_size(self._num_layers, num_input, self._num_hidden,
                               self._bidirectional, self._mode)
        flat = np.zeros(total, dtype="float32")
        p = 0
        # re-walk the same order, writing values in
        gate_names = self._gate_names
        for layer in range(self._num_layers):
            for direction in self._directions:
                for kind in ("i2h", "h2h"):
                    for gate in gate_names:
                        name = "%s%s%d_%s%s_weight" % (
                            self._prefix, direction, layer, kind, gate)
                        w = args.pop(name).asnumpy().reshape(-1)
                        flat[p:p + w.size] = w
                        p += w.size
        for layer in range(self._num_layers):
            for direction in self._directions:
                for kind in ("i2h", "h2h"):
                    for gate in gate_names:
                        name = "%s%s%d_%s%s_bias" % (
                            self._prefix, direction, layer, kind, gate)
                        bias = args.pop(name).asnumpy().reshape(-1)
                        flat[p:p + bias.size] = bias
                        p += bias.size
        args[self._parameter.name] = nd.array(flat, ctx=w0.context)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError("FusedRNNCell cannot be stepped. Please "
                                  "use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        if isinstance(inputs, (list, tuple)):
            inputs = [symbol.expand_dims(i, axis=1) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=1)
            axis = 1
        if axis == 1:
            # NTC -> TNC for the fused op
            inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        if begin_state is None:
            # inputs is TNC here; the zero-state builder wants batch-first
            begin_state = self._zeros_begin_state(
                symbol.SwapAxis(inputs, dim1=0, dim2=1))
        states = begin_state
        if self._mode == "lstm":
            states = {"state": states[0], "state_cell": states[1]}
        else:
            states = {"state": states[0]}
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **states)
        attr_states = []
        if not self._get_next_state:
            outputs = rnn
        elif self._mode == "lstm":
            outputs, attr_states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, attr_states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = symbol.SliceChannel(
                outputs, axis=axis, num_outputs=length, squeeze_axis=1)
            outputs = [outputs[i] for i in range(length)]
        return outputs, attr_states

    def unfuse(self):
        """Fused -> a ``SequentialRNNCell`` of explicit cells, one per
        layer (a ``BidirectionalCell`` pair when bidirectional), with a
        ``DropoutCell`` between layers when ``dropout`` > 0
        (rnn_cell.py:unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden, activation="relu",
                                          prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden, activation="tanh",
                                          prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix,
                                                                i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells (rnn_cell.py:SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs=None, begin_state=None, **kwargs):
        self.reset()
        states = begin_state
        outputs = inputs
        p = 0
        merge = kwargs.pop("merge_outputs", None)
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            outputs, st = cell.unroll(
                length, inputs=outputs,
                begin_state=None if states is None else states[p:p + n],
                merge_outputs=None if i < len(self._cells) - 1 else merge,
                **kwargs)
            next_states.extend(st)
            p += n
        return outputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout on the outputs between layers (rnn_cell.py:DropoutCell);
    it has no state."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Base of the cells that wrap another cell and share its parameters
    and states (rnn_cell.py:ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, init_sym=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(**kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    """Zoneout (rnn_cell.py:ZoneoutCell): in training, each output and
    state unit keeps its previous value with probability
    ``zoneout_outputs`` / ``zoneout_states`` (masks drawn by ``Dropout``
    over ones); in inference the masks are all ones."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = symbol.where(mask(p_outputs, next_output), next_output,
                              prev_output) if p_outputs != 0.0 \
            else next_output
        states = [symbol.where(mask(p_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """A residual connection around a cell (rnn_cell.py:ResidualCell):
    the output is the cell's output plus its input."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs)
        return output, states


class BidirectionalCell(BaseRNNCell):
    """Two cells over the sequence, one forward and one reversed, their
    outputs concatenated per step (rnn_cell.py:BidirectionalCell).  A
    merged (N, T, C) input is reversed on the device by
    ``SequenceReverse``."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. Please "
                                  "use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=None if begin_state is None else begin_state[:n_l],
            layout=layout, merge_outputs=False, input_prefix=input_prefix)
        if isinstance(inputs, list):
            rev_inputs = list(reversed(inputs))
        else:
            rev_inputs = symbol.SwapAxis(symbol.SequenceReverse(
                symbol.SwapAxis(inputs, dim1=0, dim2=1)), dim1=0, dim2=1)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=rev_inputs,
            begin_state=None if begin_state is None else begin_state[n_l:],
            layout=layout, merge_outputs=False, input_prefix=input_prefix)
        outputs = [symbol.Concat(l_o, r_o, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=1) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        return outputs, l_states + r_states
