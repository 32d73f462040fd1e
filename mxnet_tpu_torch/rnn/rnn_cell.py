"""RNN cells (port of ``mxnet_tpu/rnn/rnn_cell.py``; reference
python/mxnet/rnn/rnn_cell.py:60-608).

Cells build symbolic graphs step by step through ``unroll``;
``FusedRNNCell`` emits the fused ``RNN`` op (one hoisted input
projection and a loop over time per layer, ``ops/nn.py``) and ``unfuse()``
turns it into a ``SequentialRNNCell`` of ``LSTMCell``s.  Weight layout
pack/unpack between the fused vector and per-cell i2h/h2h matrices
round-trips (gate order LSTM [i, f, c, o]).  ``LSTMCell`` emits the
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

__all__ = ["RNNParams", "BaseRNNCell", "LSTMCell", "FusedRNNCell",
           "SequentialRNNCell"]


def _later(what):
    raise MXNetError("%s is not ported yet (it comes with the RNN cells "
                     "slice of mxnet_tpu_torch)" % what)


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
        """Fused -> a ``SequentialRNNCell`` of explicit ``LSTMCell``s, one
        per layer (rnn_cell.py:unfuse).  The other modes, bidirectional
        stacks and inter-layer dropout need cells of a later slice."""
        if self._mode != "lstm":
            _later("FusedRNNCell.unfuse for mode %r (RNNCell/GRUCell)"
                   % self._mode)
        if self._bidirectional:
            _later("FusedRNNCell.unfuse of a bidirectional stack "
                   "(BidirectionalCell)")
        if self._dropout > 0 and self._num_layers > 1:
            _later("FusedRNNCell.unfuse with dropout (DropoutCell)")
        stack = SequentialRNNCell()
        for i in range(self._num_layers):
            stack.add(LSTMCell(self._num_hidden,
                               prefix="%sl%d_" % (self._prefix, i)))
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
