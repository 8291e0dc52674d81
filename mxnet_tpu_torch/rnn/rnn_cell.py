"""RNN cells and unrolling (ref: python/mxnet/rnn/rnn_cell.py).

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py``, building the same symbols
with the same names: BaseRNNCell (``__call__``, ``unroll``,
``begin_state``, ``pack_weights``/``unpack_weights``), RNNCell, LSTMCell,
GRUCell, FusedRNNCell (over the fused RNN op, ``unfuse()`` into explicit
cells), SequentialRNNCell, BidirectionalCell, DropoutCell, ZoneoutCell and
ModifierCell.

Gate order i,f,g,o for LSTM and r,z,n for GRU, the same in the explicit
cells and the fused RNN op, so a fused cell and its ``unfuse()`` compute
the same function on the same (unpacked) weights. Weight packing and
unpacking keep the arrays on their device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .. import symbol as sym
from ..ops.rnn_op import _param_slices


def _tensor(v):
    """The tensor of an NDArray, a tensor or a numpy array."""
    from ..ndarray import NDArray
    if isinstance(v, NDArray):
        return v.data
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(v))


class RNNParams(object):
    """Container for cell parameter symbols (ref: rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [info["shape"] if info else None for info in self.state_info]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        raise NotImplementedError()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def begin_state(self, func=None, **kwargs):
        """Initial states. Default: Variables (fed like the reference's
        init_h/init_c iterator-provided states); pass func=sym.zeros-like
        factories for constant init."""
        assert not getattr(self, "_modified", False)
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is None:
                state = sym.Variable(name, **kwargs)
            else:
                if info is not None:
                    kw = dict(kwargs)
                    kw.update(info)
                    state = func(name=name, **kw)
                else:
                    state = func(name=name, **kwargs)
            states.append(state)
        return states

    # -- weight (un)packing (ref: rnn_cell.py unpack_weights) -----------
    def unpack_weights(self, args):
        args = dict(args)
        h = getattr(self, "_num_hidden", None)
        if h is None:
            return args
        from .. import ndarray as nd
        for group in ("i2h", "h2h"):
            weight = _tensor(args.pop("%s%s_weight" % (self._prefix, group)))
            bias = _tensor(args.pop("%s%s_bias" % (self._prefix, group)))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group, gate)
                args[wname] = nd.NDArray(weight[j * h:(j + 1) * h].clone())
                bname = "%s%s%s_bias" % (self._prefix, group, gate)
                args[bname] = nd.NDArray(bias[j * h:(j + 1) * h].clone())
        return args

    def pack_weights(self, args):
        from .. import ndarray as nd
        args = dict(args)
        h = getattr(self, "_num_hidden", None)
        if h is None:
            return args
        for group in ("i2h", "h2h"):
            ws = []
            bs = []
            for gate in self._gate_names:
                ws.append(_tensor(args.pop("%s%s%s_weight"
                                           % (self._prefix, group, gate))))
                bs.append(_tensor(args.pop("%s%s%s_bias"
                                           % (self._prefix, group, gate))))
            args["%s%s_weight" % (self._prefix, group)] = nd.NDArray(
                torch.cat(ws))
            args["%s%s_bias" % (self._prefix, group)] = nd.NDArray(
                torch.cat(bs))
        return args

    # -- unroll (ref: rnn_cell.py:90-316) -------------------------------
    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        if inputs is None:
            inputs = [sym.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, sym.Symbol):
            assert len(inputs.list_outputs()) == 1, \
                "unroll doesn't allow grouped symbol as input"
            axis = layout.find("T")
            inputs = sym.SliceChannel(data=inputs, axis=axis,
                                      num_outputs=length, squeeze_axis=1)
            inputs = [inputs[i] for i in range(length)]
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [sym.expand_dims(data=o, axis=1) for o in outputs]
            outputs = sym.Concat(*outputs, dim=1)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (ref: rnn_cell.py RNNCell)."""

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

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB, num_hidden=self._num_hidden,
                                 name="%sh2h" % name)
        output = sym.Activation(data=i2h + h2h, act_type=self._activation,
                                name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order i,f,g,o (ref: rnn_cell.py LSTMCell)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        from ..initializer import LSTMBias
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias",
                                   init=LSTMBias(forget_bias=forget_bias))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

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
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden * 4,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden * 4,
                                 name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = sym.SliceChannel(data=gates, num_outputs=4, axis=1,
                                       name="%sslice" % name)
        in_gate = sym.Activation(data=slice_gates[0], act_type="sigmoid")
        forget_gate = sym.Activation(data=slice_gates[1], act_type="sigmoid")
        in_transform = sym.Activation(data=slice_gates[2], act_type="tanh")
        out_gate = sym.Activation(data=slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * sym.Activation(data=next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order r,z,n (ref: rnn_cell.py GRUCell)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
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
        prev_h = states[0]
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden * 3,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=prev_h, weight=self._hW, bias=self._hB,
                                 num_hidden=self._num_hidden * 3,
                                 name="%sh2h" % name)
        i2h_s = sym.SliceChannel(data=i2h, num_outputs=3, axis=1)
        h2h_s = sym.SliceChannel(data=h2h, num_outputs=3, axis=1)
        reset_gate = sym.Activation(data=i2h_s[0] + h2h_s[0],
                                    act_type="sigmoid")
        update_gate = sym.Activation(data=i2h_s[1] + h2h_s[1],
                                     act_type="sigmoid")
        next_h_tmp = sym.Activation(data=i2h_s[2] + reset_gate * h2h_s[2],
                                    act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN over the RNN op (ref: rnn_cell.py:497)."""

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
        self._directions = 2 if bidirectional else 1

    @property
    def state_info(self):
        b = self._directions * self._num_layers
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

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        assert inputs is not None, "FusedRNNCell requires symbolic inputs"
        axis = layout.find("T")
        if isinstance(inputs, list):
            inputs = [sym.expand_dims(data=i, axis=axis) for i in inputs]
            inputs = sym.Concat(*inputs, dim=axis)
        if layout == "NTC":
            inputs = sym.SwapAxis(data=inputs, dim1=0, dim2=1)  # -> TNC
        if begin_state is None:
            begin_state = self.begin_state()
        states = list(begin_state)
        rnn_args = dict(data=inputs, parameters=self._parameter,
                        state=states[0])
        if self._mode == "lstm":
            rnn_args["state_cell"] = states[1]
        rnn = sym.RNN(state_size=self._num_hidden,
                      num_layers=self._num_layers, mode=self._mode,
                      bidirectional=self._bidirectional, p=self._dropout,
                      state_outputs=self._get_next_state,
                      name="%srnn" % self._prefix, **rnn_args)
        if self._get_next_state:
            outputs = rnn[0]
            states = ([rnn[1], rnn[2]] if self._mode == "lstm" else [rnn[1]])
        else:
            outputs = rnn if isinstance(rnn, sym.Symbol) and \
                len(rnn.list_outputs()) == 1 else rnn[0]
            states = []
        if layout == "NTC":
            outputs = sym.SwapAxis(data=outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = sym.SliceChannel(data=outputs, axis=axis,
                                       num_outputs=length, squeeze_axis=1)
            outputs = [outputs[i] for i in range(length)]
        return outputs, states

    # -- pack/unpack between the flat vector and per-gate weights -------
    def unpack_weights(self, args):
        from .. import ndarray as nd
        args = dict(args)
        arr = _tensor(args.pop("%sparameters" % self._prefix))
        h = self._num_hidden
        cells = self._slice_cells()
        input_size = self._infer_input_size(arr)
        slices, _total = _param_slices(self._mode, input_size, h,
                                       self._num_layers, self._bidirectional)
        for (layer, dr), cell_prefix in cells.items():
            wx, wh, bx, bh = slices[(layer, dr)]
            for spec, nm in ((wx, "i2h_weight"), (wh, "h2h_weight"),
                             (bx, "i2h_bias"), (bh, "h2h_bias")):
                off, nsz, shape = spec
                args[cell_prefix + nm] = nd.NDArray(
                    arr[off:off + nsz].reshape(shape).clone())
        return args

    def pack_weights(self, args):
        from .. import ndarray as nd
        args = dict(args)
        h = self._num_hidden
        cells = self._slice_cells()
        sample = _tensor(args["%sl0_i2h_weight" % self._prefix])
        input_size = sample.shape[1]
        slices, total = _param_slices(self._mode, input_size, h,
                                      self._num_layers, self._bidirectional)
        flat = torch.zeros(total, dtype=torch.float32, device=sample.device)
        for (layer, dr), cell_prefix in cells.items():
            wx, wh, bx, bh = slices[(layer, dr)]
            for spec, nm in ((wx, "i2h_weight"), (wh, "h2h_weight"),
                             (bx, "i2h_bias"), (bh, "h2h_bias")):
                off, nsz, shape = spec
                flat[off:off + nsz] = _tensor(args.pop(
                    cell_prefix + nm)).reshape(-1).to(flat.device)
        args["%sparameters" % self._prefix] = nd.NDArray(flat)
        return args

    def _slice_cells(self):
        cells = {}
        for layer in range(self._num_layers):
            for dr in range(self._directions):
                suffix = "" if dr == 0 else "_r"
                cells[(layer, dr)] = "%sl%d%s_" % (self._prefix, layer, suffix)
        return cells

    def _infer_input_size(self, arr):
        # invert rnn_param_size for layer-0 input size
        g = self._num_gates
        h = self._num_hidden
        d = self._directions
        L = self._num_layers
        total = arr.numel()
        # total = d*(g*h*i + g*h*h) + (L-1)*d*(g*h*h*d + g*h*h) + L*d*2*g*h
        rest = (L - 1) * d * (g * h * h * d + g * h * h) + L * d * 2 * g * h
        return (total - rest - d * g * h * h) // (d * g * h)

    def unfuse(self):
        """Equivalent SequentialRNNCell of explicit cells (ref: unfuse())."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden, "relu", p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh", p),
            "lstm": lambda p: LSTMCell(self._num_hidden, p),
            "gru": lambda p: GRUCell(self._num_hidden, p)}[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sl%d_r_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix,
                                                                i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells (ref: rnn_cell.py SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params
            cell.params._params.update(self.params._params)
            self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not getattr(self, "_modified", False)
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
            next_states.append(state)
        return inputs, sum(next_states, [])


class DropoutCell(BaseRNNCell):
    def __init__(self, dropout=0.0, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = sym.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (ref: rnn_cell.py ModifierCell)."""

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
        assert not getattr(self, "_modified", False)
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(init_sym, **kwargs) \
            if init_sym is not None else self.base_cell.begin_state(**kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (ref: rnn_cell.py ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = (lambda p, like: sym.Dropout(
            data=sym.ones_like(data=like), p=p))
        prev_output = self.prev_output if self.prev_output is not None \
            else next_output * 0
        output = (sym.where(condition=mask(self.zoneout_outputs, next_output),
                            x=next_output, y=prev_output)
                  if self.zoneout_outputs > 0.0 else next_output)
        new_states = ([sym.where(condition=mask(self.zoneout_states, ns),
                                 x=ns, y=os)
                       for ns, os in zip(next_states, states)]
                      if self.zoneout_states > 0.0 else next_states)
        self.prev_output = output
        return output, new_states


class BidirectionalCell(BaseRNNCell):
    """Bidirectional wrapper (ref: rnn_cell.py BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not getattr(self, "_modified", False)
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        if isinstance(inputs, sym.Symbol):
            axis = layout.find("T")
            inputs = sym.SliceChannel(data=inputs, axis=axis,
                                      num_outputs=length, squeeze_axis=1)
            inputs = [inputs[i] for i in range(length)]
        if begin_state is None:
            begin_state = self.begin_state()
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False)
        outputs = [sym.Concat(l_o, r_o, dim=1,
                              name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs = [sym.expand_dims(data=o, axis=1) for o in outputs]
            outputs = sym.Concat(*outputs, dim=1)
        return outputs, l_states + r_states
