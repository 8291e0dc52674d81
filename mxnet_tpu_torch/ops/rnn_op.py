"""Fused multi-layer RNN operator (RNN): vanilla, LSTM and GRU,
bidirectional.

Counterpart of ``mxnet_tpu/ops/rnn_op.py``, which computes the recurrence
as a ``lax.scan`` per layer and direction in plain JAX (no Pallas kernel).
Here it runs as the JAX op computes it: one product for the input
projection of every time step of a layer and direction, then the
step-by-step recurrence in plain PyTorch, with autograd for the backward.
It does not call cuDNN's RNN.

Interface (the reference's RNN op):
  inputs: data (T, N, C), parameters (flat vector), state (L*D, N, H)
          [, state_cell (L*D, N, H) for lstm]
  attrs:  state_size, num_layers, mode {rnn_relu, rnn_tanh, lstm, gru},
          bidirectional, p (inter-layer dropout), state_outputs
  outputs: output (T, N, H*D) [, state_out [, statecell_out]]

The packed parameter layout is the JAX package's (and cuDNN's order, which
``FusedRNNCell``'s unpacking relies on): per layer, per direction, W_x
(G*H, I) then W_h (G*H, H); after all the weights come the biases, per
layer, per direction, b_x (G*H,) then b_h (G*H,). Gate order: LSTM i,f,g,o;
GRU r,z,n, with the reset gate applied after the hidden projection.
"""
from __future__ import annotations

import torch

from ..base import attr_bool, attr_float, attr_int, attr_str, MXNetError
from .registry import OpDef, register_def

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    """Total packed parameter count (the layout above)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    total = 0
    for layer in range(num_layers):
        i = input_size if layer == 0 else h * d
        total += d * (g * h * i + g * h * h)   # weights
    total += num_layers * d * 2 * g * h        # biases
    return total


def _param_slices(mode, input_size, state_size, num_layers, bidirectional):
    """Static offsets of each (layer, dir) -> [Wx, Wh, bx, bh] slice, each
    ``(offset, size, shape)``, and the total size."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    slices = {}
    off = 0
    for layer in range(num_layers):
        i = input_size if layer == 0 else h * d
        for dr in range(d):
            wx = (off, g * h * i, (g * h, i))
            off += g * h * i
            wh = (off, g * h * h, (g * h, h))
            off += g * h * h
            slices[(layer, dr)] = [wx, wh, None, None]
    for layer in range(num_layers):
        for dr in range(d):
            bx = (off, g * h, (g * h,))
            off += g * h
            bh = (off, g * h, (g * h,))
            off += g * h
            slices[(layer, dr)][2] = bx
            slices[(layer, dr)][3] = bh
    return slices, off


def _take(params, spec):
    off, n, shape = spec
    return params[off:off + n].reshape(shape)


def _run_direction(mode, xs, h, c, wx, wh, bx, bh, reverse):
    """One layer in one direction over xs (T, N, I): ``(ys, hT, cT)``."""
    hidden = h.shape[-1]
    # the input projection of every step in one product; for the modes
    # whose gates add the hidden bias straight in, it joins here too
    x_proj = torch.matmul(xs, wx.t()) + bx
    if mode != "gru":
        x_proj = x_proj + bh
    wh_t = wh.t()
    ys = [None] * xs.shape[0]
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else \
        range(xs.shape[0])
    for t in steps:
        if mode == "lstm":
            gates = torch.addmm(x_proj[t], h, wh_t)
            s = torch.sigmoid(gates)
            g = torch.tanh(gates[:, 2 * hidden:3 * hidden])
            c = torch.addcmul(s[:, hidden:2 * hidden] * c,
                              s[:, :hidden], g)
            h = s[:, 3 * hidden:] * torch.tanh(c)
        elif mode == "gru":
            xr = x_proj[t]
            hr = torch.addmm(bh, h, wh_t)
            rz = torch.sigmoid(xr[:, :2 * hidden] + hr[:, :2 * hidden])
            r, z = rz[:, :hidden], rz[:, hidden:]
            n = torch.tanh(xr[:, 2 * hidden:] + r * hr[:, 2 * hidden:])
            h = (1 - z) * n + z * h
        else:
            gates = torch.addmm(x_proj[t], h, wh_t)
            h = torch.tanh(gates) if mode == "rnn_tanh" else \
                torch.relu(gates)
        ys[t] = h
    return torch.stack(ys), h, c


def _attrs(attrs):
    mode = attr_str(attrs.get("mode", "lstm"), "lstm")
    if mode not in _GATES:
        raise MXNetError("RNN: unknown mode %r (one of %s)"
                         % (mode, ", ".join(sorted(_GATES))))
    return (mode, attr_int(attrs["state_size"]),
            attr_int(attrs.get("num_layers", 1), 1),
            attr_bool(attrs.get("bidirectional", False), False),
            attr_bool(attrs.get("state_outputs", False), False))


def _rnn_inputs(attrs):
    if attr_str(attrs.get("mode", "lstm"), "lstm") == "lstm":
        return ["data", "parameters", "state", "state_cell"]
    return ["data", "parameters", "state"]


def _rnn_outputs(attrs):
    mode = attr_str(attrs.get("mode", "lstm"), "lstm")
    if attr_bool(attrs.get("state_outputs", False), False):
        return (["output", "state_out", "statecell_out"] if mode == "lstm"
                else ["output", "state_out"])
    return ["output"]


def _rnn_infer(attrs, in_shapes):
    mode, h, layers, bi, state_outputs = _attrs(attrs)
    d = 2 if bi else 1
    data = in_shapes[0]
    if data is None:
        raise MXNetError("RNN: data shape required")
    t, n, c = data
    shapes = [tuple(data), (rnn_param_size(mode, c, h, layers, bi),),
              (layers * d, n, h)]
    if mode == "lstm":
        shapes.append((layers * d, n, h))
    outs = [(t, n, h * d)]
    if state_outputs:
        outs.append((layers * d, n, h))
        if mode == "lstm":
            outs.append((layers * d, n, h))
    return shapes, outs, []


def _rnn(op_ctx, attrs, inputs, aux):
    mode, h, layers, bi, state_outputs = _attrs(attrs)
    p = attr_float(attrs.get("p", 0.0), 0.0)
    d = 2 if bi else 1
    data, params, state = inputs[0], inputs[1], inputs[2]
    state_cell = inputs[3] if mode == "lstm" else torch.zeros_like(state)
    slices, total = _param_slices(mode, data.shape[2], h, layers, bi)
    if params.shape[0] != total:
        raise MXNetError("RNN: parameters size %d != expected %d"
                         % (params.shape[0], total))
    xs = data
    h_outs, c_outs = [], []
    for layer in range(layers):
        ys_dirs = []
        for dr in range(d):
            wx, wh, bx, bh = (_take(params, s) for s in slices[(layer, dr)])
            idx = layer * d + dr
            ys, h_t, c_t = _run_direction(mode, xs, state[idx],
                                          state_cell[idx], wx, wh, bx, bh,
                                          reverse=(dr == 1))
            ys_dirs.append(ys)
            h_outs.append(h_t)
            c_outs.append(c_t)
        xs = torch.cat(ys_dirs, dim=-1) if d == 2 else ys_dirs[0]
        if p > 0 and layer < layers - 1 and op_ctx.is_train \
                and op_ctx.rng is not None:
            keep = 1.0 - p
            mask = torch.rand(xs.shape, generator=op_ctx.rng,
                              device=xs.device) < keep
            xs = torch.where(mask, xs / keep,
                             torch.zeros((), dtype=xs.dtype,
                                         device=xs.device))
    outs = [xs]
    if state_outputs:
        outs.append(torch.stack(h_outs))
        if mode == "lstm":
            outs.append(torch.stack(c_outs))
    return tuple(outs)


_RNN = register_def(OpDef("RNN", _rnn, inputs=("data", "parameters", "state"),
                          infer_shape=_rnn_infer, var_outputs=_rnn_outputs,
                          needs_rng=True))
_RNN.list_inputs = _rnn_inputs
