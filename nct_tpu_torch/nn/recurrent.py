"""Recurrent layers: RNN, LSTM and LSTMUnit (port of
``nct_tpu/nn/recurrent.py``).

Caffe's recurrent stack (reference: src/caffe/layers/recurrent_layer.cpp,
rnn_layer.cpp, lstm_layer.cpp, lstm_unit_layer.cpp) unrolls the recurrence
into one layer set per time step.  Here the input transform of the whole
sequence is one product, and a Python loop over the time steps runs the
recurrent products and gates.

Contract (recurrent_layer.hpp):
  * bottoms: ``x`` [T, N, ...] (trailing dims flattened to the input size),
    ``cont`` [T, N] sequence-continuation indicators (0 restarts a stream
    at that step), optional ``x_static`` [N, ...] per-stream input folded
    into every timestep;
  * ``recurrent_param { num_output, expose_hidden }``; with
    ``expose_hidden`` the initial recurrent state arrives as extra bottoms
    (h0 [1, N, H]; LSTM also c0) and the final state leaves as extra tops;
  * top: the output sequence [T, N, num_output].

Cell equations (rnn_layer.hpp:24-26, lstm_layer.hpp:26-31 — gate order
i, f, o, g as in lstm_layer.cpp:209-218):

  RNN:   h_t = tanh(W_hh (cont_t * h_{t-1}) + W_xh x_t + b_h)
         o_t = tanh(W_ho h_t + b_o)
  LSTM:  [i f o g] = W_xc x_t + b_c + W_hc (cont_t * h_{t-1}) [+ W_xc_static x_static]
         c_t = cont_t * (sigmoid(f) * c_{t-1}) + sigmoid(i) * tanh(g)
         h_t = sigmoid(o) * tanh(c_t)

Weights keep the JAX package's layout, pre-transposed for [N, D] x [D, H]
products: ``w_x`` [D, (4)H], ``w_h`` [H, (4)H], ``b`` [(4)H]; RNN adds
``w_o`` [H, H] and ``b_o`` [H]; ``w_static`` [E, (4)H] when x_static is
wired.
"""

from __future__ import annotations

import torch

from nct_tpu_torch.nn.layers import register_layer


def _recurrent_io(cfg, bottoms, n_state: int):
    """(x [T, N, D], cont, x_static, init_states, expose) per the
    recurrent_layer.cpp bottom ordering: x, cont[, x_static][, h0[, c0]]."""
    rp = cfg.get("recurrent_param", {}) or {}
    expose = rp.get("expose_hidden") in (True, "true")
    x = bottoms[0].reshape(bottoms[0].shape[0], bottoms[0].shape[1], -1)
    rest = list(bottoms[2:])
    inits = rest[-n_state:] if expose and len(rest) >= n_state else []
    if inits:
        rest = rest[:-n_state]
    x_static = rest[0].reshape(rest[0].shape[0], -1) if rest else None
    return x, bottoms[1].to(x.dtype), x_static, inits, expose


def _input_transform(params, x, x_static):
    """W_x x_t + b for every step at once (+ the static input's term)."""
    xw = torch.einsum("tnd,dh->tnh", x, params["w_x"]) + params["b"]
    if x_static is not None and "w_static" in params:
        xw = xw + (x_static @ params["w_static"])[None]
    return xw


@register_layer("RNN")
def rnn_layer(params, cfg, *bottoms):
    x, cont, x_static, inits, expose = _recurrent_io(cfg, bottoms, 1)
    n = x.shape[1]
    h_dim = params["w_h"].shape[0]
    h = (inits[0].reshape(n, h_dim) if inits
         else x.new_zeros((n, h_dim)))
    xw = _input_transform(params, x, x_static)
    outs = []
    for t in range(x.shape[0]):
        h = torch.tanh((h * cont[t][:, None]) @ params["w_h"] + xw[t])
        outs.append(torch.tanh(h @ params["w_o"] + params["b_o"]))
    outs = torch.stack(outs)
    return (outs, h[None]) if expose else outs


@register_layer("LSTMUnit")
def lstm_unit_layer(params, cfg, c_prev, gate_input, cont):
    """Single LSTM step (lstm_unit_layer.cpp:40-62): bottoms
    c_prev [1, N, H], gate_input [1, N, 4H] (pre-activation, order
    i, f, o, g), cont [1, N]; tops (c [1, N, H], h [1, N, H]).
    f is gated by cont (i = sig(X_i), f = cont * sig(X_f))."""
    i, f, o, g = torch.chunk(gate_input, 4, dim=-1)
    f = cont[..., None] * torch.sigmoid(f)
    c = f * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


@register_layer("LSTM")
def lstm_layer(params, cfg, *bottoms):
    x, cont, x_static, inits, expose = _recurrent_io(cfg, bottoms, 2)
    n = x.shape[1]
    h_dim = params["w_h"].shape[0]
    if inits:
        h = inits[0].reshape(n, h_dim)
        c = inits[1].reshape(n, h_dim)
    else:
        h = x.new_zeros((n, h_dim))
        c = x.new_zeros((n, h_dim))
    # W_xc x_t + b_c for the whole sequence (the reference's single big
    # x_transform InnerProduct, lstm_layer.cpp:107-116)
    xw = _input_transform(params, x, x_static)
    outs = []
    for t in range(x.shape[0]):
        cont_t = cont[t][:, None]
        gates = xw[t] + (h * cont_t) @ params["w_h"]
        i, f, o, g = torch.chunk(gates, 4, dim=-1)
        c = cont_t * (torch.sigmoid(f) * c) + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    outs = torch.stack(outs)
    return (outs, h[None], c[None]) if expose else outs
