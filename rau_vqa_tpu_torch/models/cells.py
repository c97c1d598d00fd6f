"""LSTM cells of the RAU model as plain functions on tensors.

Two cells with the reference's two gate conventions:

- ``deep_lstm_cell``: the question LSTM (reference model/DeepLSTM.lua).
  Packed state ``[B, 2*n*R]`` of per-layer ``(c, h)`` pairs; gate layout
  ``[in, forget, out | in_transform]`` (DeepLSTM.lua:47-54).  In training,
  dropout hits the input of layers >= 2 only (DeepLSTM.lua:39).
- ``att_lstm_cell``: the answering-unit LSTM (reference model/ATTLSTM.lua).
  Separate ``c`` / ``h`` tensors; gate layout ``[in, in_transform, forget,
  out]`` (ATTLSTM.lua:16-19).  In training, dropout hits every layer's input
  (ATTLSTM.lua:52).

Weights are ``[in, out]`` (``x @ W``), as in the JAX package.  Dropout masks
come from an explicit ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

Params = Dict


def keep_mask(shape, rate: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Where inverted dropout at ``rate`` keeps an element: a bool tensor of
    ``shape``, drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def apply_keep(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout of ``x`` by a ``keep_mask``: kept elements scaled by
    ``1 / (1 - rate)``, the others 0."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout (scale at train time), torch nn.Dropout semantics."""
    if not train or rate <= 0.0:
        return x
    return apply_keep(x, keep_mask(x.shape, rate, generator, x.device), rate)


def _uniform(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (u * (2.0 * scale) - scale).to(device)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, scale: float,
                device) -> Params:
    return {"w": _uniform(gen, (d_in, d_out), scale, device),
            "b": _uniform(gen, (d_out,), scale, device)}


def lstm_init(gen: torch.Generator, input_size: int, rnn_size: int,
              n_layers: int, scale: float = 0.08, device="cpu") -> Params:
    """Stacked LSTM layers with fused 4-gate input and hidden projections
    (i2h/h2h at DeepLSTM.lua:43-44, ATTLSTM.lua:6-7)."""
    layers: List[Params] = []
    d_in = input_size
    for _ in range(n_layers):
        p_i = linear_init(gen, d_in, 4 * rnn_size, scale, device)
        p_h = linear_init(gen, rnn_size, 4 * rnn_size, scale, device)
        layers.append({"wi": p_i["w"], "bi": p_i["b"],
                       "wh": p_h["w"], "bh": p_h["b"]})
        d_in = rnn_size
    return {"layers": layers}


def deep_lstm_cell(params: Params, x: torch.Tensor, state: torch.Tensor, *,
                   rnn_size: int, dropout_rate: float = 0.0,
                   in_keep: Optional[Sequence[torch.Tensor]] = None,
                   l1_in_gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One timestep of the packed-state question LSTM.

    ``in_keep``: in training, the ``keep_mask`` of each dropped input, that
    of layer ``L + 2`` at ``in_keep[L]``; the caller draws them for every
    timestep up front, so that a timestep's masks do not depend on how many
    timesteps there are.  ``l1_in_gates``: optional precomputed ``x @ wi +
    bi`` for layer 1, which the encoder hoists out of the time loop as one
    batched product (layer 1's input is never dropped)."""
    R = rnn_size
    inp = x
    outs: List[torch.Tensor] = []
    for L, lp in enumerate(params["layers"]):
        c = state[:, 2 * L * R:(2 * L + 1) * R]
        h = state[:, (2 * L + 1) * R:(2 * L + 2) * R]
        if L > 0 and in_keep is not None:
            inp = apply_keep(inp, in_keep[L - 1], dropout_rate)
        if L == 0 and l1_in_gates is not None:
            gates = l1_in_gates + (h @ lp["wh"] + lp["bh"])
        else:
            gates = (inp @ lp["wi"] + lp["bi"]) + (h @ lp["wh"] + lp["bh"])
        sig = torch.sigmoid(gates[:, :3 * R])
        i_g, f_g, o_g = sig[:, :R], sig[:, R:2 * R], sig[:, 2 * R:3 * R]
        g_t = torch.tanh(gates[:, 3 * R:])
        next_c = f_g * c + i_g * g_t
        next_h = o_g * torch.tanh(next_c)
        outs += [next_c, next_h]
        inp = next_h
    return torch.cat(outs, dim=1)


def att_lstm_cell(params: Params, x: torch.Tensor, prev_c: torch.Tensor,
                  prev_h: torch.Tensor, *, rnn_size: int,
                  dropout_rate: float = 0.0, train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the answering-unit LSTM with separate (c, h) state."""
    R = rnn_size
    inp = x
    next_cs: List[torch.Tensor] = []
    next_hs: List[torch.Tensor] = []
    for L, lp in enumerate(params["layers"]):
        c = prev_c[:, L * R:(L + 1) * R]
        h = prev_h[:, L * R:(L + 1) * R]
        inp = dropout(inp, dropout_rate, generator, train)
        gates = (inp @ lp["wi"] + lp["bi"]) + (h @ lp["wh"] + lp["bh"])
        i_g = torch.sigmoid(gates[:, :R])
        g_t = torch.tanh(gates[:, R:2 * R])
        f_g = torch.sigmoid(gates[:, 2 * R:3 * R])
        o_g = torch.sigmoid(gates[:, 3 * R:])
        next_c = f_g * c + i_g * g_t
        next_h = o_g * torch.tanh(next_c)
        next_cs.append(next_c)
        next_hs.append(next_h)
        inp = next_h
    return torch.cat(next_cs, dim=1), torch.cat(next_hs, dim=1)
