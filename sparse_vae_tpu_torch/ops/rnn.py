"""Recurrent layers (port of sparse_vae_tpu/ops/rnn.py): `lstm_scan`,
`lstm_step`, `gru_scan`, `StackedRNN` and `BiLSTMEncoder`.

The JAX package runs the recurrence as a `lax.scan` and reaches no Pallas
kernel. Here a layer stack runs through torch's fused RNN (`_VF.lstm` /
`_VF.gru`: cuDNN on the card) with the JAX package's parameters as they
are: `w_ih_{l}` [gates * H, in], `w_hh_{l}` [gates * H, H], `b_ih_{l}` and
`b_hh_{l}`, gate order i, f, g, o for the LSTM and r, z, n for the GRU
(`b_hh` inside r * (...)), which is torch's. A decode step runs the fused
cell (`_VF.lstm_cell` / `_VF.gru_cell`).

Beside it sits the plain version, the JAX package's step loop written out
with its mask hold (`lstm_scan`, `gru_scan`; a StackedRNN's `step_loop`,
set by `use_step_loop`): the tests and chip_smoke.py's oracle call it.
`step_loop_cuda_calls` counts its calls on CUDA tensors, so a path on
the card can show it never ran there.

Masks (True = valid) must be a prefix of each row, as the batcher writes
documents: the fused path packs the rows (`pack_padded_sequence`), holds
each row's state after its last valid token, and gives a row with no
token its initial state, as the step loop's hold does.

The LSTM family computes in fp32 in the JAX package. cuDNN's RNN would
run its products in TF32 while `torch.backends.cudnn.allow_tf32` is True
(torch's default), in the forward and in the backward; the fused path
therefore turns that flag off for the process at its first call on the
card, so the card's LSTM runs in fp32.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
from torch import _VF
from torch.nn.utils.rnn import (PackedSequence, pack_padded_sequence,
                                pad_packed_sequence)

# Calls of the step loop on CUDA tensors (the oracle's, never a path's).
step_loop_cuda_calls = 0

GATES = {"LSTM": 4, "GRU": 3}


def _count(x):
    global step_loop_cuda_calls
    if x.is_cuda:
        step_loop_cuda_calls += 1


def lstm_step(xt_proj, w_hh, b_hh, h, c):
    """One LSTM step on the input projection xt_proj [B, 4H] = x W_ih^T +
    b_ih: returns (h, c)."""
    gates = xt_proj + h @ w_hh.T + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_scan(x_proj, w_hh, b_hh, h0, c0, mask=None):
    """The step loop of one LSTM layer over x_proj [B, L, 4H]. mask
    [B, L] (True = valid): the state is held at invalid steps, so the
    final (h_n, c_n) is the state after each row's last valid token.
    Returns (outputs [B, L, H], (h_n, c_n))."""
    _count(x_proj)
    h, c, outs = h0, c0, []
    for t in range(x_proj.shape[1]):
        h_new, c_new = lstm_step(x_proj[:, t], w_hh, b_hh, h, c)
        if mask is None:
            h, c = h_new, c_new
        else:
            keep = mask[:, t, None]
            h = torch.where(keep, h_new, h)
            c = torch.where(keep, c_new, c)
        outs.append(h)
    return torch.stack(outs, dim=1), (h, c)


def gru_scan(x_proj, w_hh, b_hh, h0):
    """The step loop of one GRU layer over x_proj [B, L, 3H] (torch's gate
    math): returns (outputs [B, L, H], h_n)."""
    _count(x_proj)
    h, outs = h0, []
    for t in range(x_proj.shape[1]):
        hg = h @ w_hh.T + b_hh
        xr, xz, xn = x_proj[:, t].chunk(3, dim=-1)
        hr, hz, hn = hg.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, dim=1), h


def prefix_lengths(mask) -> torch.Tensor:
    """Each row's valid count [B] (int64, on the host), checking that the
    mask is a prefix of every row."""
    lengths = mask.sum(dim=1)
    pos = torch.arange(mask.shape[1], device=mask.device)
    if not bool((mask == (pos[None, :] < lengths[:, None])).all()):
        raise ValueError("an RNN mask must be a prefix of every row")
    return lengths.cpu()


class StackedRNN(nn.Module):
    """A unidirectional LSTM or GRU stack with the JAX package's
    parameters. forward(x [B, L, in], initial_state, mask) -> (outputs
    [B, L, H], final states); a state is [(h, c)] per layer for the LSTM,
    [h] per layer for the GRU, zeros when not given. `step` is one decode
    step. With `step_loop` set (`use_step_loop`) the full sequence runs
    through the step loop (the plain version) instead of the fused
    RNN."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, rnn_type: str = "LSTM"):
        super().__init__()
        if rnn_type not in GATES:
            raise ValueError(f"rnn_type must be one of {sorted(GATES)}")
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.rnn_type = rnn_type
        self.step_loop = False
        g = GATES[rnn_type] * hidden_size
        for layer in range(num_layers):
            width = input_size if layer == 0 else hidden_size
            for name, shape in ((f"w_ih_{layer}", (g, width)),
                                (f"w_hh_{layer}", (g, hidden_size)),
                                (f"b_ih_{layer}", (g,)),
                                (f"b_hh_{layer}", (g,))):
                self.register_parameter(name, nn.Parameter(torch.empty(shape)))

    @property
    def lstm(self) -> bool:
        return self.rnn_type == "LSTM"

    def layer_params(self, layer: int):
        return tuple(getattr(self, f"{name}_{layer}")
                     for name in ("w_ih", "w_hh", "b_ih", "b_hh"))

    def zero_state(self, batch_size: int, like) -> list:
        z = like.new_zeros((batch_size, self.hidden_size))
        return [(z, z) if self.lstm else z for _ in range(self.num_layers)]

    def forward(self, x, initial_state: Optional[list] = None, mask=None):
        if initial_state is None:
            initial_state = self.zero_state(x.shape[0], x)
        if self.step_loop:
            return self._step_loop(x, initial_state, mask)
        return self._fused(x, initial_state, mask)

    def _step_loop(self, x, states: list, mask):
        """The JAX package's StackedRNN, step by step (the GRU ignores the
        mask there, and here)."""
        finals = []
        for layer in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self.layer_params(layer)
            x_proj = x @ w_ih.T + b_ih
            if self.lstm:
                x, state = lstm_scan(x_proj, w_hh, b_hh, *states[layer],
                                     mask=mask)
            else:
                x, state = gru_scan(x_proj, w_hh, b_hh, states[layer])
            finals.append(state)
        return x, finals

    def _fused(self, x, states: list, mask):
        """The whole stack in one fused call (cuDNN on the card)."""
        if x.is_cuda:
            torch.backends.cudnn.allow_tf32 = False
        weights = [p for layer in range(self.num_layers)
                   for p in self.layer_params(layer)]
        train = torch.is_grad_enabled()
        if self.lstm:
            hx = (torch.stack([s[0] for s in states]),
                  torch.stack([s[1] for s in states]))
        else:
            hx = torch.stack(states)
        if mask is None or not self.lstm:
            if self.lstm:
                out, h_n, c_n = _VF.lstm(x, hx, weights, True,
                                         self.num_layers, 0.0, train, False,
                                         True)
                return out, list(zip(h_n.unbind(0), c_n.unbind(0)))
            out, h_n = _VF.gru(x, hx, weights, True, self.num_layers, 0.0,
                               train, False, True)
            return out, list(h_n.unbind(0))
        lengths = prefix_lengths(mask)
        packed = pack_padded_sequence(x, lengths.clamp(min=1),
                                      batch_first=True, enforce_sorted=False)
        order, back = packed.sorted_indices, packed.unsorted_indices
        data, h_n, c_n = _VF.lstm(
            packed.data, packed.batch_sizes,
            tuple(s.index_select(1, order) for s in hx), weights, True,
            self.num_layers, 0.0, train, False)
        h_n, c_n = h_n.index_select(1, back), c_n.index_select(1, back)
        # A row with no token holds its initial state (the packed run took
        # one step on its first slot; that step is dropped here).
        empty = (lengths == 0).to(x.device)[None, :, None]
        h_n = torch.where(empty, hx[0], h_n)
        c_n = torch.where(empty, hx[1], c_n)
        out, _ = pad_packed_sequence(
            PackedSequence(data, packed.batch_sizes, order, back),
            batch_first=True, total_length=x.shape[1])
        # Past a row's last token the step loop repeats the held h.
        out = torch.where(mask[..., None], out, h_n[-1][:, None, :])
        return out, list(zip(h_n.unbind(0), c_n.unbind(0)))

    def step(self, x_t, states: list):
        """One decode step: x_t [B, in] -> (output [B, H], new states)."""
        new_states = []
        for layer in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self.layer_params(layer)
            if self.lstm:
                h, c = _VF.lstm_cell(x_t, states[layer], w_ih, w_hh, b_ih,
                                     b_hh)
                new_states.append((h, c))
            else:
                h = _VF.gru_cell(x_t, states[layer], w_ih, w_hh, b_ih, b_hh)
                new_states.append(h)
            x_t = h
        return x_t, new_states


class BiLSTMEncoder(nn.Module):
    """The LSTM-VAE's (bi)LSTM encoder: the final hidden state of each
    direction's last layer, concatenated, [B, H * directions]. The
    directions are two independent stacks, `dir_0` and `dir_1`: layer
    l + 1 of a direction reads that direction's layer l only (not both,
    as nn.LSTM(bidirectional=True) would). With a mask, PAD inputs are
    zeroed, the forward direction reads each row's valid prefix and the
    backward direction that prefix reversed; c0 [directions, H] starts
    every layer of direction d at (tanh(c0[d]), c0[d])."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bidirectional: bool = True):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.directions = 2 if bidirectional else 1
        for d in range(self.directions):
            setattr(self, f"dir_{d}",
                    StackedRNN(input_size, hidden_size, num_layers))

    def forward(self, x, mask=None, c0=None):
        b, length = x.shape[:2]
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
            lengths = mask.sum(dim=1)
        finals: List[torch.Tensor] = []
        for d in range(self.directions):
            if d == 0:
                xd = x
            elif mask is None:
                xd = torch.flip(x, dims=(1,))
            else:
                # Row r's position t reads its token n_r - 1 - t.
                idx = (lengths[:, None] - 1
                       - torch.arange(length, device=x.device)[None, :])
                xd = torch.gather(x, 1, idx.clamp(0, length - 1)[..., None]
                                  .expand(-1, -1, x.shape[-1]))
                xd = torch.where((idx >= 0)[..., None], xd, 0.0)
            init = None
            if c0 is not None:
                c = c0[d].expand(b, self.hidden_size)
                init = [(torch.tanh(c), c)] * self.num_layers
            _, states = getattr(self, f"dir_{d}")(xd, init, mask=mask)
            finals.append(states[-1][0])
        return torch.cat(finals, dim=-1)


def use_step_loop(model: nn.Module, on: bool = True) -> nn.Module:
    """Route every StackedRNN of `model` through the step loop (on) or the
    fused RNN; returns the model."""
    for module in model.modules():
        if isinstance(module, StackedRNN):
            module.step_loop = on
    return model
