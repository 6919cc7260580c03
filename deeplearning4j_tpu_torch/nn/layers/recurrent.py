"""Recurrent layer math: the Graves LSTM (peepholes) over a sequence and
one step of it (counterpart of `deeplearning4j_tpu/nn/layers/recurrent.py`).

`lstm_forward` takes one of two routes, as the JAX package's dispatch
(`lstm_fused_or_none`, then its `lax.scan`) decides by the call: a
sigmoid gate and a tanh cell in f32 or bf16 with H at most
`ops.lstm.MAX_H` (2048) go to the fused LSTM (`ops/lstm.lstm_fused`: the
CUDA kernels on the card, their plain versions on the CPU); any other
activation, another dtype, or a wider layer runs the plain time loop
below, the counterpart of the JAX package's `lax.scan` cell (its
recurrent product a plain `torch.matmul`, as XLA computes the scan's
outside any Pallas kernel; gradients by autograd). The route is chosen
from the arguments before any launch, never by a failure, and counted in
`lstm_forward.routes` (through `ops.lstm.count`, under its lock). The JAX
package's TPU preconditions (H a multiple of 128, T >= 2, a batch block
dividing B) are not carried over: the kernels take any H up to MAX_H and
any B.

Layout: activations (B, T, size); gate order [i, f, o, g]. Masked steps
pass the state through unchanged and emit zeros.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Peephole = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def lstm_forward(x: torch.Tensor, W: torch.Tensor, RW: torch.Tensor,
                 b: torch.Tensor, peephole: Peephole, gate_act: Callable,
                 cell_act: Callable, h0: Optional[torch.Tensor] = None,
                 c0: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None, reverse: bool = False,
                 gate_is_sigmoid: bool = False, cell_is_tanh: bool = False):
    """The LSTM over x (B, T, nIn): (outputs (B, T, nOut), (hT, cT)).
    `mask` (B, T), 1 = valid."""
    from deeplearning4j_tpu_torch.ops.lstm import MAX_H, count, lstm_fused

    if gate_is_sigmoid and cell_is_tanh and RW.shape[0] <= MAX_H \
            and x.dtype in (torch.float32, torch.bfloat16):
        count((lstm_forward.routes, "fused"))
        return lstm_fused(x, W, RW, b, peephole, h0, c0, mask=mask,
                          reverse=reverse)
    count((lstm_forward.routes, "loop"))
    B, T, _ = x.shape
    n_out = RW.shape[0]
    zero = torch.zeros((B, n_out), dtype=x.dtype, device=x.device)
    h = zero if h0 is None else h0
    c = zero if c0 is None else c0
    xw = torch.einsum("bti,ig->btg", x, W) + b
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        z = xw[:, t] + h @ RW
        zi, zf, zo, zg = torch.chunk(z, 4, dim=-1)
        if peephole is not None:
            pI, pF, pO = peephole
            zi = zi + pI * c
            zf = zf + pF * c
        i = gate_act(zi)
        f = gate_act(zf)
        g = cell_act(zg)
        c_new = f * c + i * g
        if peephole is not None:
            zo = zo + pO * c_new
        o = gate_act(zo)
        h_new = o * cell_act(c_new)
        if mask is not None:
            m = mask[:, t, None]
            h = torch.where(m > 0, h_new, h)
            c = torch.where(m > 0, c_new, c)
            outs[t] = h * m
        else:
            h, c = h_new, c_new
            outs[t] = h_new
    return torch.stack(outs, dim=1), (h, c)


lstm_forward.routes = {"fused": 0, "loop": 0}


def lstm_step(x_t: torch.Tensor, W: torch.Tensor, RW: torch.Tensor,
              b: torch.Tensor, peephole: Peephole, gate_act: Callable,
              cell_act: Callable, h_prev: torch.Tensor,
              c_prev: torch.Tensor):
    """One timestep for streaming inference (`rnn_time_step`): x_t
    (B, nIn) -> (h (B, nOut), (h, c)). Plain PyTorch, as the JAX
    package's `lstm_step` is plain jnp."""
    z = x_t @ W + b + h_prev @ RW
    zi, zf, zo, zg = torch.chunk(z, 4, dim=-1)
    if peephole is not None:
        pI, pF, pO = peephole
        zi = zi + pI * c_prev
        zf = zf + pF * c_prev
    i = gate_act(zi)
    f = gate_act(zf)
    g = cell_act(zg)
    c_new = f * c_prev + i * g
    if peephole is not None:
        zo = zo + peephole[2] * c_new
    o = gate_act(zo)
    h_new = o * cell_act(c_new)
    return h_new, (h_new, c_new)
