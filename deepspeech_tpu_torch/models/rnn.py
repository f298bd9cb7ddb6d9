"""Recurrent stack: (bi)directional GRU or LSTM layers.

As in the JAX package, the input projection ``x @ W_x`` for all frames
is hoisted out of the time loop into one large matmul, in the model
dtype; only ``h @ W_h`` stays in the recurrence. A bidirectional layer
runs both directions over the same projection (the reverse one over
the flipped time axis) and sums them. The projection is made
time-major, ``[T, B, 3H]`` (GRU) or ``[T, B, 4H]`` (LSTM), the layout
the recurrence reads.

A GRU layer's recurrence is ``ops/gru.py``'s ``GRUFunction``: one
``gru_fwd`` call per layer, both directions in it, and one ``gru_bwd``
call in the backward, so gradients reach ``wx``, ``wh_*`` and
``bh_*``; each call launches one kernel, resident or streamed as
``ops/gru.py``'s ``resident_fits`` decides (ds2_full's H=1760 streams).
An LSTM layer (``rnn_type="lstm"``) is ``ops/lstm.py``'s
``LSTMFunction`` when a gradient may be needed: one taped ``lstm_fwd``
call per layer, both directions in it, and one ``lstm_bwd`` call in the
backward; without a gradient it makes the one ``lstm_fwd`` call
untaped. The JAX model calls ``lstm_scan_pallas`` once per direction
(models/rnn.py:242-251): the same function. ``gru_scan`` and
``lstm_scan`` below are the plain oracles with the JAX package's
signatures; the tests hold them to the JAX ones, and no layer calls
them. ``layer_body`` is a layer after its BN (projection, recurrence,
mask) as ``RNNLayer`` and the pipelined stack (``pipe_stack.py``) both
run it; ``chunk_recurrence`` is one direction of its recurrence over a
chunk of frames from a carried state, with the final state out, the call
the sequence-parallel relay (``parallel/seqpar.py``) makes on each shard:
``gru_fwd`` (K6, or K8 at a streamed width) or ``lstm_fwd`` (K12, or
K14) at D=1, and under a gradient ``GRUFunction`` at D=1 with the carry
as its ``h0`` (its backward K7, or K9, with ``h0`` and ``dh0``) or
``LSTMFunction`` with ``(h0, c0)`` (its backward K13, or K15, with
``dcfin`` in and ``(dh0, dc0)`` out).

A quantized layer (``quantized=True``, inference only) holds ``wh_*``
int8 with their per-column scales and calls ``ops/gru.py``'s
``gru_fwd_q`` (or ``ops/lstm.py``'s ``lstm_fwd_q``) once per forward,
both directions in it, as the JAX model sends int8 ``W_h`` into
``gru_scan_pallas_q`` / ``lstm_scan_pallas_q`` (models/rnn.py:205); its
``wx`` kernel is int8 too, dequantized where it is used.

Gate conventions, GRU (r, z, n):
  r = sigmoid(xp_r + h W_r + b_r)
  z = sigmoid(xp_z + h W_z + b_z)
  n = tanh(xp_n + r * (h W_n + b_n))
  h' = (1 - z) * n + z * h
LSTM (i, f, g, o; the forget gate's +1 as in the JAX package):
  i, f, g, o = sigmoid(.), sigmoid(. + 1), tanh(.), sigmoid(.) of
  xp + h W + b;  c' = f c + i g;  h' = o tanh(c')
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import gru as gru_ops
from ..ops import lstm as lstm_ops
from ..ops.gru import GRUFunction, gru_fwd_plain
from ..ops.lstm import LSTMFunction, lstm_plain_loop
from .layers import (Dense, MaskedBatchNorm, QWeight, dense, length_mask,
                     weight)

_N_GATES = {"gru": 3, "lstm": 4}


def gru_scan(xproj: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor,
             b_h: torch.Tensor, reverse: bool = False,
             dot_dtype: Optional[torch.dtype] = None,
             h0: Optional[torch.Tensor] = None,
             return_final: bool = False):
    """The GRU recurrence with the JAX oracle's signature.

    xproj [B, T, 3H] (includes b_x), mask [B, T] (1 = valid). Returns
    outputs [B, T, H] float32, or ``(outputs, final_carry [B, H])`` when
    ``return_final``. ``dot_dtype`` rounds the recurrent product's
    operands (None keeps float32); ``h0`` seeds a forward scan.
    """
    if reverse and (return_final or h0 is not None):
        raise ValueError("streaming carry only supports forward scans")
    w = w_h.to(dot_dtype or torch.float32)
    ys, hfin = gru_fwd_plain(
        xproj.transpose(0, 1), mask.t().float(), w[None],
        b_h.float()[None], None if h0 is None else h0.float()[None],
        (reverse,))
    ys = ys[0].transpose(0, 1)
    return (ys, hfin[0]) if return_final else ys


def lstm_scan(xproj: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor,
              b_h: torch.Tensor, reverse: bool = False,
              dot_dtype: Optional[torch.dtype] = None,
              remat_chunk: int = 0,
              hc0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              return_final: bool = False):
    """The LSTM recurrence with the JAX oracle's signature.

    xproj [B, T, 4H] (i, f, g, o; includes b_x), mask [B, T] (1 = valid).
    Returns outputs [B, T, H] float32, or ``(outputs, (h, c))`` with the
    final carries [B, H] when ``return_final``. ``dot_dtype`` rounds the
    recurrent product's operands (None keeps float32); ``hc0`` = (h0, c0)
    seeds a forward scan. ``remat_chunk`` only bounds the JAX backward's
    memory and leaves the outputs as they are: it is accepted and has
    nothing to do here.
    """
    del remat_chunk
    if reverse and (return_final or hc0 is not None):
        raise ValueError("streaming carry only supports forward scans")
    w = w_h.to(dot_dtype or torch.float32).float()
    hc = None if hc0 is None else (hc0[0].float()[None], hc0[1].float()[None])
    ys, _, hfin, cfin = lstm_plain_loop(
        xproj.transpose(0, 1), mask.t().float(), (reverse,), w.shape[0],
        lambda di, h: h.to(dot_dtype or torch.float32).float() @ w
        + b_h.float(), hc0=hc)
    ys = ys[0].transpose(0, 1)
    return (ys, (hfin[0], cfin[0])) if return_final else ys


def _check_impl(impl: str) -> None:
    # Both names mean the one recurrence the port has for each cell,
    # ops/gru.py's gru_fwd or ops/lstm.py's lstm_fwd; they are accepted
    # so that the JAX package's configs and overrides parse.
    if impl not in ("auto", "pallas"):
        raise ValueError(f"rnn_impl {impl!r}: the port runs every "
                         "recurrent layer through its kernels (ops/gru.py, "
                         "ops/lstm.py); use 'auto' or 'pallas'")


def layer_input(cfg: ModelConfig, x: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """A layer's input projection, hoisted out of the recurrence: ``x [B,
    T, C]`` (after the BN) through ``layers.dense`` with the full-precision
    ``kernel [C, GH]`` and ``bias [GH]`` in the model dtype, time-major
    ``[T, B, GH]``."""
    dtype = getattr(torch, cfg.dtype)
    return dense(x.transpose(0, 1), kernel, bias, dtype).contiguous()


def layer_output(cfg: ModelConfig, y: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """A layer's output from its directions' summed ``y [T, B, H]`` f32:
    batch-major, masked, in the model dtype."""
    return (y.transpose(0, 1) * mask[:, :, None]).to(getattr(torch,
                                                             cfg.dtype))


def layer_body(cfg: ModelConfig, x: torch.Tensor, mask: torch.Tensor,
               kernel: torch.Tensor, bias: torch.Tensor, whs,
               bh: torch.Tensor, grad: bool) -> torch.Tensor:
    """A layer after its BN, as ``RNNLayer`` and the pipelined stack's
    stacked slices (``pipe_stack.py``) both run it: ``layer_input``, the
    recurrence over every direction in one call, ``layer_output``.
    ``x [B,T,C]``, ``mask [B,T]`` f32, ``whs`` the directions' ``[H,GH]``
    matrices (``QWeight``s for a quantized layer), ``bh [D,GH]``; the
    first direction runs forward, a second one reversed. ``grad`` (a
    gradient may be needed) takes the autograd functions; an LSTM without
    one makes one untaped ``lstm_fwd`` call."""
    xp_t = layer_input(cfg, x, kernel, bias)
    mask_t = mask.t().contiguous()
    reverse = [False, True][:len(whs)]
    lstm = cfg.rnn_type == "lstm"
    if isinstance(whs[0], QWeight):
        q = torch.stack([w.q for w in whs])
        scale = torch.stack([w.scale for w in whs])
        if lstm:
            ys = lstm_ops.lstm_fwd_q(xp_t, mask_t, q, scale, bh.float(),
                                     reverse)
        else:
            ys, _ = gru_ops.gru_fwd_q(xp_t, mask_t, q, scale, bh.float(),
                                      None, reverse)
    elif lstm and grad:
        ys, _ = LSTMFunction.apply(xp_t, mask_t, torch.stack(whs),
                                   bh.float(), None, None, reverse)
    elif lstm:
        ys = lstm_ops.lstm_fwd(
            xp_t, mask_t, torch.stack(whs).to(xp_t.dtype).contiguous(),
            bh.float(), reverse)
    else:
        ys = GRUFunction.apply(xp_t, mask_t, torch.stack(whs), bh.float(),
                               None, reverse)
    return layer_output(cfg, ys.sum(0), mask)


def chunk_recurrence(cfg: ModelConfig, xp_t: torch.Tensor,
                     mask_t: torch.Tensor, w_h: torch.Tensor,
                     b_h: torch.Tensor, reverse: bool, carry=None,
                     grad: bool = False):
    """One direction of a layer over a chunk of frames, from a carried
    state: the sequence-parallel relay's call.

    ``xp_t [T,B,GH]`` in the model dtype (the input projection of this
    chunk's frames, time-major), ``mask_t [T,B]`` f32, ``w_h [H,GH]``,
    ``b_h [GH]``, ``reverse`` for the backward direction, which runs
    t = T-1..0 and takes its carry at t = T-1. ``carry``: None (zeros),
    ``h [B,H]`` f32 for a GRU, ``(h, c)`` for an LSTM. Returns ``(ys
    [T,B,H] f32, the carry after the chunk's last step)``. One D=1 call
    of ``gru_fwd`` or ``lstm_fwd``, which launch their kernels on a CUDA
    tensor; with no carry in, the kernel starts from zeros (a NULL
    ``h0``).

    ``grad`` (the sequence-parallel train step) makes the call through
    ``GRUFunction`` with the carry as its ``h0``, or ``LSTMFunction``
    with it as ``(h0, c0)``, so the backward hands ``dh0`` (and ``dc0``)
    to the shard before; the carried h out is ``ys`` at the scan's last
    row (a masked frame holds h), so the gradient on it reaches the
    backward through ``ys``, and the LSTM's c out is ``LSTMFunction``'s
    second output, whose gradient enters the backward as ``dcfin``."""
    last = 0 if reverse else -1
    if grad and cfg.rnn_type == "gru":
        ys = GRUFunction.apply(
            xp_t, mask_t, w_h[None], b_h.float()[None],
            None if carry is None else carry[None], (reverse,))[0]
        return ys, ys[last]
    if grad:
        h0, c0 = (None, None) if carry is None else (x[None] for x in carry)
        ys, c = LSTMFunction.apply(xp_t, mask_t, w_h[None], b_h.float()[None],
                                   h0, c0, (reverse,))
        return ys[0], (ys[0][last], c[0])
    w = w_h.to(xp_t.dtype)[None].contiguous()
    b = b_h.float()[None].contiguous()
    if cfg.rnn_type == "gru":
        ys, hfin = gru_ops.gru_fwd(
            xp_t, mask_t, w, b,
            None if carry is None else carry[None].contiguous(), (reverse,))
        return ys[0], hfin[0]
    hc0 = None if carry is None else tuple(x[None].contiguous()
                                           for x in carry)
    ys, (h, c) = lstm_ops.lstm_fwd(xp_t, mask_t, w, b, (reverse,), hc0=hc0,
                                   return_final=True)
    return ys[0], (h[0], c[0])


class RNNLayer(nn.Module):
    """One (bi)directional GRU or LSTM layer with optional sequence BN.

    Parameters keep the JAX names and layouts: ``bn``, ``wx`` (Dense,
    kernel [in, GH]), ``wh_fw``/``wh_bw`` [H, GH], ``bh_fw``/``bh_bw``
    [GH], with G = 3 gates (GRU) or 4 (LSTM). ``quantized`` holds
    ``wx.kernel`` and ``wh_*`` as ``QWeight``s.
    """

    def __init__(self, cfg: ModelConfig, features_in: int,
                 quantized: bool = False):
        super().__init__()
        if cfg.rnn_type not in _N_GATES:
            raise ValueError(f"rnn_type={cfg.rnn_type!r}: 'gru' or 'lstm'")
        _check_impl(cfg.rnn_impl)
        self.cfg = cfg
        h = cfg.rnn_hidden
        gh = _N_GATES[cfg.rnn_type] * h
        if cfg.rnn_batch_norm:
            self.bn = MaskedBatchNorm(features_in)
        self.quantized = quantized
        self.wx = Dense(features_in, gh, quantized)
        self.dirs = ["fw", "bw"] if cfg.bidirectional else ["fw"]
        for s in self.dirs:
            setattr(self, f"wh_{s}", QWeight((h, gh)) if quantized
                    else nn.Parameter(torch.zeros(h, gh)))
            self.register_parameter(f"bh_{s}", nn.Parameter(torch.zeros(gh)))

    def _may_need_grad(self, x: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in self.parameters()))

    def forward(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mask = length_mask(lens, x.shape[1])
        grad = self._may_need_grad(x)
        if self.quantized and grad:
            raise RuntimeError(
                "a quantized model is for inference only (the int8 GRU and "
                "LSTM kernels have no backward, as gru_scan_pallas_q and "
                "lstm_scan_pallas_q have no VJP): run it under "
                "torch.no_grad() or torch.inference_mode()")
        if cfg.rnn_batch_norm:
            x = self.bn(x, mask)
        whs = [getattr(self, f"wh_{s}") for s in self.dirs]
        bh = torch.stack([getattr(self, f"bh_{s}") for s in self.dirs])
        return layer_body(cfg, x, mask, weight(self.wx.kernel), self.wx.bias,
                          whs, bh, grad)


class RNNStack(nn.Module):
    def __init__(self, cfg: ModelConfig, features_in: int,
                 quantized: bool = False):
        super().__init__()
        for i in range(cfg.rnn_layers):
            self.add_module(f"rnn{i}", RNNLayer(
                cfg, features_in if i == 0 else cfg.rnn_hidden, quantized))
        self.n_layers = cfg.rnn_layers

    def forward(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"rnn{i}")(x, lens)
        return x
