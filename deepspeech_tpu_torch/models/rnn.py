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
them.

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
from .layers import Dense, MaskedBatchNorm, QWeight, length_mask

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
        dtype = getattr(torch, cfg.dtype)
        mask = length_mask(lens, x.shape[1])
        lstm = cfg.rnn_type == "lstm"
        grad = self._may_need_grad(x)
        if self.quantized and grad:
            raise RuntimeError(
                "a quantized model is for inference only (the int8 GRU and "
                "LSTM kernels have no backward, as gru_scan_pallas_q and "
                "lstm_scan_pallas_q have no VJP): run it under "
                "torch.no_grad() or torch.inference_mode()")
        if cfg.rnn_batch_norm:
            x = self.bn(x, mask)
        xp_t = self.wx(x.transpose(0, 1), dtype).contiguous()  # [T, B, GH]
        mask_t = mask.t().contiguous()
        reverse = [s == "bw" for s in self.dirs]
        whs = [getattr(self, f"wh_{s}") for s in self.dirs]
        bh = torch.stack([getattr(self, f"bh_{s}") for s in self.dirs])
        if self.quantized and lstm:
            ys = lstm_ops.lstm_fwd_q(
                xp_t, mask_t, torch.stack([w.q for w in whs]),
                torch.stack([w.scale for w in whs]), bh.float(), reverse)
        elif lstm and grad:
            ys = LSTMFunction.apply(xp_t, mask_t, torch.stack(whs),
                                    bh.float(), None, reverse)
        elif lstm:
            ys = lstm_ops.lstm_fwd(
                xp_t, mask_t, torch.stack(whs).to(xp_t.dtype).contiguous(),
                bh.float(), reverse)
        elif self.quantized:
            ys, _ = gru_ops.gru_fwd_q(
                xp_t, mask_t,
                torch.stack([w.q for w in whs]),
                torch.stack([w.scale for w in whs]), bh.float(), None,
                reverse)
        else:
            ys = GRUFunction.apply(xp_t, mask_t, torch.stack(whs),
                                   bh.float(), None, reverse)
        out = ys.sum(0).transpose(0, 1)  # [B, T, H]
        out = out * mask[:, :, None]
        return out.to(dtype)


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
