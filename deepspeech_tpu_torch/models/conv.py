"""2D convolutional frontend over spectrograms.

features [B, T, F] -> [B, T', F'*C] plus new lengths, with the JAX
package's explicit padding: time ``pt = (kt - st) // 2`` on the left and
``kt - 1 - pt`` on the right (length-invariant, so a bucket's size never
moves the sampling grid); frequency the SAME total
``(ceil(F/sf) - 1) * sf + kf - F``, split ``pf_total // 2`` on the left.
Output length is ``ceil(T / st)`` per layer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from .layers import (MaskedBatchNorm, QWeight, clipped_relu, length_mask,
                     weight)


def conv_out_lens(feat_lens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    lens = feat_lens
    for (_, _, ts, _) in cfg.conv_layers:
        lens = -(-lens // ts)  # ceil div
    return lens


def conv_out_features(cfg: ModelConfig, num_features: int) -> int:
    """Width ``F' * C`` of the frontend's output rows."""
    f = num_features
    for (_, _, _, sf) in cfg.conv_layers:
        f = -(-f // sf)
    return f * cfg.conv_channels[-1]


class ConvFrontend(nn.Module):
    """Conv2d (OIHW weights ``conv{i}.weight``, no bias) -> masked BN
    ``bn{i}`` -> clipped ReLU -> zero invalid frames, per layer.
    ``quantized`` holds each ``conv{i}.weight`` as a ``QWeight``."""

    def __init__(self, cfg: ModelConfig, quantized: bool = False):
        super().__init__()
        self.cfg = cfg
        c_in = 1
        for i, ((kt, kf, st, sf), ch) in enumerate(
                zip(cfg.conv_layers, cfg.conv_channels)):
            if quantized:
                conv = nn.Module()
                conv.weight = QWeight((ch, c_in, kt, kf), axis=0)
            else:
                conv = nn.Conv2d(c_in, ch, (kt, kf), stride=(st, sf),
                                 bias=False)
            self.add_module(f"conv{i}", conv)
            self.add_module(f"bn{i}", MaskedBatchNorm(ch))
            c_in = ch

    def forward(self, x: torch.Tensor, feat_lens: torch.Tensor,
                valid_start: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``valid_start [B]`` (raw frames, default 0) marks the frames
        before each stream as invalid, as the mask past ``feat_lens``
        does: the streaming engine's windows carry history from before a
        stream's start (streaming.py). Offline callers do not pass it. It
        must divide by the total time stride, so each layer's start stays
        exact."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        x = x.to(dtype)[:, None]  # NCHW: [B, 1, T, F]
        lens = feat_lens
        start = valid_start
        for i, (kt, kf, st, sf) in enumerate(cfg.conv_layers):
            conv = getattr(self, f"conv{i}")
            pt = (kt - st) // 2
            fdim = x.shape[3]
            pf_total = (-(-fdim // sf) - 1) * sf + kf - fdim
            pf = pf_total // 2
            # F.pad takes the last dim (frequency) first.
            x = F.pad(x, (pf, pf_total - pf, pt, kt - 1 - pt))
            x = F.conv2d(x, weight(conv.weight).to(dtype),
                         stride=(st, sf))
            lens = -(-lens // st)
            mask = length_mask(lens, x.shape[2])
            if start is not None:
                start = start // st
                mask = mask * (torch.arange(x.shape[2], device=x.device)
                               [None, :] >= start[:, None]).float()
            # Masked BN is channel-last, as in the JAX package: [B,T,F,C].
            y = getattr(self, f"bn{i}")(x.permute(0, 2, 3, 1), mask)
            y = clipped_relu(y, cfg.relu_clip)
            y = y * mask[:, :, None, None].to(y.dtype)
            x = y.permute(0, 3, 1, 2)
        # Flatten [B, T', F', C] channel-fastest, the JAX reshape order
        # that the RNN's first input projection was trained against.
        b, t, f, c = y.shape
        return y.reshape(b, t, f * c), lens
