"""Lookahead (row) convolution for the streaming variant:
``y[t] = sum_{tau < context} w[tau] * x[t + tau]`` per channel, a
depthwise conv over time right-padded by ``context - 1`` frames."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LookaheadConv(nn.Module):
    """``w [context, C]``, the JAX package's layout."""

    def __init__(self, context: int, channels: int):
        super().__init__()
        self.context = context
        self.w = nn.Parameter(torch.zeros(context, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        # conv1d is a cross-correlation, like lax.conv_general_dilated:
        # weight[c, 0, tau] = w[tau, c].
        weight = self.w.t()[:, None, :].to(x.dtype)
        y = F.conv1d(F.pad(x.transpose(1, 2), (0, self.context - 1)),
                     weight, groups=c)
        return y.transpose(1, 2)
