"""DS2 model assembly.

features [B, T, F] -> conv frontend -> GRU or LSTM stack -> (lookahead conv +
clipped ReLU) -> masked BN -> dense head -> logits [B, T', V] float32.
Submodule and parameter names follow the JAX package's (``conv``,
``rnn``, ``lookahead``, ``bn_out``, ``head``), which is what lets
``bridge.py`` map one tree onto the other by name.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config import ModelConfig
from .conv import ConvFrontend, conv_out_features
from .layers import Dense, MaskedBatchNorm, clipped_relu, length_mask
from .lookahead import LookaheadConv
from .rnn import RNNStack


class DeepSpeech2(nn.Module):
    """``quantized`` builds the weight-only int8 model that a quantized
    tree (``utils/quantize.py``, through ``bridge.from_flax``) loads
    into: conv, ``wx`` and head kernels and the recurrent matrices held
    int8 with their scales; inference only."""

    def __init__(self, cfg: ModelConfig, num_features: int = 161,
                 quantized: bool = False):
        super().__init__()
        if cfg.pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline_stages > 1: the pipelined RNN stack comes with "
                "slice 9 of the port")
        self.cfg = cfg
        self.conv = ConvFrontend(cfg, quantized)
        self.rnn = RNNStack(cfg, conv_out_features(cfg, num_features),
                            quantized)
        if cfg.lookahead_context > 0:
            self.lookahead = LookaheadConv(cfg.lookahead_context,
                                           cfg.rnn_hidden)
        self.bn_out = MaskedBatchNorm(cfg.rnn_hidden)
        self.head = Dense(cfg.rnn_hidden, cfg.vocab_size, quantized)

    def forward(self, features: torch.Tensor, feat_lens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x, lens = self.conv(features, feat_lens)
        x = self.rnn(x, lens)
        if cfg.lookahead_context > 0:
            x = clipped_relu(self.lookahead(x), cfg.relu_clip)
        mask = length_mask(lens, x.shape[1])
        x = self.bn_out(x, mask)
        logits = self.head(x, getattr(torch, cfg.dtype))
        return logits.float(), lens
