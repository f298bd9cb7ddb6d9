"""DS2 model assembly.

features [B, T, F] -> conv frontend -> GRU or LSTM stack -> (lookahead conv +
clipped ReLU) -> masked BN -> dense head -> logits [B, T', V] float32.
Submodule and parameter names follow the JAX package's (``conv``,
``rnn``, ``lookahead``, ``bn_out``, ``head``), which is what lets
``bridge.py`` map one tree onto the other by name. With
``model.pipeline_stages > 1`` the RNN stack is JAX ``ds2.py:38-44``'s
pipelined layout: layer 0 as ``rnn0`` and layers 1..L-1 stacked in
``rnn_pipe`` (``pipe_stack.py``): on one device its sequential path, on
a mesh with a pipe axis this rank's stage of them, run by the GPipe
schedule.

Under a ``(data, model)`` or ``(data, pipe, model)`` mesh
(``parallel/mesh.py``) the model is one rank's share of the JAX model
under GSPMD: every masked BN, the stacked layers' too, takes its
statistics over the data group (``layers.MaskedBatchNorm.group``), and
where the vocabulary divides by the model axis the head holds this
rank's ``V / model`` columns of ``head/kernel`` and ``head/bias``,
computes its slice of the logits and all-gathers them along V before
the log-softmax and the loss (JAX ``parallel/mesh.py:88-91``); otherwise
the head is replicated, with JAX's warning. The int8 head (``QWeight``)
is not sharded.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..parallel.comm import copy_to_group, gather_last
from ..parallel.mesh import head_sharded
from .conv import ConvFrontend, conv_out_features
from .layers import Dense, MaskedBatchNorm, clipped_relu, length_mask
from .lookahead import LookaheadConv
from .pipe_stack import PipelinedRNNStack
from .rnn import RNNLayer, RNNStack

# The head's leaves in the state_dict, split over a model axis.
HEAD_KEYS = ("head.kernel", "head.bias")


class DeepSpeech2(nn.Module):
    """``quantized`` builds the weight-only int8 model that a quantized
    tree (``utils/quantize.py``, through ``bridge.from_flax``) loads
    into: conv, ``wx`` and head kernels and the recurrent matrices held
    int8 with their scales; inference only. ``mesh`` (a
    ``parallel.Mesh``) lays the model over a data-parallel group, a pipe
    axis and a model axis (module docstring); None is one device. A
    pipelined tree (``pipeline_stages > 1``) is full precision only, as
    JAX quantizes it as fp (``utils/quantize.py:165``): an int8 engine
    dequantizes it first (``utils/quantize.keep_recurrent_q``)."""

    def __init__(self, cfg: ModelConfig, num_features: int = 161,
                 quantized: bool = False, mesh=None):
        super().__init__()
        if cfg.pipeline_stages > 1 and quantized:
            raise NotImplementedError(
                "a pipelined tree (pipeline_stages > 1) is full precision "
                "only, as the JAX package quantizes it as fp: an int8 "
                "engine dequantizes it first")
        self.cfg = cfg
        # The model group that splits the head's columns, or None.
        self.head_group = None
        # The pipe group that splits the stacked layers, or None.
        self.pipe_group = None
        vocab = cfg.vocab_size
        if head_sharded(mesh, vocab):
            if quantized:
                raise NotImplementedError(
                    "the int8 head (QWeight) is not sharded over the model "
                    "axis: its per-column scales would split with it, and "
                    "the int8 tier serves on one card")
            self.head_group = mesh.model_group
            vocab //= mesh.model
        self.conv = ConvFrontend(cfg, quantized)
        if cfg.pipeline_stages > 1:
            self.rnn0 = RNNLayer(cfg, conv_out_features(cfg, num_features))
            self.rnn_pipe = PipelinedRNNStack(cfg, mesh)
            self.pipe_group = self.rnn_pipe.pipe_group
        else:
            self.rnn = RNNStack(cfg, conv_out_features(cfg, num_features),
                                quantized)
        if cfg.lookahead_context > 0:
            self.lookahead = LookaheadConv(cfg.lookahead_context,
                                           cfg.rnn_hidden)
        self.bn_out = MaskedBatchNorm(cfg.rnn_hidden)
        self.head = Dense(cfg.rnn_hidden, vocab, quantized)
        if mesh is not None:
            for m in self.modules():
                if isinstance(m, (MaskedBatchNorm, PipelinedRNNStack)):
                    m.group = mesh.data_group

    def forward(self, features: torch.Tensor, feat_lens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x, lens = self.conv(features, feat_lens)
        if cfg.pipeline_stages > 1:
            x = self.rnn_pipe(self.rnn0(x, lens), lens)
        else:
            x = self.rnn(x, lens)
        if cfg.lookahead_context > 0:
            x = clipped_relu(self.lookahead(x), cfg.relu_clip)
        mask = length_mask(lens, x.shape[1])
        x = self.bn_out(x, mask)
        # Both are the identity when the head is not sharded.
        x = copy_to_group(x, self.head_group)
        logits = self.head(x, getattr(torch, cfg.dtype)).float()
        return gather_last(logits, self.head_group), lens
