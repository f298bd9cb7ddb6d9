"""The pipeline-stacked RNN middle of a DS2 model, for serving.

The JAX package's ``models/pipe_stack.py`` stacks layers 1..L-1 of the
RNN stack (homogeneous ``[B,T,H] -> [B,T,H]`` blocks: masked BN, input
projection, (bi)directional recurrence) along a leading layer axis so
that a mesh's ``pipe`` axis can shard them for GPipe training. A model
trained that way is served on one device through the stacked tree's
sequential path (JAX ``pipe_stack.py:35-39``, ``:247-251``): the same
stacked parameters, layer by layer. ``PipelinedRNNStack`` holds that
tree under its JAX names,

  params ``rnn_pipe/{wx_kernel, wx_bias, wh_fw, bh_fw[, wh_bw, bh_bw]
  [, bn_scale, bn_bias]}``, each ``[L-1, ...]``;
  batch stats ``rnn_pipe/{mean, var}`` ``[L-1, H]`` (with
  ``rnn_batch_norm``),

and its forward is that sequential path: for each stacked layer, the
masked BN on running statistics (``layers.normalize``) and then
``rnn.layer_body`` (``wx``, the recurrence: K4/K6 at a resident width,
K8 beyond, K12/K14 for an LSTM; the mask) on the layer's slices, the
functions ``rnn.RNNLayer`` computes through, so that the tree and a
standard one holding the same weights unstacked give the same bits.

Training a pipelined tree (the GPipe schedule over ``torch.distributed``
point-to-point, item 14c of the port) is not here: a forward that may
need a gradient raises.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from .layers import length_mask, normalize
from .rnn import _N_GATES, _check_impl, layer_body

# The stacked leaves and their per-layer shapes, for H units and G gates.
STACKED_PARAMS = ("wx_kernel", "wx_bias", "wh_fw", "bh_fw", "wh_bw",
                  "bh_bw", "bn_scale", "bn_bias")


class PipelinedRNNStack(nn.Module):
    """Layers 1..rnn_layers-1 of the RNN stack, stacked (JAX
    ``PipelinedRNNStack``), run sequentially. Used by ``DeepSpeech2``
    when ``cfg.pipeline_stages > 1``; layer 0 (the conv-width input)
    stays an ``RNNLayer`` named ``rnn0`` beside it."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        n_layers = cfg.rnn_layers - 1
        if n_layers < 1 or n_layers % cfg.pipeline_stages:
            raise ValueError(
                f"pipeline_stages={cfg.pipeline_stages} must divide "
                f"rnn_layers-1={n_layers}")
        if cfg.rnn_type not in _N_GATES:
            raise ValueError(f"rnn_type={cfg.rnn_type!r}: 'gru' or 'lstm'")
        _check_impl(cfg.rnn_impl)
        self.cfg = cfg
        self.n_layers = n_layers
        h = cfg.rnn_hidden
        g = _N_GATES[cfg.rnn_type] * h
        self.dirs = ["fw", "bw"] if cfg.bidirectional else ["fw"]
        shapes = {"wx_kernel": (n_layers, h, g), "wx_bias": (n_layers, g)}
        for s in self.dirs:
            shapes[f"wh_{s}"] = (n_layers, h, g)
            shapes[f"bh_{s}"] = (n_layers, g)
        if cfg.rnn_batch_norm:
            shapes["bn_scale"] = (n_layers, h)
            shapes["bn_bias"] = (n_layers, h)
            self.register_buffer("mean", torch.zeros(n_layers, h))
            self.register_buffer("var", torch.ones(n_layers, h))
        for name in STACKED_PARAMS:
            if name in shapes:
                fill = torch.ones if name == "bn_scale" else torch.zeros
                self.register_parameter(name,
                                        nn.Parameter(fill(shapes[name])))

    def _may_need_grad(self, x: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in self.parameters()))

    def forward(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self._may_need_grad(x) or self.training:
            raise NotImplementedError(
                "a pipelined RNN stack (model.pipeline_stages > 1) serves "
                "through its sequential path under torch.no_grad() in eval "
                "mode; training it (the GPipe schedule) comes with item 14c "
                "of the port")
        mask = length_mask(lens, x.shape[1])
        for i in range(self.n_layers):
            if cfg.rnn_batch_norm:
                x = normalize(x, self.mean[i], self.var[i],
                              self.bn_scale[i], self.bn_bias[i])
            whs = [getattr(self, f"wh_{s}")[i] for s in self.dirs]
            bh = torch.stack([getattr(self, f"bh_{s}")[i]
                              for s in self.dirs])
            x = layer_body(cfg, x, mask, self.wx_kernel[i], self.wx_bias[i],
                           whs, bh, False)
        return x
