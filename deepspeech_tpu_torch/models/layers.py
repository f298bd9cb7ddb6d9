"""Shared model layers: masked batch-norm, the DS2 clipped ReLU, a
Dense layer that computes in the model dtype, and the weight-only int8
leaf ``QWeight`` of a quantized model.

Batch-norm statistics are taken over valid frames only (mask-weighted)
with the JAX package's running-stat convention: biased variance and
``running = 0.99 * running + 0.01 * batch``. ``nn.BatchNorm1d`` keeps
the unbiased variance with the opposite momentum convention, so it is
not used.

Under data parallelism (``MaskedBatchNorm.group`` set to the data
group) the statistics are the global ones the JAX package's GSPMD step
takes over the whole sharded batch: ``Σw`` and ``Σw·x`` are all-reduced,
then the mean taken, then ``Σw·(x−mean)²`` all-reduced, the two-pass
form of one device, with the **global** count clamped to 1. The
all-reduces are autograd-aware (``parallel/comm.py``), so the backward
carries the other ranks' share of the gradient through the statistics,
and the running buffers stay the same on every rank. ``nn.SyncBatchNorm``
is neither masked nor two-pass.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.comm import all_reduce_sum

BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def clipped_relu(x: torch.Tensor, clip: float = 20.0) -> torch.Tensor:
    """DS2's hard-clipped ReLU: min(max(x, 0), clip)."""
    return torch.clamp(x, 0.0, clip)


def length_mask(lens: torch.Tensor, t_max: int) -> torch.Tensor:
    """[B] lengths -> [B, T] float32 mask (1 = valid)."""
    return (torch.arange(t_max, device=lens.device)[None, :]
            < lens[:, None]).float()


def _over_shards(parts, device: torch.device) -> torch.Tensor:
    """The shards' partial sums added on ``device`` in shard order (the
    one shard's as it is)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def masked_bn_stats(x32, mask, group=None):
    """Mask-weighted (mean, biased var) over all axes but the last.

    ``x32`` is float32 ``[B, T, ..., C]``; ``mask`` is [B, T] or None
    for all-valid. ``group`` (a data-parallel process group) takes the
    statistics over every rank's rows (module docstring); None computes
    on this rank's rows alone, with no collective. ``x32`` and ``mask``
    may also be lists, one entry a time shard of the same rows, each on
    its device (the sequence-parallel train step, ``parallel/seqpar.py``):
    each shard's partial sums are added on the first shard's device in
    shard order, the mean copied back for the second pass, and the
    statistics returned there. Every copy is autograd's, so the gradient
    of each shard's input flows through the statistics.
    """
    xs, masks = ((x32, mask) if isinstance(x32, (list, tuple))
                 else ([x32], [mask]))
    home = xs[0].device
    ws = []
    for x, m in zip(xs, masks):
        if m is None:
            ws.append(torch.ones(x.shape[:-1], dtype=torch.float32,
                                 device=x.device))
        else:
            ws.append(m.reshape(m.shape + (1,) * (x.dim() - 3)).expand(
                x.shape[:-1]))
    dims = tuple(range(xs[0].dim() - 1))
    # Σw and Σw·x in one all-reduce (none without a group).
    sums = all_reduce_sum(_over_shards(
        [torch.cat([w.sum().reshape(1), (x * w[..., None]).sum(dims)])
         for x, w in zip(xs, ws)], home), group)
    denom = torch.clamp(sums[0], min=1.0)
    mean = sums[1:] / denom
    var = all_reduce_sum(_over_shards(
        [(w[..., None] * (x - mean.to(x.device)) ** 2).sum(dims)
         for x, w in zip(xs, ws)], home), group) / denom
    return mean, var


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor,
              eps: float = BN_EPS) -> torch.Tensor:
    """Batch norm's arithmetic with the statistics given, in f32; the
    input dtype out. ``MaskedBatchNorm`` and the pipelined stack's
    stacked slices (``pipe_stack.py``) both compute through it."""
    y = (x.float() - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class MaskedBatchNorm(nn.Module):
    """Sequence-wise batch norm over valid frames of ``[B, T, ..., C]``.

    ``scale``/``bias`` are parameters, ``mean``/``var`` running buffers.
    In training mode the batch statistics normalize and update the
    running ones; in eval mode the running ones normalize. Computes in
    f32 and returns the input dtype. ``group`` (None: this rank's rows)
    is the data-parallel group the statistics are taken over.
    """

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM,
                 eps: float = BN_EPS):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.group = None

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            mean, var = masked_bn_stats(x32, mask, self.group)
            self.update(mean, var)
        else:
            mean, var = self.mean, self.var
        return normalize(x32, mean, var, self.scale, self.bias,
                         self.eps).to(x.dtype)

    @torch.no_grad()
    def update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """The running statistics' momentum update with a batch's
        ``(mean, var)``: ``running = momentum * running + (1 - momentum)
        * batch``."""
        self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
        self.var.mul_(self.momentum).add_((1 - self.momentum) * var)

    def running(self, x: torch.Tensor) -> torch.Tensor:
        """The eval-mode forward in any mode: the running statistics
        (time-local, no collective, no update)."""
        return normalize(x, self.mean, self.var, self.scale, self.bias,
                         self.eps)


class QWeight(nn.Module):
    """A weight-only int8 leaf, held on the device as it is stored: ``q``
    int8 and ``scale`` f32, one per output channel on axis ``axis`` of
    ``q`` (``utils/quantize.py``'s layout; a conv kernel's OIHW ``q``
    keeps its scale on axis 0). ``dequantize()`` is ``q * scale`` in
    f32, the JAX package's dequantization at the forward's entry
    (infer.py:241-249)."""

    def __init__(self, shape, axis: int = -1):
        super().__init__()
        self.axis = axis % len(shape)
        self.register_buffer("q", torch.zeros(shape, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(shape[self.axis]))

    def dequantize(self) -> torch.Tensor:
        view = [1] * self.q.dim()
        view[self.axis] = -1
        return self.q.float() * self.scale.view(view)


def weight(w) -> torch.Tensor:
    """A weight as the forward uses it: a ``QWeight`` dequantized to f32,
    a parameter as it is."""
    return w.dequantize() if isinstance(w, QWeight) else w


class Dense(nn.Module):
    """``x @ kernel + bias`` with input, kernel and bias cast to the
    compute dtype, as flax ``nn.Dense(dtype=...)`` computes. The kernel
    keeps flax's ``[in, out]`` layout; ``quantized`` holds it as a
    ``QWeight``."""

    def __init__(self, features_in: int, features_out: int,
                 quantized: bool = False):
        super().__init__()
        self.kernel = (QWeight((features_in, features_out)) if quantized
                       else nn.Parameter(torch.zeros(features_in,
                                                     features_out)))
        self.bias = nn.Parameter(torch.zeros(features_out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(x, weight(self.kernel), self.bias, dtype)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """``Dense``'s arithmetic on a full-precision ``kernel [in, out]``
    and ``bias [out]``: all three cast to ``dtype``."""
    return x.to(dtype) @ kernel.to(dtype) + bias.to(dtype)
