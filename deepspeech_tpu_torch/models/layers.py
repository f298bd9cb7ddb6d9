"""Shared model layers: masked batch-norm, the DS2 clipped ReLU, a
Dense layer that computes in the model dtype, and the weight-only int8
leaf ``QWeight`` of a quantized model.

Batch-norm statistics are taken over valid frames only (mask-weighted)
with the JAX package's running-stat convention: biased variance and
``running = 0.99 * running + 0.01 * batch``. ``nn.BatchNorm1d`` keeps
the unbiased variance with the opposite momentum convention, so it is
not used.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def clipped_relu(x: torch.Tensor, clip: float = 20.0) -> torch.Tensor:
    """DS2's hard-clipped ReLU: min(max(x, 0), clip)."""
    return torch.clamp(x, 0.0, clip)


def length_mask(lens: torch.Tensor, t_max: int) -> torch.Tensor:
    """[B] lengths -> [B, T] float32 mask (1 = valid)."""
    return (torch.arange(t_max, device=lens.device)[None, :]
            < lens[:, None]).float()


def masked_bn_stats(x32: torch.Tensor, mask: Optional[torch.Tensor]):
    """Mask-weighted (mean, biased var) over all axes but the last.

    ``x32`` is float32 ``[B, T, ..., C]``; ``mask`` is [B, T] or None
    for all-valid.
    """
    if mask is None:
        w = torch.ones(x32.shape[:-1], dtype=torch.float32,
                       device=x32.device)
    else:
        w = mask.reshape(mask.shape + (1,) * (x32.dim() - 3)).expand(
            x32.shape[:-1])
    dims = tuple(range(x32.dim() - 1))
    denom = torch.clamp(w.sum(), min=1.0)
    wexp = w[..., None]
    mean = (x32 * wexp).sum(dims) / denom
    var = (wexp * (x32 - mean) ** 2).sum(dims) / denom
    return mean, var


class MaskedBatchNorm(nn.Module):
    """Sequence-wise batch norm over valid frames of ``[B, T, ..., C]``.

    ``scale``/``bias`` are parameters, ``mean``/``var`` running buffers.
    In training mode the batch statistics normalize and update the
    running ones; in eval mode the running ones normalize. Computes in
    f32 and returns the input dtype.
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

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            mean, var = masked_bn_stats(x32, mask)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale + self.bias
        return y.to(x.dtype)


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
        return (x.to(dtype) @ weight(self.kernel).to(dtype)
                + self.bias.to(dtype))
