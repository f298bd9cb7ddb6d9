"""Weights between the JAX package's flax trees and the port's modules.

The interchange format is the flax layout as nested dicts of numpy
arrays: ``params`` (conv kernels HWIO ``[kt, kf, in, out]``, Dense
kernels ``[in, out]``, ``wh_*`` ``[H, 3H]`` (GRU) or ``[H, 4H]``
(LSTM), BN ``scale``/``bias``,
lookahead ``w [ctx, C]``) and ``batch_stats`` (BN ``mean``/``var``).
The port's module tree uses the same names, so the mapping is by name;
the one change of layout is the conv kernel (HWIO <-> OIHW), and the
round trip is exact. A pipelined tree (``model.pipeline_stages > 1``)
maps the same way: ``rnn0`` and the stacked ``rnn_pipe/{wx_kernel, ...}``
leaves ``[L-1, ...]`` with their ``rnn_pipe/{mean, var}`` statistics.

Under a model axis whose head is sharded (``models/ds2.py``: each rank
of a model group holds ``V / model`` columns of ``head/kernel`` and
``head/bias``), ``from_flax`` and ``to_flax`` still take and give the
**full** flax leaves: given the model's ``head_group`` they slice this
rank's columns on the way in and all-gather them on the way out (a
collective: every rank of the group calls it), so checkpoints keep
their layout. On a mesh with a pipe axis a rank holds its stage's
``L' = (L-1)/P`` layers of every stacked ``rnn_pipe`` leaf, parameters
and BN statistics alike; given the model's ``pipe_group`` the two slice
dim 0 on the way in and all-gather it on the way out, the same way.

A quantized tree (``utils/quantize.py``'s ``quantize_params``) maps the
same way: each ``{"q", "scale"}`` leaf becomes an int8 ``<leaf>.q`` and
an f32 ``<leaf>.scale`` entry, which a model built with
``quantized=True`` holds; a conv kernel's ``q`` turns to OIHW like its
f32 kernel and keeps its scale per output channel.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import numpy as np
import torch

from .config import Config
from .models.ds2 import HEAD_KEYS, DeepSpeech2
from .parallel.comm import all_gather_dim

Tree = Dict[str, object]

# A conv kernel, or the q / scale of a quantized one.
_CONV_KERNEL = re.compile(r"^(conv\.conv\d+\.)kernel(\.q|\.scale)?$")
_CONV_WEIGHT = re.compile(r"^(conv\.conv\d+\.)weight(\.q|\.scale)?$")
_BN_STATS = ("mean", "var")
# The stacked leaves of a pipelined tree, split over a pipe axis.
STACKED_PREFIX = "rnn_pipe."


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if hasattr(v, "items"):  # dict or flax FrozenDict
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _nest(flat: Dict[str, np.ndarray]) -> Tree:
    tree: Tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def flax_path(key: str, shape: Tuple[int, ...]
              ) -> Tuple[str, Tuple[int, ...], int]:
    """A ``state_dict`` key and its shape -> ``(flax path "a/b/c", flax
    shape, the torch dim that is the flax leaf's dim 0)``: conv kernels
    are OIHW here and HWIO there, every other leaf keeps its layout."""
    m = _CONV_WEIGHT.match(key)
    if m and len(shape) == 4:
        o, i, h, w = shape
        return (f"{m.group(1)}kernel{m.group(2) or ''}".replace(".", "/"),
                (h, w, i, o), 2)
    return key.replace(".", "/"), tuple(shape), 0


def _rank_slice(v: np.ndarray, group, dim: int) -> np.ndarray:
    """This rank's equal part of ``v`` along ``dim`` over ``group``."""
    rank = torch.distributed.get_rank(group)
    n = v.shape[dim] // torch.distributed.get_world_size(group)
    return np.take(v, range(rank * n, (rank + 1) * n), axis=dim)


def _split_dim(key: str, head_group, pipe_group):
    """``(group, dim)`` a ``state_dict`` key is split along, or None."""
    if head_group is not None and key in HEAD_KEYS:
        return head_group, -1
    if pipe_group is not None and key.startswith(STACKED_PREFIX):
        return pipe_group, 0
    return None


def from_flax(params: Tree, batch_stats: Tree, head_group=None,
              pipe_group=None) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (plain or quantized) + ``batch_stats`` -> the
    port's ``state_dict``; with ``head_group`` (a sharded head's model
    group) this rank's columns of the head, with ``pipe_group`` (a
    pipelined tree's) this rank's stage of the stacked leaves."""
    sd = {}
    for key, v in _flatten(params).items():
        m = _CONV_KERNEL.match(key)
        if m:
            key = f"{m.group(1)}weight{m.group(2) or ''}"
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
        sd[key] = v
    sd.update(_flatten(batch_stats))
    for key, v in sd.items():
        split = _split_dim(key, head_group, pipe_group)
        if split is not None:
            v = _rank_slice(v, split[0], split[1] % v.ndim)
        sd[key] = torch.tensor(v)
    return sd


def to_flax(state_dict: Dict[str, torch.Tensor], head_group=None,
            pipe_group=None) -> Tuple[Tree, Tree]:
    """The port's ``state_dict`` -> flax ``(params, batch_stats)``; with
    ``head_group`` the head's columns are all-gathered over it first,
    with ``pipe_group`` the stacked leaves' stages (a collective: every
    rank of the group calls it)."""
    params, stats = {}, {}
    for key, t in state_dict.items():
        split = _split_dim(key, head_group, pipe_group)
        if split is not None:
            t = all_gather_dim(t.detach(), split[1] % t.dim(), split[0])
        v = t.detach().cpu().numpy()
        m = _CONV_WEIGHT.match(key)
        if m:
            key = f"{m.group(1)}kernel{m.group(2) or ''}"
            if v.ndim == 4:
                v = v.transpose(2, 3, 1, 0)
        dest = stats if key.rsplit(".", 1)[-1] in _BN_STATS else params
        dest[key] = np.ascontiguousarray(v)
    return _nest(params), _nest(stats)


def init_params(cfg: Config, generator: torch.Generator
                ) -> Tuple[Tree, Tree]:
    """A seeded random init of the whole model in the flax layout, with
    flax's initializers: lecun-normal (truncated) conv and Dense
    kernels, orthogonal ``wh_*``, zero biases, unit BN scales, normal(0.02)
    lookahead weights, and fresh BN statistics (mean 0, var 1). A
    pipelined tree's stacked ``wh_*`` are orthogonal layer by layer (JAX
    ``pipe_stack.py:58-63``), and its stacked ``wx_kernel [L-1, H, G]``
    takes flax's lecun-normal on the whole leaf, whose fan-in counts the
    layer axis too (L-1 times H)."""
    model = DeepSpeech2(cfg.model, cfg.features.num_features)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("weight", "kernel", "wx_kernel"):
                fan_in = (p[0].numel() if leaf == "weight"
                          else p[..., 0].numel())
                # flax variance_scaling(1, fan_in, truncated_normal).
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                torch.nn.init.trunc_normal_(p, std=std, a=-2 * std,
                                            b=2 * std, generator=generator)
            elif leaf.startswith("wh_"):
                for layer in (p if p.dim() == 3 else p[None]):
                    torch.nn.init.orthogonal_(layer, generator=generator)
            elif leaf == "w":
                torch.nn.init.normal_(p, std=0.02, generator=generator)
            elif leaf in ("scale", "bn_scale"):
                p.fill_(1.0)
            else:
                p.zero_()
    return to_flax(model.state_dict())


def save_npz(path: str, params: Tree, batch_stats: Tree) -> None:
    """Write both trees to one ``.npz`` (keys ``params/a/b``, ...)."""
    flat = {f"params/{k.replace('.', '/')}": v
            for k, v in _flatten(params).items()}
    flat.update({f"batch_stats/{k.replace('.', '/')}": v
                 for k, v in _flatten(batch_stats).items()})
    np.savez(path, **flat)


def load_npz(path: str) -> Tuple[Tree, Tree]:
    """Read what ``save_npz`` wrote -> ``(params, batch_stats)``."""
    trees: Dict[str, Dict[str, np.ndarray]] = {"params": {},
                                              "batch_stats": {}}
    with np.load(path) as z:
        for key in z.files:
            root, rest = key.split("/", 1)
            trees[root][rest.replace("/", ".")] = z[key]
    return _nest(trees["params"]), _nest(trees["batch_stats"])
