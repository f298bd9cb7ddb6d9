"""Weights between the JAX package's flax trees and the port's modules.

The interchange format is the flax layout as nested dicts of numpy
arrays: ``params`` (conv kernels HWIO ``[kt, kf, in, out]``, Dense
kernels ``[in, out]``, ``wh_*`` ``[H, 3H]`` (GRU) or ``[H, 4H]``
(LSTM), BN ``scale``/``bias``,
lookahead ``w [ctx, C]``) and ``batch_stats`` (BN ``mean``/``var``).
The port's module tree uses the same names, so the mapping is by name;
the one change of layout is the conv kernel (HWIO <-> OIHW), and the
round trip is exact.

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
from .models.ds2 import DeepSpeech2

Tree = Dict[str, object]

# A conv kernel, or the q / scale of a quantized one.
_CONV_KERNEL = re.compile(r"^(conv\.conv\d+\.)kernel(\.q|\.scale)?$")
_CONV_WEIGHT = re.compile(r"^(conv\.conv\d+\.)weight(\.q|\.scale)?$")
_BN_STATS = ("mean", "var")


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


def from_flax(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (plain or quantized) + ``batch_stats`` -> the
    port's ``state_dict``."""
    sd = {}
    for key, v in _flatten(params).items():
        m = _CONV_KERNEL.match(key)
        if m:
            key = f"{m.group(1)}weight{m.group(2) or ''}"
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
        sd[key] = torch.tensor(v)
    for key, v in _flatten(batch_stats).items():
        sd[key] = torch.tensor(v)
    return sd


def to_flax(state_dict: Dict[str, torch.Tensor]) -> Tuple[Tree, Tree]:
    """The port's ``state_dict`` -> flax ``(params, batch_stats)``."""
    params, stats = {}, {}
    for key, t in state_dict.items():
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
    lookahead weights, and fresh BN statistics (mean 0, var 1)."""
    model = DeepSpeech2(cfg.model, cfg.features.num_features)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("weight", "kernel"):
                fan_in = (p[0].numel() if leaf == "weight" else p.shape[0])
                # flax variance_scaling(1, fan_in, truncated_normal).
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                torch.nn.init.trunc_normal_(p, std=std, a=-2 * std,
                                            b=2 * std, generator=generator)
            elif leaf.startswith("wh_"):
                torch.nn.init.orthogonal_(p, generator=generator)
            elif leaf == "w":
                torch.nn.init.normal_(p, std=0.02, generator=generator)
            elif leaf == "scale":
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
