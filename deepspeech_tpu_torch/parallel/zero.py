"""ZeRO-1 and the sharded head's optimizer state: which rows of which
parameter a rank steps, and the dense ``state_dict`` a checkpoint holds.

The port's counterpart of the JAX package's ``zero_opt_sharding``
(``train.py:147-166``, ``config.py:174``): parameters stay replicated;
for each leaf that ``param_shardings(zero_data_shard=True)`` shards
along (flax) dim 0 over ``data``, a rank keeps the optimizer's state
(SGD's momentum, AdamW's two moments) only for its rows. After the
gradient all-reduce the rank steps those rows, then all-gathers the
updated parameter. Both optimizers are elementwise, so the result is
the dense run's. Gloo has no reduce-scatter: the path is built on
all-reduce and all-gather, so the CPU tests and the card run the same
code.

A ``Layout`` maps a parameter's index in ``model.parameters()`` to the
split of its optimizer state: ZeRO rows over the data group, the
sharded head's columns over the model group, or a pipelined tree's
stage of a stacked leaf over the pipe group (the head's and the stage's
own parameters are already this rank's part). ``dense_state_dict``
gathers every split into the ``state_dict`` a dense run writes,
``local_state_dict`` cuts one back, so a ZeRO or pipe checkpoint
restores into a dense run and the other way round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from ..bridge import STACKED_PREFIX, flax_path
from ..models.ds2 import HEAD_KEYS
from .comm import all_gather_dim
from .mesh import DATA_AXIS, Mesh, leaf_spec


@dataclass(frozen=True)
class Split:
    """One parameter's optimizer state split along ``dim`` over
    ``group``: this rank holds rows ``[lo, lo + n)``. ``zero``: a ZeRO
    split of a replicated parameter (else the sharded head's or a
    pipelined tree's stage)."""

    dim: int
    group: Any
    lo: int
    n: int
    zero: bool


Layout = Dict[int, Split]


def _split(size: int, group, dim: int, zero: bool) -> Split:
    parts = dist.get_world_size(group)
    n = size // parts
    return Split(dim, group, dist.get_rank(group) * n, n, zero)


def zero_leaves(model: torch.nn.Module, mesh: Mesh) -> Dict[str, int]:
    """``{parameter name: torch dim}`` of the leaves ZeRO shards over
    ``data`` under ``mesh``: JAX's ``param_shardings(zero_data_shard=
    True)`` decision on each leaf's flax path and shape (the dim is the
    flax leaf's dim 0: a conv kernel's time dim, 2 in OIHW). The
    stacked leaves are never among them: their rule names ``pipe``."""
    out = {}
    for name, p in model.named_parameters():
        if name.startswith(STACKED_PREFIX):
            continue
        path, shape, dim = flax_path(name, tuple(p.shape))
        if leaf_spec(mesh, path, shape, zero_data_shard=True)[:1] == (
                DATA_AXIS,):
            out[name] = dim
    return out


def layout(model: torch.nn.Module, mesh: Mesh, zero: bool) -> Layout:
    """The optimizer-state splits of ``model`` (built with ``mesh``)."""
    out: Layout = {}
    zero_dims = (zero_leaves(model, mesh)
                 if zero and mesh.data_group is not None else {})
    for i, (name, p) in enumerate(model.named_parameters()):
        if model.head_group is not None and name in HEAD_KEYS:
            g = model.head_group
            out[i] = _split(p.shape[-1] * dist.get_world_size(g), g,
                            p.dim() - 1, False)
        elif model.pipe_group is not None and name.startswith(
                STACKED_PREFIX):
            g = model.pipe_group
            out[i] = _split(p.shape[0] * dist.get_world_size(g), g, 0,
                            False)
        elif name in zero_dims:
            out[i] = _split(p.shape[zero_dims[name]], mesh.data_group,
                            zero_dims[name], True)
    return out


def zero_params(params: List[torch.nn.Parameter], lay: Layout
                ) -> List[torch.Tensor]:
    """The tensors the optimizer steps, in parameter order: a ZeRO leaf's
    rows as a tensor of their own, every other parameter itself."""
    out = []
    for i, p in enumerate(params):
        s = lay.get(i)
        if s is not None and s.zero:
            out.append(p.detach().narrow(s.dim, s.lo, s.n).clone()
                       .requires_grad_(True))
        else:
            out.append(p)
    return out


@torch.no_grad()
def dense_state_dict(sd: Dict, lay: Layout) -> Dict:
    """A rank's optimizer ``state_dict`` -> the dense run's: every split
    state tensor all-gathered along its dim (a collective over each
    split's group; every rank calls it)."""
    state = {}
    for i, st in sd["state"].items():
        s = lay.get(i)
        if s is None:
            state[i] = st
            continue
        state[i] = {k: (all_gather_dim(v, s.dim, s.group)
                        if torch.is_tensor(v) and v.dim() else v)
                    for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def local_state_dict(sd: Dict, lay: Layout) -> Dict:
    """A dense optimizer ``state_dict`` -> this rank's rows of it."""
    state = {}
    for i, st in sd["state"].items():
        s = lay.get(int(i))
        if s is None:
            state[i] = st
            continue
        state[i] = {k: (v.narrow(s.dim, s.lo, s.n).clone()
                        if torch.is_tensor(v) and v.dim() else v)
                    for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}
