"""The (data, model) mesh over a process group, and its sharding rules.

The port's counterpart of the JAX package's ``parallel/mesh.py``. JAX
lays a ``Mesh`` over devices and lets XLA insert the collectives; here
the mesh is laid over the ranks of the ``torch.distributed`` group (one
card or one CPU process a rank) and the step calls the collectives of
``parallel/comm.py`` itself:

- ``data``: each rank of a data group (the ranks of one model index)
  takes its own contiguous block of the batch's rows; the gradients and
  the masked BN's statistics are all-reduced over it;
- ``model``: the ranks of a model group (one data index) share their
  rows and split the vocabulary head's columns (``head/kernel``,
  ``head/bias``), all-gathering the logits.

Rank ``r`` sits at ``(r // model, r % model)``, the process-major order
of the JAX mesh over ``jax.devices()``.

``shard_batchwise`` has no counterpart. JAX needs it because its Pallas
kernels are opaque to the SPMD partitioner and must be ``shard_map``-ed
over the data axis; here each rank runs the kernels on its own rows, so
every kernel is already batch-local.
"""

from __future__ import annotations

import functools
import logging
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import distributed as _dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"

logger = logging.getLogger(__name__)

# A partition spec: one mesh axis name (or None) a dim, as JAX's
# ``PartitionSpec``; () is replicated.
Spec = Tuple[Optional[str], ...]


@dataclass(eq=False)
class Mesh:
    """A ``(data, model)`` layout of the group's ranks.

    ``shape`` maps each axis to its size, as ``jax.sharding.Mesh.shape``
    does. ``data_group`` / ``model_group`` are the process groups of
    this rank's data and model axes, None without a process group (no
    collective runs). An axis of one rank still has its group: the
    step's collectives run over it, and a one-rank sum or gather is
    exact."""

    data: int
    model: int
    rank: int = 0
    data_group: Any = None
    model_group: Any = None
    shape: Dict[str, int] = field(init=False)

    def __post_init__(self):
        self.shape = {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, "
                f"rank={self.rank})")


def _group(ranks, world: int):
    """A process group over ``ranks`` (every rank must call this, in the
    same order); the world's own group when it spans the world."""
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def make_mesh(shape: Tuple[int, ...] = (0, 1)) -> Mesh:
    """Build the ``(data, model)`` mesh over the group's ranks (one rank
    without a group). ``shape[0] <= 0`` means 'all ranks / model'. Every
    rank of the group calls it, in the same order: it creates the data
    and model process groups."""
    world = _dist.process_count()
    if len(shape) == 3:
        raise NotImplementedError(
            f"mesh shape {tuple(shape)}: the pipe axis (pipeline stages) "
            "comes with item 14c of the port")
    if len(shape) != 2:
        raise ValueError(f"mesh shape {shape} must be (data, model) or "
                         f"(data, pipe, model)")
    dp, rest = int(shape[0]), (int(shape[1]),)
    restn = int(np.prod(rest))
    if dp <= 0:
        if world % restn:
            raise ValueError(f"{world} devices not divisible by {rest}")
        dp = world // restn
    n = dp * restn
    if n > world:
        raise ValueError(f"mesh {(dp,) + rest} needs {n} devices, "
                         f"have {world}")
    if n < world:
        raise ValueError(f"mesh {(dp,) + rest} covers {n} of the group's "
                         f"{world} ranks; every rank must be in the mesh")
    mp = rest[0]
    rank = _dist.process_index()
    data_group = model_group = None
    if _dist.is_initialized():
        # Every rank creates every group, in one order.
        for m in range(mp):
            g = _group(range(m, world, mp), world)
            if m == rank % mp:
                data_group = g
        for d in range(dp):
            g = _group(range(d * mp, (d + 1) * mp), world)
            if d == rank // mp:
                model_group = g
    return Mesh(dp, mp, rank, data_group, model_group)


# Parameter-name patterns -> spec for the tensor-parallel axis; every
# other leaf is replicated. Kernels are [in, out] (the flax layout):
# sharding the head's out dim splits the [T', H] x [H, V] product over
# the model axis, and the logits are gathered for the loss.
_PARAM_RULES = (
    (re.compile(r"head/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r"head/bias$"), (MODEL_AXIS,)),
    # The pipelined RNN middle (item 14c): stacked [n_layers, ...] leaves
    # shard dim 0 over the pipe axis, which a (data, model) mesh lacks.
    (re.compile(r"rnn_pipe/"), (PIPE_AXIS,)),
)


def param_spec(path: str) -> Spec:
    for pat, spec in _PARAM_RULES:
        if pat.search(path):
            return spec
    return ()


def leaf_spec(mesh: Mesh, path: str, shape: Tuple[int, ...],
              zero_data_shard: bool = False) -> Spec:
    """One leaf's spec under ``mesh``: JAX ``param_shardings``'s
    decision for the flax path ``path`` (``a/b/c``) of shape ``shape``.

    ``zero_data_shard`` is the ZeRO-1 layout of optimizer state: a leaf
    with no tensor-parallel rule shards along dim 0 over ``data`` when
    that dim divides (and is at least the data size). A dim that does
    not divide by its axis (the 29-way English head over model=2) falls
    back to replication with a warning, and a spec naming an axis the
    mesh lacks replicates."""
    spec = param_spec(path)
    shape = tuple(shape)
    if (zero_data_shard and spec == () and len(shape)
            and shape[0] % mesh.shape[DATA_AXIS] == 0
            and shape[0] >= mesh.shape[DATA_AXIS]):
        spec = (DATA_AXIS,)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in mesh.shape:
            return ()
        if dim >= len(shape) or shape[dim] % mesh.shape[axis] != 0:
            logger.warning(
                "tensor-parallel spec %s for %r dropped: dim %d of "
                "shape %s not divisible by mesh axis %r (size %d); "
                "replicating", spec, path, dim, shape, axis,
                mesh.shape[axis])
            return ()
    return spec


def param_shardings(mesh: Mesh, params, zero_data_shard: bool = False):
    """A tree of specs matching ``params`` (nested dicts of arrays, the
    flax layout): :func:`leaf_spec` of every leaf."""

    def walk(tree, prefix):
        return {k: (walk(v, f"{prefix}{k}/") if hasattr(v, "items")
                    else leaf_spec(mesh, f"{prefix}{k}",
                                   getattr(v, "shape", ()), zero_data_shard))
                for k, v in tree.items()}

    return walk(params, "")


def head_sharded(mesh: Optional[Mesh], vocab: int) -> bool:
    """Whether the vocabulary head's columns split over ``model`` (V
    divides; otherwise it is replicated with ``leaf_spec``'s warning)."""
    if mesh is None or mesh.model == 1:
        return False
    return leaf_spec(mesh, "head/bias", (vocab,)) == (MODEL_AXIS,)


def process_local_span(global_batch: int) -> Tuple[int, int]:
    """``[lo, hi)`` rows of a global batch this process is responsible
    for, by the process-major equal split. The data pipeline builds only
    these rows; ``Trainer`` checks this against ``process_local_rows``
    once at startup."""
    p, n = _dist.process_index(), _dist.process_count()
    return global_batch * p // n, global_batch * (p + 1) // n


@functools.lru_cache(maxsize=64)
def process_local_rows(mesh: Mesh, global_batch: int) -> Tuple[int, int]:
    """``[lo, hi)`` rows of the global batch this process owns: its data
    index's block. A process holds one rank, so its rows are one
    contiguous block by construction (JAX checks that the rows of a
    process's several devices tile one)."""
    d = mesh.data
    if global_batch % d:
        raise ValueError(f"global batch {global_batch} does not divide "
                         f"over data={d}")
    per = global_batch // d
    return mesh.data_index * per, (mesh.data_index + 1) * per


def shard_batch(mesh: Mesh, batch, device) -> Dict[str, torch.Tensor]:
    """This process's rows of a host batch (every leaf's leading dim is
    the global batch), as tensors on ``device``. Tensors already on the
    device are sliced there."""
    b = len(next(iter(batch.values())))
    lo, hi = process_local_rows(mesh, b)
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        out[k] = t[lo:hi].to(device)
    return out
