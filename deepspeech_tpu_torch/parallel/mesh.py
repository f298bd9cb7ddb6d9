"""The (data, model) or (data, pipe, model) mesh over a process group,
and its sharding rules.

The port's counterpart of the JAX package's ``parallel/mesh.py``. JAX
lays a ``Mesh`` over devices and lets XLA insert the collectives; here
the mesh is laid over the ranks of the ``torch.distributed`` group (one
card or one CPU process a rank) and the step calls the collectives of
``parallel/comm.py`` itself:

- ``data``: each rank of a data group (the ranks of one ``(pipe,
  model)`` index) takes its own contiguous block of the batch's rows;
  the gradients and the masked BN's statistics are all-reduced over it;
- ``pipe`` (a 3-element shape only): the ranks of a pipe group (one
  ``(data, model)`` index) share their rows and hold one stage each of
  the pipelined RNN middle (``models/pipe_stack.py``): the stacked
  ``rnn_pipe/`` leaves split dim 0 over it, and activations hop between
  adjacent stages over a two-rank group a pair;
- ``model``: the ranks of a model group (one ``(data, pipe)`` index)
  share their rows and split the vocabulary head's columns
  (``head/kernel``, ``head/bias``), all-gathering the logits.

Rank ``r`` sits at ``(r // (pipe * model), (r // model) % pipe, r %
model)``, the process-major order of the JAX mesh over
``jax.devices()``; a 2-element shape has no pipe axis.

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
from typing import Any, Dict, List, Optional, Tuple

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
    """A ``(data, model)`` or ``(data, pipe, model)`` layout of the
    group's ranks.

    ``shape`` maps each axis to its size, as ``jax.sharding.Mesh.shape``
    does; ``pipe`` is None for a 2-axis mesh, whose ``shape`` has no
    ``pipe``. ``data_group`` / ``pipe_group`` / ``model_group`` are the
    process groups of this rank's axes, and ``hops`` the two-rank groups
    this rank shares with the stage before and after it (None at the
    ends of the line), all None without a process group (no collective
    runs). An axis of one rank still has its group: the step's
    collectives run over it, and a one-rank sum or gather is exact."""

    data: int
    model: int
    rank: int = 0
    data_group: Any = None
    model_group: Any = None
    pipe: Optional[int] = None
    pipe_group: Any = None
    hops: Tuple[Any, Any] = (None, None)
    shape: Dict[str, int] = field(init=False)

    def __post_init__(self):
        self.shape = {DATA_AXIS: self.data}
        if self.pipe is not None:
            self.shape[PIPE_AXIS] = self.pipe
        self.shape[MODEL_AXIS] = self.model

    @property
    def stages(self) -> int:
        """The pipe axis's size, 1 without one."""
        return self.pipe or 1

    @property
    def size(self) -> int:
        return self.data * self.stages * self.model

    @property
    def data_index(self) -> int:
        return self.rank // (self.stages * self.model)

    @property
    def pipe_index(self) -> int:
        return (self.rank // self.model) % self.stages

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def stage_rank(self, stage: int) -> int:
        """The global rank of ``stage`` on this rank's pipe line (its
        data and model index)."""
        return ((self.data_index * self.stages + stage) * self.model
                + self.model_index)

    def __repr__(self) -> str:
        pipe = "" if self.pipe is None else f"pipe={self.pipe}, "
        return (f"Mesh(data={self.data}, {pipe}model={self.model}, "
                f"rank={self.rank})")


def axis_groups(data: int, pipe: int, model: int
                ) -> Dict[str, List[List[int]]]:
    """The ranks of every group of a ``(data, pipe, model)`` mesh, in
    the order :func:`make_mesh` creates them: each axis's groups (the
    ranks that differ only in that axis's index) and ``hop``, one
    ``[stage p, stage p + 1]`` pair a pipe line and a p."""

    def rank(d, p, m):
        return (d * pipe + p) * model + m

    out = {DATA_AXIS: [[rank(d, p, m) for d in range(data)]
                       for p in range(pipe) for m in range(model)],
           PIPE_AXIS: [[rank(d, p, m) for p in range(pipe)]
                       for d in range(data) for m in range(model)],
           MODEL_AXIS: [[rank(d, p, m) for m in range(model)]
                        for d in range(data) for p in range(pipe)]}
    out["hop"] = [[line[p], line[p + 1]] for line in out[PIPE_AXIS]
                  for p in range(pipe - 1)]
    return out


def _group(ranks, world: int):
    """A process group over ``ranks`` (every rank must call this, in the
    same order); the world's own group when it spans the world."""
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def make_mesh(shape: Tuple[int, ...] = (0, 1)) -> Mesh:
    """Build the ``(data, model)`` or ``(data, pipe, model)`` mesh over
    the group's ranks (one rank without a group). ``shape[0] <= 0``
    means 'all ranks / product(rest)'. Every rank of the group calls it,
    in the same order: it creates the groups of every axis and the
    hops (``axis_groups``)."""
    world = _dist.process_count()
    if len(shape) == 2:
        dp, rest = int(shape[0]), (int(shape[1]),)
    elif len(shape) == 3:
        dp, rest = int(shape[0]), (int(shape[1]), int(shape[2]))
    else:
        raise ValueError(f"mesh shape {shape} must be (data, model) or "
                         f"(data, pipe, model)")
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
    pp = rest[0] if len(rest) == 2 else None
    mp = rest[-1]
    rank = _dist.process_index()
    mesh = Mesh(dp, mp, rank, pipe=pp)
    if not _dist.is_initialized():
        return mesh
    groups = axis_groups(dp, mesh.stages, mp)
    axes = [(DATA_AXIS, "data_group"), (MODEL_AXIS, "model_group")]
    if pp is not None:
        axes.insert(1, (PIPE_AXIS, "pipe_group"))
    # Every rank creates every group, in one order.
    for axis, attr in axes:
        for ranks in groups[axis]:
            g = _group(ranks, world)
            if rank in ranks:
                setattr(mesh, attr, g)
    hops = [None, None]
    for pair in groups["hop"] if pp is not None else ():
        g = _group(pair, world)
        if rank in pair:
            # hops[0]: with the stage before; hops[1]: with the one after.
            hops[int(pair[0] == rank)] = g
    mesh.hops = tuple(hops)
    return mesh


# Parameter-name patterns -> spec for the tensor-parallel axis; every
# other leaf is replicated. Kernels are [in, out] (the flax layout):
# sharding the head's out dim splits the [T', H] x [H, V] product over
# the model axis, and the logits are gathered for the loss.
_PARAM_RULES = (
    (re.compile(r"head/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r"head/bias$"), (MODEL_AXIS,)),
    # The pipelined RNN middle: stacked [n_layers, ...] leaves shard dim
    # 0 over the pipe axis (each rank holds its stage's layers); a (data,
    # model) mesh lacks it and replicates them.
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
