"""Training: forward, CTC, backward, clip, optimizer step; the epoch loop
with checkpoints and a deterministic mid-epoch resume.

The port's counterpart of ``deepspeech_tpu/train.py`` on one card. A
step runs the model in train mode (batch statistics normalise and
update the running ones), the CTC loss through the kernels of
``ops/ctc.py``, the backward through ``ops/gru.py``'s ``gru_bwd`` (an
LSTM model's through ``ops/lstm.py``'s ``lstm_bwd``), then
the reference's optimizer chain (``train.py:69-95``): clip by global
norm exactly as optax does, then SGD with Nesterov momentum or AdamW,
with the warmup/anneal learning rate written into the optimizer every
step. Evaluation is greedy WER/CER.

``fit`` reads each epoch's batches through ``data.device_prefetch``
(pinned memory, a side CUDA stream). With ``train.checkpoint_dir`` set,
``Trainer`` saves a step (checkpoint.py) every
``checkpoint_every_steps`` with the current epoch and at each epoch's
end with the next; ``maybe_restore`` restores the newest intact step
(parameters, BN statistics, optimizer state, step and epoch), and
``fit`` then skips the batches of that epoch already consumed without
loading them, so the resumed run ends bit-identical to an uninterrupted
one.

The guarded step (``train.guardian``, or ``DS2_GUARDIAN`` as
``resilience/guardian.py`` reads it) judges each step on the device
(a finite loss, gradient norm and update norm) and gates it there: a bad
step leaves the parameters, the BN statistics and the optimizer state bit
for bit as they were, with no host sync in the gate (the previous values
are kept on the device and written back with ``torch.where``). The
:class:`~.resilience.guardian.TrainingGuardian` then skips the batch,
backs the rate off (its ``lr_scale`` multiplies the optimizer's rate) or
rolls back to the checkpoint manager's last-good ring, a
:class:`~.resilience.guardian.StallWatchdog` watches for a wedged step,
and a :class:`~.resilience.preempt.PreemptionGuard` (SIGTERM in the CLI)
makes ``fit`` write an emergency checkpoint and return. The
``train.step`` fault point's ``nan_grad`` poisons a batch to drive it.
``train.tensorboard_dir`` writes TensorBoard scalars (``ImportError``
where the ``tensorboard`` package is missing) and ``train.profile_dir``
a ``torch.profiler`` trace of ``train.profile_steps`` steps from
``train.profile_start_step``.

Data parallelism (JAX ``train.py:253-295``, ``:411-462``,
``:576-628``): ``Trainer`` lays the model over a ``(data, model)`` mesh
of the process group (``parallel/mesh.py``; ``train.mesh_shape``, or a
``mesh``). Each rank takes its own contiguous rows of the global batch
and runs every kernel on them; the masked BN takes global statistics
over the data group and a sharded vocabulary head gathers its logits
over the model group (``models/ds2.py``). A step then all-reduces the
gradients over the data group in ONE flat all-reduce, divided by the
data size, before the clip; the reported loss is all-reduced to the
global mean, so the guardian judges the same loss, gradient norm and
update norm on every rank and every rank skips, backs off or rolls
back together. ``train.accum_steps`` splits the batch into strided
microbatches (row r into microbatch ``r % accum``), threads the BN
statistics through them in order and averages the gradients and the
loss. ``train.zero_opt_sharding`` keeps each rank's rows of the
optimizer state (``parallel/zero.py``). Only the primary rank logs,
writes TensorBoard and writes checkpoints (the ZeRO and head shards
gathered into the dense layout); every rank restores and re-shards.
Without a process group no collective runs; under a group of one rank
every collective runs over that rank, which is exact, so both give the
one-card step, bit for bit.

Sequence-parallel training (``train.sequence_parallel``, JAX
``train.py:202-217``, ``:437-456``): the step's loss and gradients come
from ``parallel/seqpar.py``'s ``sp_loss`` over ``Trainer.sp_devices``,
the time axis cut into one shard a device (every local card, or the
CPU when asked for; a list may repeat a device). Batch rows replicate,
so there is no row split; every ``data.bucket_frames`` must divide by
``sp_frame_multiple(cfg, S)``. ``sp_loss`` returns this batch's BN
statistics and the step applies the momentum to the running buffers, as
JAX's step does; clip, optimizer, guarded step, checkpoints and
evaluation (the offline forward on the home device) are the offline
path's. It excludes ``accum_steps > 1``, a pipelined tree and more than
one process, as JAX's does; GRU and LSTM models both train.

Pipeline-parallel training (``model.pipeline_stages > 1``, JAX
``train.py:477-510``): the mesh is ``(data, pipe, model)`` with a pipe
axis of ``pipeline_stages`` ranks (``train.mesh_shape=d,P,m``), each
holding its stage of the stacked RNN layers, their BN statistics and
their optimizer state (``parallel/zero.py``), and the model's forward
runs the GPipe schedule (``models/pipe_stack.py``). The ranks of a pipe
group share their rows; every one of them runs the conv, ``rnn0``, the
head and the loss, and their replicated leaves' gradients are the same
bits without an all-reduce over ``pipe``. The global norm sums the
stacked leaves' squares over the pipe group, so the clip and the
guardian decide alike on every rank; ``evaluate`` scores on pipe index
0 only; a checkpoint gathers the stages into the dense layout of a
one-card run, which restores into any topology. The batch divides by
accum x microbatches x data. A pipelined tree without the pipe axis is
refused with JAX's ``ValueError``. JAX refuses ``rnn_impl="pallas"``
here because its pipelined layers run the XLA scan; the port's stages
run the kernels, so it has no such refusal.

What the JAX trainer has and the port does not yet raises
``NotImplementedError`` naming the queue item that brings it: RNN-T
(item 15).

CLI: ``python -m deepspeech_tpu_torch.train --config=dev_slice
[--synthetic=N] [--device=cpu] [--section.key=value ...]``: it trains
on ``data.train_manifest`` (or N synthetic utterances), evaluates on
``data.eval_manifest``, restores ``train.checkpoint_dir``'s newest step
first, and ends with a ``{"event": "done", ...}`` line. A fresh run's
weights are a random init seeded by ``train.seed``. ``torchrun
--nproc_per_node=N -m deepspeech_tpu_torch.train --config=...
--train.mesh_shape=0,1`` trains on N cards (``initialize_distributed``
joins the group first); with one process it behaves as on one card.
``torchrun --nproc_per_node=2 -m deepspeech_tpu_torch.train --config=...
--model.pipeline_stages=2 --train.mesh_shape=1,2,1`` trains a pipelined
model in two stages.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import obs
from .bridge import (STACKED_PREFIX, _flatten, from_flax, init_params,
                     to_flax)
from .config import Config
from .data.pipeline import device_prefetch
from .data.tokenizer import CharTokenizer
from .decode.greedy import greedy_decode, ids_to_texts
from .device import resolve_device
from .infer import PrintLogger
from .metrics import char_errors, word_errors
from .models.ds2 import HEAD_KEYS, DeepSpeech2
from .ops.ctc import ctc_loss_mean
from .parallel import comm, zero
from .parallel.distributed import (is_initialized, is_primary,
                                   process_count)
from .parallel.mesh import (DATA_AXIS, Mesh, make_mesh, process_local_rows,
                            process_local_span, shard_batch)
from .resilience import faults
from .resilience.guardian import STEP_HIST, GuardianConfig


def check_supported(cfg: Config) -> None:
    """Raise on what the JAX trainer has and the port does not yet, and
    on what JAX's sequence-parallel step excludes."""
    t = cfg.train
    if t.sequence_parallel and (max(t.accum_steps, 1) > 1
                                or cfg.model.pipeline_stages > 1):
        raise ValueError("sequence_parallel excludes accum_steps>1 and "
                         "pipeline_stages>1")
    if t.objective == "rnnt":
        raise NotImplementedError("train.objective='rnnt' comes with item "
                                  "15 of the port")
    if t.objective != "ctc":
        raise ValueError(f"train.objective={t.objective!r}; 'ctc' or 'rnnt'")
    if t.optimizer not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer {t.optimizer!r}")
    if t.loss_impl not in ("auto", "pallas"):
        raise ValueError(f"train.loss_impl={t.loss_impl!r}: the port runs "
                         "the CTC loss through ops/ctc.py's kernels; use "
                         "'auto' or 'pallas'")


def make_lr_schedule(cfg: Config, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """Linear warmup to ``learning_rate``, then ``1 / lr_anneal^epoch``."""
    t = cfg.train

    def schedule(step: int) -> float:
        warm = min((step + 1) / max(t.warmup_steps, 1), 1.0)
        epoch = step // max(steps_per_epoch, 1)
        return t.learning_rate * warm / t.lr_anneal ** epoch

    return schedule


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """``optax.sgd(nesterov=True)`` or ``optax.adamw`` as torch
    optimizers (the same update rules; the learning rate is set per
    step by ``Trainer.train_step``). Clipping is
    ``clip_by_global_norm``."""
    t = cfg.train
    if t.optimizer == "sgd":
        return torch.optim.SGD(params, lr=t.learning_rate,
                               momentum=t.momentum, nesterov=True)
    if t.optimizer == "adamw":
        # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8.
        return torch.optim.AdamW(params, lr=t.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=t.weight_decay)
    raise ValueError(f"unknown optimizer {t.optimizer!r}")


@torch.no_grad()
def global_norm(tensors: Sequence[torch.Tensor],
                sharded: Sequence[bool] = (), group=None,
                staged: Sequence[bool] = (), pipe_group=None
                ) -> torch.Tensor:
    """``optax.global_norm``: the square root of every element's square,
    summed. The tensors ``sharded`` marks are this rank's columns of a
    leaf split over ``group`` (the sharded head), those ``staged`` marks
    this rank's stage of a stacked leaf split over ``pipe_group``: their
    squares are all-reduced over it, so every rank gets the whole leaf's
    norm."""
    sq = [t.float().square().sum() for t in tensors]
    for marks, g in ((sharded, group), (staged, pipe_group)):
        own = [i for i, s in enumerate(marks) if s]
        if own:
            whole = comm.all_reduce_sum(torch.stack([sq[i] for i in own]), g)
            for j, i in enumerate(own):
                sq[i] = whole[j]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Scale ``grads`` in place as ``optax.clip_by_global_norm`` does:
    ``g / norm * max_norm`` when ``norm >= max_norm``, unchanged below
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). Returns the
    global norm before clipping (``norm`` when given: the
    :func:`global_norm` of a sharded head), on the device (no host
    sync)."""
    if norm is None:
        norm = global_norm(grads)
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A batch as tensors on ``device``: host arrays by pageable copies,
    tensors already there as they are."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in batch.items()}


class LocalBatch(dict):
    """A batch that is already this rank's rows on its device (``fit``'s
    prefetched batches): the steps take it as it is."""


class _Silent:
    """The logger of a non-primary rank: only the primary logs."""

    def log(self, event: str, **fields) -> None:
        pass


def _checksum(*trees) -> int:
    """CRC-32 of flax-layout trees' names and bytes, in key order."""
    crc = 0
    for tree in trees:
        for k, v in sorted(_flatten(tree or {}).items()):
            crc = zlib.crc32(k.encode(), crc)
            crc = zlib.crc32(np.ascontiguousarray(v).tobytes(), crc)
    return crc


class Trainer:
    """Epoch loop over a pipeline's batches on one device, or on this
    rank's device of a ``(data, model)`` or ``(data, pipe, model)``
    mesh, with greedy WER/CER
    evaluation and, with ``train.checkpoint_dir`` set, checkpoints and
    resume.

    ``pipeline`` has the interface of ``data.DataPipeline`` (``peek``,
    ``epoch(e, start)``, ``eval_epoch``, ``batches_per_epoch``; as
    ``data.SyntheticPipeline`` has too) and yields global batches
    (under a process group, real data in this process's rows).
    ``logger.log(event, **fields)`` receives ``train_step``,
    ``epoch_end``, ``eval`` and ``restore`` events, and a pipeline
    without a logger of its own gets this one for its ``corrupt_sample``
    events; on a non-primary rank nothing is logged. ``device`` None
    means the card (raises without CUDA; this rank's card in a process
    group); "cpu" runs the plain versions.
    ``params`` / ``batch_stats`` (flax-layout trees) default to
    ``bridge.init_params`` seeded by ``train.seed``. ``preempt`` (a
    :class:`~.resilience.preempt.PreemptionGuard`) is polled once a step
    by ``fit``. ``mesh`` (``parallel.make_mesh``) defaults to
    ``make_mesh(train.mesh_shape)`` over the process group; without a
    group that is one device, and a mesh of more raises JAX's
    ``ValueError``. ``sp_devices`` (``train.sequence_parallel``) are the
    time shards, one entry a shard: by default every local card, or
    ``[device]`` on the CPU; ``[cpu] * 8`` gives eight CPU shards.
    """

    def __init__(self, cfg: Config, pipeline, tokenizer: CharTokenizer,
                 eval_pipeline=None, logger=None, device=None,
                 params=None, batch_stats=None, preempt=None,
                 mesh: Optional[Mesh] = None,
                 sp_devices: Optional[Sequence[torch.device]] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.pipeline = pipeline
        self.eval_pipeline = eval_pipeline
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            cfg.train.mesh_shape)
        self.world = process_count()
        self.primary = is_primary()
        self.accum = max(cfg.train.accum_steps, 1)
        b = cfg.data.batch_size
        self.sp_devices = None
        if cfg.train.sequence_parallel:
            self.sp_devices = self._sp_setup(sp_devices)
        if self.world > 1:
            # The pipeline fills only this process's rows by the equal
            # process-major split; the mesh's row ownership must agree.
            # A batch axis that does not cross processes (data=1)
            # replicates every row everywhere, which only a pipeline
            # that builds the whole global batch on every rank serves.
            # A pipe axis across processes gives the ranks of a pipe
            # group the same rows: with data > 1 too, only such a
            # pipeline serves it (one process a rank, where JAX lays a
            # host's devices along the pipe axis).
            local = process_local_rows(self.mesh, b)
            replicated_ok = ((local == (0, b) or self.mesh.stages > 1)
                             and getattr(pipeline, "provides_global_batches",
                                         False))
            if local != process_local_span(b) and not replicated_ok:
                raise ValueError(
                    "mesh device order breaks the process-major batch "
                    "split assumed by the data pipeline: "
                    f"{local} != {process_local_span(b)}")
        data_size = self.mesh.shape[DATA_AXIS]
        if self.sp_devices is None and b % (self.accum * data_size):
            raise ValueError(
                f"batch_size {b} must divide by "
                f"accum_steps*data = {self.accum}*{data_size}")
        stages = cfg.model.pipeline_stages
        if stages > 1:
            # JAX train.py:477-493: the mesh must carry the pipe axis.
            if self.mesh.pipe != stages:
                raise ValueError(
                    f"pipeline_stages={stages} needs mesh_shape=(data, "
                    f"{stages}, model); mesh has {dict(self.mesh.shape)}")
            micro = cfg.model.pipeline_microbatches or stages
            if b % (self.accum * micro * data_size):
                raise ValueError(
                    f"batch_size {b} must divide by "
                    f"accum*microbatches*data = "
                    f"{self.accum}*{micro}*{data_size}")
        self.logger = (logger or PrintLogger()) if self.primary else _Silent()
        for pipe in (pipeline, eval_pipeline):
            if pipe is not None and getattr(pipe, "logger", 0) is None:
                pipe.logger = self.logger
        self.steps_per_epoch = max(pipeline.batches_per_epoch(1), 1)
        self.lr_schedule = make_lr_schedule(cfg, self.steps_per_epoch)
        if params is None:
            params, batch_stats = init_params(
                cfg, torch.Generator().manual_seed(cfg.train.seed))
        if is_initialized():
            self._check_same_init(params, batch_stats)
        self.model = DeepSpeech2(cfg.model, cfg.features.num_features,
                                 mesh=self.mesh)
        self.model.load_state_dict(from_flax(params, batch_stats or {},
                                             self.model.head_group,
                                             self.model.pipe_group))
        self.model.to(self.device)
        self._params = list(self.model.parameters())
        # Which parameters are this rank's columns of the sharded head,
        # and which its stage of the stacked layers.
        names = [n for n, _ in self.model.named_parameters()]
        self._sharded = [n in HEAD_KEYS and self.model.head_group is not None
                         for n in names]
        self._staged = [n.startswith(STACKED_PREFIX)
                        and self.model.pipe_group is not None for n in names]
        self._layout = zero.layout(self.model, self.mesh,
                                   cfg.train.zero_opt_sharding)
        self._zero = {i: s for i, s in self._layout.items() if s.zero}
        # The tensors the optimizer steps: a ZeRO leaf's rows, else the
        # parameter itself.
        self.opt_params = zero.zero_params(self._params, self._layout)
        self.optimizer = make_optimizer(cfg, self.opt_params)
        self.step = 0
        self.start_epoch = 0
        self.preempt = preempt
        self.tb = None
        if cfg.train.tensorboard_dir and self.primary:
            from .utils.logging import TensorBoardLogger

            self.tb = TensorBoardLogger(cfg.train.tensorboard_dir)
        # DS2_GUARDIAN enables and configures the guardian; with the
        # environment silent, train.guardian enables its defaults.
        self.guardian_cfg = GuardianConfig.from_env()
        if self.guardian_cfg is None and cfg.train.guardian:
            self.guardian_cfg = GuardianConfig()
        self.ckpt = None
        if cfg.train.checkpoint_dir:
            from .checkpoint import CheckpointManager

            self.ckpt = CheckpointManager(
                cfg.train.checkpoint_dir, keep=cfg.train.keep_checkpoints,
                last_good_keep=(self.guardian_cfg.ring_size
                                if self.guardian_cfg else 2),
                persist=self.primary)
        self.guardian = None
        if self.guardian_cfg is not None:
            from .resilience.guardian import TrainingGuardian

            self.guardian = TrainingGuardian(self.guardian_cfg,
                                             ckpt=self.ckpt)
        # The guarded step's host-side undo, settled by commit_step.
        self._pending = None

    def _sp_setup(self, sp_devices) -> List[torch.device]:
        """The time shards of ``train.sequence_parallel``, after JAX's
        guards (``train.py:437-456``) that ``check_supported`` has not
        made: one process, and every bucket's frame count a multiple of
        ``sp_frame_multiple`` over the shards (batch rows replicate, so
        ``batch_size`` needs no multiple)."""
        from .parallel.seqpar import sp_frame_multiple

        if self.world > 1:
            raise ValueError("sequence_parallel is single-process")
        if sp_devices is None:
            sp_devices = ([torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
                          if self.device.type == "cuda" else [self.device])
        devices = [torch.device(d) for d in sp_devices]
        mult = sp_frame_multiple(self.cfg.model, len(devices))
        bad = [f for f in self.cfg.data.bucket_frames if f % mult]
        if bad:
            raise ValueError(f"bucket_frames {bad} must divide by "
                             f"shards*time_stride = {mult}")
        return devices

    def _check_same_init(self, params, batch_stats) -> None:
        """Every rank seeds its init the same way, as every JAX host
        does, with no broadcast: check once, with one all-gather of a
        checksum, that they agree."""
        mine = torch.tensor([_checksum(params, batch_stats)],
                            dtype=torch.int64)
        mine = mine.to(comm.collective_device(dist.group.WORLD))
        sums = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(sums, mine)
        sums = [int(x) for x in sums]
        if len(set(sums)) != 1:
            raise ValueError(f"the ranks' initial parameters differ "
                             f"(checksums {sums}); seed every rank alike")

    def _barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    def local_batch(self, batch: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch (host arrays, or tensors),
        on the device; a :class:`LocalBatch` as it is."""
        if isinstance(batch, LocalBatch):
            return batch
        return shard_batch(self.mesh, batch, self.device)

    def _host_rows(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
        """This rank's rows of a global host batch (views)."""
        lo, hi = process_local_rows(self.mesh, len(batch["feat_lens"]))
        return {k: v[lo:hi] for k, v in batch.items()}

    def maybe_restore(self) -> None:
        """Restore the newest intact step of ``train.checkpoint_dir``:
        parameters, BN statistics, optimizer state, step and epoch (every
        rank reads the same step and takes its shards of it)."""
        if self.ckpt is None:
            return
        restored = self.ckpt.restore()
        if restored is None:
            return
        self.model.load_state_dict(from_flax(restored["params"],
                                             restored["batch_stats"],
                                             self.model.head_group,
                                             self.model.pipe_group))
        if restored["opt_state"] is not None:
            self.optimizer.load_state_dict(zero.local_state_dict(
                restored["opt_state"], self._layout))
        self.step = restored["step"]
        self.start_epoch = restored["epoch"]
        self.logger.log("restore", step=self.step, epoch=self.start_epoch)

    def optimizer_state_dict(self) -> Dict:
        """The optimizer's ``state_dict`` in the dense layout a one-card
        run has (ZeRO rows, head columns and stages gathered: a
        collective, every rank calls it)."""
        return zero.dense_state_dict(self.optimizer.state_dict(),
                                     self._layout)

    def save(self, epoch: int) -> None:
        """Checkpoint the current step with ``epoch``, the epoch a
        resume starts in. The state is on the host when this returns.
        Every rank calls it; the primary writes."""
        if self.ckpt is None:
            return
        head, pipe = self.model.head_group, self.model.pipe_group
        if self.primary or head is not None or pipe is not None:
            # A gather is collective.
            params, batch_stats = to_flax(self.model.state_dict(), head,
                                          pipe)
        opt_state = self.optimizer_state_dict()
        if self.primary:
            self.ckpt.save(self.step, {
                "params": params, "batch_stats": batch_stats,
                "opt_state": opt_state, "epoch": epoch,
                "config": self.cfg.name})

    def _wait_saved(self) -> None:
        """The primary's writer joined, then every rank past a barrier:
        the step is on disk for all."""
        if self.ckpt is not None:
            self.ckpt.wait()
        self._barrier()

    def _grads(self, dev: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Forward, CTC and backward on this rank's rows, the gradients
        left in the parameters' ``.grad`` averaged over the data group;
        returns the step's loss, the global mean.

        With ``accum`` microbatches the split is strided: row r goes to
        microbatch ``r % accum`` (JAX ``train.py:257-283``). Since
        ``batch_size % (accum * data) == 0``, this rank's contiguous
        block starts at a multiple of ``accum``, so its local row j is
        global row ``lo + j`` and lands in microbatch ``j % accum``:
        ``rows[k::accum]`` locally is this rank's share of the global
        microbatch k. The BN running statistics are threaded through the
        microbatches in order; the gradients and the loss are summed and
        divided by ``accum``. With ``train.sequence_parallel`` the loss
        and gradients are ``_sp_backward``'s (one process, accum 1)."""
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        if self.sp_devices is not None:
            loss = self._sp_backward(dev)
        else:
            loss = None
            for k in range(self.accum):
                # accum 1: the whole batch (a stride of 1 is a view).
                mb = {key: v[k::self.accum].contiguous()
                      for key, v in dev.items()}
                logits, lens = self.model(mb["features"], mb["feat_lens"])
                mloss = ctc_loss_mean(logits, mb["labels"], lens,
                                      mb["label_lens"])
                mloss.backward()
                mloss = mloss.detach()
                loss = mloss if loss is None else loss + mloss
        with torch.no_grad():
            for p in self._params:
                if p.grad is None:  # an unused leaf: JAX's zero gradient
                    p.grad = torch.zeros_like(p)
                elif self.accum > 1:
                    p.grad /= self.accum
        if self.accum > 1:
            loss = loss / self.accum
        # ONE flat all-reduce of the gradients over the data group,
        # divided by the data size, before the clip; the loss reported is
        # the global mean.
        comm.all_reduce_mean_([p.grad for p in self._params],
                              self.mesh.data_group)
        comm.all_reduce_mean_([loss], self.mesh.data_group)
        return loss

    def _sp_backward(self, dev: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``_grads``' sequence-parallel forward and backward: ``sp_loss``
        over ``sp_devices``, its backward, then the momentum update of each
        BN's running statistics with the batch's (JAX
        ``train.py:202-217``); returns the loss."""
        from .parallel.seqpar import sp_loss

        loss, stats = sp_loss(self.cfg.model, self.model, dev["features"],
                              dev["feat_lens"], dev["labels"],
                              dev["label_lens"], self.sp_devices)
        loss.backward()
        for name, (mean, var) in stats.items():
            self.model.get_submodule(name).update(mean, var)
        return loss.detach()

    def _norm(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of per-parameter tensors (a sharded head's
        squares summed over the model group, the stacked layers' over the
        pipe group)."""
        return global_norm(tensors, self._sharded, self.model.head_group,
                           self._staged, self.model.pipe_group)

    def _clip(self) -> torch.Tensor:
        grads = [p.grad for p in self._params]
        return clip_by_global_norm(grads, self.cfg.train.grad_clip_norm,
                                   self._norm(grads))

    def _optimizer_step(self, lr: float) -> None:
        """Set the rate and step. A ZeRO leaf's rows take the parameter's
        current rows and gradient, are stepped, and the updated rows are
        all-gathered into the parameter."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        with torch.no_grad():
            for i, s in self._zero.items():
                p, rows = self._params[i], self.opt_params[i]
                rows.copy_(p.narrow(s.dim, s.lo, s.n))
                rows.grad = (None if p.grad is None else
                             p.grad.narrow(s.dim, s.lo, s.n).contiguous())
        self.optimizer.step()
        with torch.no_grad():
            for i, s in self._zero.items():
                self._params[i].copy_(comm.all_gather_dim(
                    self.opt_params[i].detach(), s.dim, s.group))

    def train_step(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """One step on a global batch (host arrays, or tensors on the
        device; this rank takes its rows): forward in train mode, mean
        CTC, backward, the gradients averaged over the data group, global
        norm, clip, optimizer step at this step's rate. Returns
        ``{"loss", "grad_norm"}`` as device scalars, the same on every
        rank.

        With the guardian on this is the guarded step
        (:meth:`guarded_step` at the guardian's ``lr_scale``), and the
        caller settles it with :meth:`commit_step`."""
        if self.guardian is not None:
            return self.guarded_step(batch, self.guardian.lr_scale)
        loss = self._grads(self.local_batch(batch))
        grad_norm = self._clip()
        self._optimizer_step(self.lr_schedule(self.step))
        self.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    def guarded_step(self, batch: Dict[str, np.ndarray], lr_scale: float
                     ) -> Dict[str, torch.Tensor]:
        """The step of :meth:`train_step` at ``lr_scale`` times the
        scheduled rate, gated on the device.

        Every tensor the step writes in place (parameters, BN buffers,
        the optimizer's state tensors on the device) is kept as it was
        on the device; after the step each is written back as
        ``torch.where(ok, new, old)``, ``ok`` being a finite loss,
        gradient norm and update norm: no host sync. Under a process
        group all three are the same on every rank (the loss and the
        gradients all-reduced, the parameters all-gathered), so a
        poisoned batch on one rank gates the step on all. The update norm is
        the applied update's divided back by ``lr_scale``, as the JAX
        step reports it. The optimizer state that torch keeps on the host
        (AdamW's ``step`` counters on a CUDA run) and state the step
        created (torch creates SGD's momentum buffer and AdamW's moments
        at a parameter's first step; optax starts from zeros) follow
        the host's verdict instead: :meth:`commit_step` restores the
        first and drops the second for a step that did not stand, so a
        skipped step leaves no trace, not even a buffer the unguarded
        run would not have. ``self.step`` advances in ``commit_step``.
        Returns ``{"loss", "grad_norm", "update_norm", "applied"}`` as
        device scalars."""
        dev = self.local_batch(batch)
        params = self._params
        opt_params = self.opt_params
        buffers = list(self.model.buffers())
        state = self.optimizer.state
        with torch.no_grad():
            old_params = [p.detach().clone() for p in params]
            old_buffers = [b.clone() for b in buffers]
            old_state = {p: {k: v.clone() for k, v in state[p].items()
                             if torch.is_tensor(v)}
                         for p in opt_params if state.get(p)}
        loss = self._grads(dev)
        grad_norm = self._clip()
        self._optimizer_step(self.lr_schedule(self.step) * lr_scale)
        host: List = []
        fresh = [p for p in opt_params if state.get(p) and p not in old_state]
        with torch.no_grad():
            update_norm = self._norm(
                [p - o for p, o in zip(params, old_params)]) / lr_scale
            ok = (torch.isfinite(loss) & torch.isfinite(grad_norm)
                  & torch.isfinite(update_norm))
            for t, old in zip(params + buffers, old_params + old_buffers):
                t.copy_(torch.where(ok, t, old))
            for p in opt_params:
                before = old_state.get(p, {})
                for k, v in state.get(p, {}).items():
                    if not torch.is_tensor(v):
                        continue
                    if v.device != ok.device:
                        if k in before:
                            host.append((v, before[k]))
                        continue
                    v.copy_(torch.where(ok, v, before[k] if k in before
                                        else torch.zeros_like(v)))
        self._pending = (host, fresh)
        return {"loss": loss, "grad_norm": grad_norm,
                "update_norm": update_norm, "applied": ok}

    def commit_step(self, applied: bool) -> None:
        """Settle the last :meth:`guarded_step` on the host's verdict:
        advance ``self.step`` when its update stood; otherwise restore
        the host-side optimizer state it changed and drop the state it
        created (see :meth:`guarded_step`)."""
        pending, self._pending = self._pending, None
        if applied:
            self.step += 1
            return
        host, fresh = pending if pending is not None else ([], [])
        for t, old in host:
            t.copy_(old)
        for p in fresh:
            self.optimizer.state.pop(p, None)

    def state_snapshot(self) -> Dict:
        """The model's and the optimizer's ``state_dict`` (the guardian's
        last-good ring copies it to the host)."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_snapshot(self, snap: Dict) -> None:
        """Load a :meth:`state_snapshot` (a rollback's target)."""
        self.model.load_state_dict(snap["model"])
        self.optimizer.load_state_dict(snap["optimizer"])

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Greedy WER/CER over the eval pipeline (else the training one)."""
        if self.cfg.decode.mode != "greedy":
            self.logger.log("eval_note",
                            note="in-training eval uses greedy decode")
        pipe = self.eval_pipeline or self.pipeline
        self.model.eval()
        # Each rank scores the rows it owns (a model group's and a pipe
        # group's ranks share theirs: only their first scores them); the
        # counts are summed over the ranks once at the end.
        scores = self.mesh.model_index == 0 and self.mesh.pipe_index == 0
        counts = np.zeros((5,), np.int64)  # werr, wtot, cerr, ctot, n
        for batch, n_valid in pipe.eval_epoch():
            lo, _ = process_local_rows(self.mesh, len(batch["feat_lens"]))
            dev = self.local_batch(batch)
            logits, lens = self.model(dev["features"], dev["feat_lens"])
            ids, out_lens = greedy_decode(logits, lens)
            hyps = ids_to_texts(ids, out_lens, self.tokenizer)
            for j, hyp in enumerate(hyps if scores else []):
                g = lo + j
                if g >= n_valid:
                    break
                ref = self.tokenizer.decode(
                    batch["labels"][g][:batch["label_lens"][g]])
                we, wn = word_errors(ref, hyp)
                ce, cn = char_errors(ref, hyp)
                counts += (we, wn, ce, cn, 1)
        if self.world > 1:
            counts = comm.host_all_reduce(counts, dist.group.WORLD).numpy()
        werr, wtot, cerr, ctot, n = (int(c) for c in counts)
        return {"wer": werr / max(wtot, 1), "cer": cerr / max(ctot, 1),
                "n_utts": n}

    def fit(self, epochs: Optional[int] = None) -> Dict[str, float]:
        """Train from ``start_epoch`` to ``epochs`` (default
        ``train.epochs``). After ``maybe_restore`` the batches of the
        restored epoch already consumed are skipped by the pipeline
        (``epoch(e, start=...)``) before they are loaded, since the
        sampler's order is a pure function of (seed, epoch).

        With the guardian on, each step's metrics go to
        ``TrainingGuardian.observe_step`` (the host sync the guarded path
        accepts) and its decision is carried out: a skipped batch leaves
        the state as it was, a rollback loads the last-good ring's
        newest entry (the data stream goes on), and a watchdog watches
        the ``train.step_s`` histogram. When ``preempt.requested()``,
        the step is checkpointed with the current epoch and ``fit``
        returns with ``preempted``; the resumed run ends bit-identical
        to an uninterrupted one."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.train.epochs
        every = cfg.train.checkpoint_every_steps
        last: Dict[str, float] = {}
        metrics: Dict[str, torch.Tensor] = {}
        steps_before = sum(self.pipeline.batches_per_epoch(e)
                           for e in range(self.start_epoch))
        skip = max(self.step - steps_before, 0)
        profiler = None
        profile_end = cfg.train.profile_start_step + cfg.train.profile_steps
        profile_done = preempted = False
        # The batch's ordinal in the run's data stream: it advances
        # through skips and rollbacks (recovery replays nothing).
        consumed = self.step
        watchdog = None
        if self.guardian is not None:
            gcfg = self.guardian.cfg
            if gcfg.watchdog:
                from .resilience.guardian import StallWatchdog

                watchdog = StallWatchdog(
                    k=gcfg.watchdog_k, min_timeout_s=gcfg.watchdog_min_s,
                    poll_s=gcfg.watchdog_poll_s,
                    preempt=self.preempt).start()
            # Seed the ring: the very first anomaly has a target.
            self.guardian.snapshot(self.step, self.state_snapshot())
        try:
            for epoch in range(self.start_epoch, epochs):
                t_epoch = time.perf_counter()
                t_log, utts = time.perf_counter(), 0
                batches = map(self._host_rows,
                              self.pipeline.epoch(epoch, start=skip))
                skip = 0
                for batch in map(LocalBatch,
                                 device_prefetch(batches, self.device)):
                    # ">=" so that a resume past profile_start_step still
                    # traces the steps left of the window.
                    if (cfg.train.profile_dir and profiler is None
                            and not profile_done
                            and profile_end > self.step
                            >= cfg.train.profile_start_step):
                        profiler = self._start_profile()
                    spec = faults.inject("train.step")
                    if spec is not None and spec.kind == "nan_grad":
                        # Chaos: poison the batch so the step's loss and
                        # gradients come out non-finite.
                        batch = LocalBatch(
                            batch, features=batch["features"] * float("nan"))
                    lr = self.lr_schedule(self.step)
                    if self.guardian is not None:
                        lr *= self.guardian.lr_scale
                    t_step = time.perf_counter()
                    with obs.span("train.step", step=self.step):
                        metrics = self.train_step(batch)
                    if self.guardian is not None:
                        decision = self.guardian.observe_step(
                            self.step, consumed, metrics)
                        obs.registry().observe(
                            STEP_HIST, time.perf_counter() - t_step)
                        if watchdog is not None:
                            watchdog.heartbeat()
                        consumed += 1
                        self.commit_step(decision.action in ("ok",
                                                             "backoff"))
                        if decision.action == "rollback":
                            rb_step, snap = self.guardian.rollback(
                                decision.trigger)
                            self.load_snapshot(snap)
                            self.step = rb_step
                            self.logger.log("guardian_rollback",
                                            step=self.step,
                                            trigger=decision.trigger)
                            continue
                        if decision.action == "skip":
                            continue
                        self.guardian.maybe_snapshot(self.step,
                                                     self.state_snapshot())
                    # The world's utterances: every data rank's rows.
                    utts += len(batch["feat_lens"]) * self.mesh.data
                    if profiler is not None and self.step >= profile_end:
                        self._stop_profile(profiler)
                        profiler, profile_done = None, True
                    if self.step % cfg.train.log_every == 0:
                        last = {k: float(v) for k, v in metrics.items()
                                if k in ("loss", "grad_norm")}
                        now = time.perf_counter()
                        rate = utts / (now - t_log)
                        # The world's rate and, as JAX logs it, a card's.
                        self.logger.log("train_step", step=self.step,
                                        epoch=epoch, lr=lr,
                                        utt_per_sec=rate,
                                        utt_per_sec_per_card=rate
                                        / self.world, **last)
                        if self.tb is not None:
                            self.tb.scalars(self.step, **last, lr=lr,
                                            utt_per_sec=rate)
                        t_log, utts = now, 0
                    if every and self.ckpt and self.step % every == 0:
                        self.save(epoch)
                    if self._preempt_requested():
                        # The grace window: persist this step with the
                        # current epoch, so a resume skips the consumed
                        # prefix and replays the rest in order.
                        if self.ckpt is not None:
                            self._wait_saved()
                            if self.ckpt.latest_step() != self.step:
                                self.save(epoch)
                            self._wait_saved()
                        self.logger.log("preempted", step=self.step,
                                        epoch=epoch)
                        preempted = True
                        break
                if preempted:
                    break
                if metrics and not last:
                    last = {k: float(v) for k, v in metrics.items()
                            if k in ("loss", "grad_norm")}
                self.logger.log("epoch_end", epoch=epoch,
                                seconds=time.perf_counter() - t_epoch)
                if self.eval_pipeline is not None:
                    ev = self.evaluate()
                    self.logger.log("eval", epoch=epoch, **ev)
                    if self.tb is not None:
                        self.tb.scalars(self.step, wer=ev["wer"],
                                        cer=ev["cer"])
                    last.update(ev)
                self.save(epoch + 1)
        finally:
            if watchdog is not None:
                watchdog.stop()
            if profiler is not None:
                self._stop_profile(profiler)
            if self.tb is not None:
                self.tb.close()
        if self.ckpt is not None:
            self._wait_saved()
        if preempted:
            last = dict(last, preempted=True)
        if self.guardian is not None:
            last = dict(last, guardian=self.guardian.report())
        return last

    def _preempt_requested(self) -> bool:
        """Whether any rank was asked to stop: every rank stops at the
        same step."""
        if self.preempt is None:
            return False
        asked = bool(self.preempt.requested())
        if self.world > 1:
            asked = bool(comm.host_all_reduce(
                [int(asked)], dist.group.WORLD, dist.ReduceOp.MAX)[0])
        return asked

    def _start_profile(self):
        """A ``torch.profiler`` window over the host and, on the card,
        the device (``train.profile_dir``)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._profile_from = self.step
        return prof

    def _stop_profile(self, prof) -> None:
        """Close the window and write its Chrome trace into
        ``train.profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = self.cfg.train.profile_dir
        os.makedirs(out, exist_ok=True)
        path = os.path.join(
            out, f"trace_steps{self._profile_from}-{self.step}.json")
        prof.export_chrome_trace(path)
        self.logger.log("profile_saved", dir=out, path=path, step=self.step)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from .config import apply_overrides, get_config, parse_cli_overrides
    from .data.manifest import load_manifest
    from .data.pipeline import DataPipeline
    from .data.synthetic import SyntheticPipeline
    from .data.tokenizer import resolve_tokenizer

    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.train")
    parser.add_argument("--config", default="ds2_small")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic utterances")
    parser.add_argument("--device", default=None,
                        help="'cuda' (default) or 'cpu'")
    args, extra = parser.parse_known_args(argv)
    cfg = apply_overrides(get_config(args.config),
                          parse_cli_overrides(extra))
    from .parallel import initialize_distributed

    # Under torchrun: join the group (and take this rank's card) before
    # anything touches a device. One process: no group.
    initialize_distributed(device=args.device)
    logger = PrintLogger()
    old_vocab = cfg.model.vocab_size
    if args.synthetic:
        tokenizer, cfg = resolve_tokenizer(cfg, synthetic=True)
        pipeline = SyntheticPipeline(cfg, args.synthetic)
        eval_pipe = pipeline
    else:
        if not cfg.data.train_manifest:
            raise SystemExit("need --data.train_manifest=PATH or "
                             "--synthetic=N")
        utts = load_manifest(cfg.data.train_manifest,
                             cfg.data.min_duration_s,
                             cfg.data.max_duration_s)
        tokenizer, cfg = resolve_tokenizer(cfg, utterances=utts,
                                           for_training=True)
        pipeline = DataPipeline(cfg, tokenizer, utterances=utts)
        eval_pipe = (DataPipeline(cfg, tokenizer, cfg.data.eval_manifest)
                     if cfg.data.eval_manifest else None)
    if cfg.model.vocab_size != old_vocab:
        logger.log("vocab_resize", preset=old_vocab,
                   tokenizer=cfg.model.vocab_size)
    from .resilience import PreemptionGuard

    # SIGTERM (a fleet's preemption) -> an emergency checkpoint and a
    # clean exit; the next run's maybe_restore resumes bit-identically.
    with PreemptionGuard() as guard:
        trainer = Trainer(cfg, pipeline, tokenizer, eval_pipe, logger,
                          device=args.device, preempt=guard)
        trainer.maybe_restore()
        result = trainer.fit()
    if trainer.primary:
        print(json.dumps({"event": "done", "steps": trainer.step,
                          **{k: v for k, v in result.items()
                             if isinstance(v, (int, float))}}))


if __name__ == "__main__":
    main()
