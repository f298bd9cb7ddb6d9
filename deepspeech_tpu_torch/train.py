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

What the JAX trainer has and this slice does not raises
``NotImplementedError`` naming the slice of the port that brings it:
multi-device meshes, ZeRO and gradient accumulation (slice 5), sequence
parallelism, RNN-T and pipelining (slice 9).

CLI: ``python -m deepspeech_tpu_torch.train --config=dev_slice
[--synthetic=N] [--device=cpu] [--section.key=value ...]``: it trains
on ``data.train_manifest`` (or N synthetic utterances), evaluates on
``data.eval_manifest``, restores ``train.checkpoint_dir``'s newest step
first, and ends with a ``{"event": "done", ...}`` line. A fresh run's
weights are a random init seeded by ``train.seed``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from . import obs
from .bridge import from_flax, init_params, to_flax
from .config import Config
from .data.pipeline import device_prefetch
from .data.tokenizer import CharTokenizer
from .decode.greedy import greedy_decode, ids_to_texts
from .device import resolve_device
from .infer import PrintLogger
from .metrics import char_errors, word_errors
from .models.ds2 import DeepSpeech2
from .ops.ctc import ctc_loss_mean
from .resilience import faults
from .resilience.guardian import STEP_HIST, GuardianConfig


def check_supported(cfg: Config) -> None:
    """Raise on what the JAX trainer has and this slice does not."""
    t = cfg.train
    later = [
        (t.accum_steps > 1, "train.accum_steps > 1: gradient accumulation "
                            "comes with slice 5 of the port"),
        (len(t.mesh_shape) != 2 or any(n > 1 for n in t.mesh_shape),
         f"train.mesh_shape={t.mesh_shape}: meshes of more than one device "
         "come with slice 5 of the port"),
        (t.zero_opt_sharding, "train.zero_opt_sharding: ZeRO comes with "
                              "slice 5 of the port"),
        (t.sequence_parallel, "train.sequence_parallel comes with slice 9 "
                              "of the port"),
        (t.objective == "rnnt", "train.objective='rnnt' comes with slice 9 "
                                "of the port"),
        (cfg.model.pipeline_stages > 1, "model.pipeline_stages > 1 comes "
                                        "with slice 9 of the port"),
    ]
    for cond, msg in later:
        if cond:
            raise NotImplementedError(msg)
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
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """Scale ``grads`` in place as ``optax.clip_by_global_norm`` does:
    ``g / norm * max_norm`` when ``norm >= max_norm``, unchanged below
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). Returns the
    global norm before clipping, on the device (no host sync)."""
    norm = torch.sqrt(torch.stack([g.float().square().sum()
                                   for g in grads]).sum())
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


class Trainer:
    """Epoch loop over a pipeline's batches on one device, with greedy
    WER/CER evaluation and, with ``train.checkpoint_dir`` set,
    checkpoints and resume.

    ``pipeline`` has the interface of ``data.DataPipeline`` (``peek``,
    ``epoch(e, start)``, ``eval_epoch``, ``batches_per_epoch``; as
    ``data.SyntheticPipeline`` has too). ``logger.log(event, **fields)``
    receives ``train_step``, ``epoch_end``, ``eval`` and ``restore``
    events, and a pipeline without a logger of its own gets this one for
    its ``corrupt_sample`` events. ``device`` None means the card
    (raises without CUDA); "cpu" runs the plain versions. ``params`` /
    ``batch_stats`` (flax-layout trees) default to
    ``bridge.init_params`` seeded by ``train.seed``. ``preempt`` (a
    :class:`~.resilience.preempt.PreemptionGuard`) is polled once a step
    by ``fit``.
    """

    def __init__(self, cfg: Config, pipeline, tokenizer: CharTokenizer,
                 eval_pipeline=None, logger=None, device=None,
                 params=None, batch_stats=None, preempt=None):
        check_supported(cfg)
        self.cfg = cfg
        self.pipeline = pipeline
        self.eval_pipeline = eval_pipeline
        self.tokenizer = tokenizer
        self.logger = logger or PrintLogger()
        for pipe in (pipeline, eval_pipeline):
            if pipe is not None and getattr(pipe, "logger", 0) is None:
                pipe.logger = self.logger
        self.device = resolve_device(device)
        self.steps_per_epoch = max(pipeline.batches_per_epoch(1), 1)
        self.lr_schedule = make_lr_schedule(cfg, self.steps_per_epoch)
        if params is None:
            params, batch_stats = init_params(
                cfg, torch.Generator().manual_seed(cfg.train.seed))
        self.model = DeepSpeech2(cfg.model, cfg.features.num_features)
        self.model.load_state_dict(from_flax(params, batch_stats or {}))
        self.model.to(self.device)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.step = 0
        self.start_epoch = 0
        self.preempt = preempt
        self.tb = None
        if cfg.train.tensorboard_dir:
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
                                if self.guardian_cfg else 2))
        self.guardian = None
        if self.guardian_cfg is not None:
            from .resilience.guardian import TrainingGuardian

            self.guardian = TrainingGuardian(self.guardian_cfg,
                                             ckpt=self.ckpt)
        # The guarded step's host-side undo, settled by commit_step.
        self._pending = None

    def maybe_restore(self) -> None:
        """Restore the newest intact step of ``train.checkpoint_dir``:
        parameters, BN statistics, optimizer state, step and epoch."""
        if self.ckpt is None:
            return
        restored = self.ckpt.restore()
        if restored is None:
            return
        self.model.load_state_dict(from_flax(restored["params"],
                                             restored["batch_stats"]))
        if restored["opt_state"] is not None:
            self.optimizer.load_state_dict(restored["opt_state"])
        self.step = restored["step"]
        self.start_epoch = restored["epoch"]
        self.logger.log("restore", step=self.step, epoch=self.start_epoch)

    def save(self, epoch: int) -> None:
        """Checkpoint the current step with ``epoch``, the epoch a
        resume starts in. The state is on the host when this returns."""
        if self.ckpt is None:
            return
        params, batch_stats = to_flax(self.model.state_dict())
        self.ckpt.save(self.step, {
            "params": params, "batch_stats": batch_stats,
            "opt_state": self.optimizer.state_dict(), "epoch": epoch,
            "config": self.cfg.name})

    def train_step(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """One step on a batch (host arrays, or tensors on the device):
        forward in train mode, mean CTC, backward, global norm, clip,
        optimizer step at this step's rate. Returns
        ``{"loss", "grad_norm"}`` as device scalars.

        With the guardian on this is the guarded step
        (:meth:`guarded_step` at the guardian's ``lr_scale``), and the
        caller settles it with :meth:`commit_step`."""
        if self.guardian is not None:
            return self.guarded_step(batch, self.guardian.lr_scale)
        dev = to_device(batch, self.device)
        self.model.train()
        logits, lens = self.model(dev["features"], dev["feat_lens"])
        loss = ctc_loss_mean(logits, dev["labels"], lens, dev["label_lens"])
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        grad_norm = clip_by_global_norm(grads, self.cfg.train.grad_clip_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    def guarded_step(self, batch: Dict[str, np.ndarray], lr_scale: float
                     ) -> Dict[str, torch.Tensor]:
        """The step of :meth:`train_step` at ``lr_scale`` times the
        scheduled rate, gated on the device.

        Every tensor the step writes in place (parameters, BN buffers,
        the optimizer's state tensors on the device) is kept as it was
        on the device; after the step each is written back as
        ``torch.where(ok, new, old)``, ``ok`` being a finite loss,
        gradient norm and update norm: no host sync. The update norm is
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
        dev = to_device(batch, self.device)
        params = list(self.model.parameters())
        buffers = list(self.model.buffers())
        state = self.optimizer.state
        with torch.no_grad():
            old_params = [p.detach().clone() for p in params]
            old_buffers = [b.clone() for b in buffers]
            old_state = {p: {k: v.clone() for k, v in state[p].items()
                             if torch.is_tensor(v)}
                         for p in params if state.get(p)}
        self.model.train()
        logits, lens = self.model(dev["features"], dev["feat_lens"])
        loss = ctc_loss_mean(logits, dev["labels"], lens, dev["label_lens"])
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = clip_by_global_norm(grads, self.cfg.train.grad_clip_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.step) * lr_scale
        self.optimizer.step()
        host: List = []
        fresh = [p for p in params if state.get(p) and p not in old_state]
        with torch.no_grad():
            update_norm = torch.sqrt(torch.stack(
                [(p - o).float().square().sum()
                 for p, o in zip(params, old_params)]).sum()) / lr_scale
            ok = (torch.isfinite(loss.detach()) & torch.isfinite(grad_norm)
                  & torch.isfinite(update_norm))
            for t, old in zip(params + buffers, old_params + old_buffers):
                t.copy_(torch.where(ok, t, old))
            for p in params:
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
        return {"loss": loss.detach(), "grad_norm": grad_norm,
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
        werr = wtot = cerr = ctot = n = 0
        for batch, n_valid in pipe.eval_epoch():
            dev = to_device(batch, self.device)
            logits, lens = self.model(dev["features"], dev["feat_lens"])
            ids, out_lens = greedy_decode(logits, lens)
            hyps = ids_to_texts(ids, out_lens, self.tokenizer)
            for g in range(n_valid):
                ref = self.tokenizer.decode(
                    batch["labels"][g][:batch["label_lens"][g]])
                we, wn = word_errors(ref, hyps[g])
                ce, cn = char_errors(ref, hyps[g])
                werr, wtot, cerr, ctot, n = (werr + we, wtot + wn,
                                             cerr + ce, ctot + cn, n + 1)
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
                batches = self.pipeline.epoch(epoch, start=skip)
                skip = 0
                for batch in device_prefetch(batches, self.device):
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
                        batch = dict(batch, features=batch["features"]
                                     * float("nan"))
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
                    utts += len(batch["feat_lens"])
                    if profiler is not None and self.step >= profile_end:
                        self._stop_profile(profiler)
                        profiler, profile_done = None, True
                    if self.step % cfg.train.log_every == 0:
                        last = {k: float(v) for k, v in metrics.items()
                                if k in ("loss", "grad_norm")}
                        now = time.perf_counter()
                        rate = utts / (now - t_log)
                        self.logger.log("train_step", step=self.step,
                                        epoch=epoch, lr=lr,
                                        utt_per_sec=rate, **last)
                        if self.tb is not None:
                            self.tb.scalars(self.step, **last, lr=lr,
                                            utt_per_sec=rate)
                        t_log, utts = now, 0
                    if every and self.ckpt and self.step % every == 0:
                        self.save(epoch)
                    if self.preempt is not None and self.preempt.requested():
                        # The grace window: persist this step with the
                        # current epoch, so a resume skips the consumed
                        # prefix and replays the rest in order.
                        if self.ckpt is not None:
                            self.ckpt.wait()
                            if self.ckpt.latest_step() != self.step:
                                self.save(epoch)
                            self.ckpt.wait()
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
            self.ckpt.wait()
        if preempted:
            last = dict(last, preempted=True)
        if self.guardian is not None:
            last = dict(last, guardian=self.guardian.report())
        return last

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
    print(json.dumps({"event": "done", "steps": trainer.step,
                      **{k: v for k, v in result.items()
                         if isinstance(v, (int, float))}}))


if __name__ == "__main__":
    main()
