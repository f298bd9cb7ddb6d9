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

What the JAX trainer has and this slice does not raises
``NotImplementedError`` naming the slice of the port that brings it:
multi-device meshes, ZeRO and gradient accumulation (slice 5), the
guarded step, sequence parallelism, RNN-T, pipelining, tensorboard and
profile traces (slice 9).

CLI: ``python -m deepspeech_tpu_torch.train --config=dev_slice
[--synthetic=N] [--device=cpu] [--section.key=value ...]``: it trains
on ``data.train_manifest`` (or N synthetic utterances), evaluates on
``data.eval_manifest``, restores ``train.checkpoint_dir``'s newest step
first, and ends with a ``{"event": "done", ...}`` line. A fresh run's
weights are a random init seeded by ``train.seed``.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

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


def check_supported(cfg: Config) -> None:
    """Raise on what the JAX trainer has and this slice does not."""
    t = cfg.train
    later = [
        (t.guardian, "train.guardian: the guarded train step comes with "
                     "slice 9 of the port"),
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
        (bool(t.tensorboard_dir), "train.tensorboard_dir: tensorboard "
                                  "scalars come with slice 9 of the port"),
        (bool(t.profile_dir), "train.profile_dir: profile traces come with "
                              "slice 9 of the port"),
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
    ``bridge.init_params`` seeded by ``train.seed``.
    """

    def __init__(self, cfg: Config, pipeline, tokenizer: CharTokenizer,
                 eval_pipeline=None, logger=None, device=None,
                 params=None, batch_stats=None):
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
        self.ckpt = None
        if cfg.train.checkpoint_dir:
            from .checkpoint import CheckpointManager

            self.ckpt = CheckpointManager(cfg.train.checkpoint_dir,
                                          keep=cfg.train.keep_checkpoints)

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
        ``{"loss", "grad_norm"}`` as device scalars."""
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
        sampler's order is a pure function of (seed, epoch)."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.train.epochs
        every = cfg.train.checkpoint_every_steps
        last: Dict[str, float] = {}
        metrics: Dict[str, torch.Tensor] = {}
        steps_before = sum(self.pipeline.batches_per_epoch(e)
                           for e in range(self.start_epoch))
        skip = max(self.step - steps_before, 0)
        for epoch in range(self.start_epoch, epochs):
            t_epoch = time.perf_counter()
            t_log, utts = time.perf_counter(), 0
            batches = self.pipeline.epoch(epoch, start=skip)
            skip = 0
            for batch in device_prefetch(batches, self.device):
                lr = self.lr_schedule(self.step)
                metrics = self.train_step(batch)
                utts += len(batch["feat_lens"])
                if self.step % cfg.train.log_every == 0:
                    last = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    self.logger.log("train_step", step=self.step,
                                    epoch=epoch, lr=lr,
                                    utt_per_sec=utts / (now - t_log),
                                    **last)
                    t_log, utts = now, 0
                if every and self.ckpt and self.step % every == 0:
                    self.save(epoch)
            if metrics and not last:
                last = {k: float(v) for k, v in metrics.items()}
            self.logger.log("epoch_end", epoch=epoch,
                            seconds=time.perf_counter() - t_epoch)
            if self.eval_pipeline is not None:
                ev = self.evaluate()
                self.logger.log("eval", epoch=epoch, **ev)
                last.update(ev)
            self.save(epoch + 1)
        if self.ckpt is not None:
            self.ckpt.wait()
        return last


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
    trainer = Trainer(cfg, pipeline, tokenizer, eval_pipe, logger,
                      device=args.device)
    trainer.maybe_restore()
    result = trainer.fit()
    print(json.dumps({"event": "done", "steps": trainer.step,
                      **{k: v for k, v in result.items()
                         if isinstance(v, (int, float))}}))


if __name__ == "__main__":
    main()
