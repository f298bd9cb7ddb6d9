"""Training: forward, CTC, backward, clip, optimizer step; the epoch loop.

The port's counterpart of ``deepspeech_tpu/train.py`` on one card. A
step runs the model in train mode (batch statistics normalise and
update the running ones), the CTC loss through the kernels of
``ops/ctc.py``, the backward through ``ops/gru.py``'s ``gru_bwd`` (an
LSTM model's through ``ops/lstm.py``'s ``lstm_bwd``), then
the reference's optimizer chain (``train.py:69-95``): clip by global
norm exactly as optax does, then SGD with Nesterov momentum or AdamW,
with the warmup/anneal learning rate written into the optimizer every
step. Evaluation is greedy WER/CER.

What the JAX trainer has and this slice does not raises
``NotImplementedError`` naming the slice of the port that brings it:
checkpoints and manifests (slice 2b), multi-device meshes, ZeRO and
gradient accumulation (slice 5), the guarded step, sequence
parallelism, RNN-T, pipelining, tensorboard and profile traces
(slice 9).

CLI: ``python -m deepspeech_tpu_torch.train --config=dev_slice
--synthetic=N --train.checkpoint_dir= [--device=cpu]
[--section.key=value ...]``; it ends with a ``{"event": "done", ...}``
line. Weights start from a random init seeded by ``train.seed``.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from .bridge import from_flax, init_params
from .config import Config
from .data.tokenizer import CharTokenizer
from .decode.greedy import greedy_decode, ids_to_texts
from .device import resolve_device
from .infer import PrintLogger
from .metrics import char_errors, word_errors
from .models.ds2 import DeepSpeech2
from .ops.ctc import ctc_loss_mean

_CHECKPOINTS = ("slice 2b of the port (checkpoints and manifest data, "
                "ROADMAP queue 1 items 1, 4 and 6)")


def check_supported(cfg: Config) -> None:
    """Raise on what the JAX trainer has and this slice does not."""
    t = cfg.train
    if t.checkpoint_dir:
        raise NotImplementedError(
            f"train.checkpoint_dir={t.checkpoint_dir!r}: checkpoint.py "
            f"comes with {_CHECKPOINTS}; pass --train.checkpoint_dir= to "
            "train without checkpoints")
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
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


class Trainer:
    """Epoch loop over a pipeline's batches on one device, with greedy
    WER/CER evaluation.

    ``pipeline`` has the interface of ``data.SyntheticPipeline``
    (``peek``, ``epoch``, ``eval_epoch``, ``batches_per_epoch``).
    ``logger.log(event, **fields)`` receives ``train_step``,
    ``epoch_end`` and ``eval`` events. ``device`` None means the card
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

    def train_step(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """One step on a host batch: forward in train mode, mean CTC,
        backward, global norm, clip, optimizer step at this step's rate.
        Returns ``{"loss", "grad_norm"}`` as device scalars."""
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
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.train.epochs
        last: Dict[str, float] = {}
        metrics: Dict[str, torch.Tensor] = {}
        for epoch in range(epochs):
            t_epoch = time.perf_counter()
            t_log, utts = time.perf_counter(), 0
            for batch in self.pipeline.epoch(epoch):
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
            if not last:
                last = {k: float(v) for k, v in metrics.items()}
            self.logger.log("epoch_end", epoch=epoch,
                            seconds=time.perf_counter() - t_epoch)
            if self.eval_pipeline is not None:
                ev = self.evaluate()
                self.logger.log("eval", epoch=epoch, **ev)
                last.update(ev)
        return last


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from .config import apply_overrides, get_config, parse_cli_overrides
    from .data.synthetic import SyntheticPipeline
    from .data.tokenizer import get_tokenizer

    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.train")
    parser.add_argument("--config", default="ds2_small")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic utterances")
    parser.add_argument("--device", default=None,
                        help="'cuda' (default) or 'cpu'")
    args, extra = parser.parse_known_args(argv)
    cfg = apply_overrides(get_config(args.config),
                          parse_cli_overrides(extra))
    if not args.synthetic:
        raise NotImplementedError(
            f"training on a manifest comes with {_CHECKPOINTS}; use "
            "--synthetic=N")
    tokenizer = get_tokenizer(cfg.data.language, cfg.data.vocab_path)
    pipeline = SyntheticPipeline(cfg, args.synthetic)
    logger = PrintLogger()
    trainer = Trainer(cfg, pipeline, tokenizer, pipeline, logger,
                      device=args.device)
    result = trainer.fit()
    print(json.dumps({"event": "done", "steps": trainer.step, **result}))


if __name__ == "__main__":
    main()
