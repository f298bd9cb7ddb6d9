"""Inference entry point: forward -> log-softmax -> greedy CTC decode.

The port's counterpart of ``deepspeech_tpu/infer.py`` for greedy
decoding: ``Inferencer.decode_batch`` / ``decode_batch_bucketed`` over
the ``(B, T)`` ladder (data/infer_bucket.py), for a GRU or an LSTM
model (``model.rnn_type``), with the attribute names
(``_last_nbest``, ``_last_times``) the serving plane reads. Beam search,
LM fusion, streaming, sequence-parallel and transducer decoding and
timestamps raise ``NotImplementedError`` naming the slice of the port
that brings them.

Weights: ``Inferencer(params=None)`` restores ``train.checkpoint_dir``
through ``restore_params``, which reads the port's own checkpoints
(checkpoint.py) and, where ``tensorstore`` is installed, a directory
the JAX package's orbax manager wrote (checkpoint_import.py).

``quantize="int8"`` serves weight-only int8 weights, as the JAX
package's ``Inferencer(quantize="int8")`` does (infer.py:155-253): PTQ
runs once at init (``utils/quantize.py``), the model holds the quantized
leaves int8 on the device and its recurrent layers run ``ops/gru.py``'s
``gru_fwd_q`` (GRU) or ``ops/lstm.py``'s ``lstm_fwd_q`` (LSTM);
``kernel_regime`` names the kernel that holds W.

CLI: ``python -m deepspeech_tpu_torch.infer --config=ds2_small
[--checkpoint-dir=DIR] [--manifest=M] [--vocab=V] [--average-last=K]
[--params=x.npz] [--synthetic=N [--seed=0]] [--device=cpu]
[--quantize-weights=int8] [--section.key=value ...]``, e.g.
``--model.rnn_type=lstm`` for the LSTM variant of a preset. It decodes
``--manifest`` (default ``data.eval_manifest``), or N synthetic
utterances, with the weights of ``--params``, else of the checkpoint
directory (the newest step, or the mean of the last K); with
``--synthetic`` and neither, a random init from ``--seed``
(bridge.init_params).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .bridge import from_flax
from .config import Config
from .data.infer_bucket import (ladder_shapes, plan_infer_buckets,
                                slice_to_plan, unbucket)
from .data.tokenizer import CharTokenizer
from .decode.greedy import greedy_decode, ids_to_texts
from .device import resolve_device
from .metrics import cer, wer
from .models.ds2 import DeepSpeech2
from .ops.gru import card_limits
from .utils.quantize import (kernel_regime, quantization_error,
                             quantize_params)

_log = logging.getLogger(__name__)

# The decode modes whose forward dequantizes the quantized tree
# (infer.py:159-161); streaming runs its own PTQ (slice 3).
_OFFLINE_MODES = ("greedy", "beam", "beam_fused", "beam_fused_device",
                  "rnnt_greedy", "rnnt_beam")

_LATER = {
    "beam": "slice 6 (beam search and LM)",
    "beam_fused": "slice 6 (beam search and LM)",
    "beam_fused_device": "slice 6 (beam search and LM)",
    "streaming": "slice 3 (streaming)",
    "sp_greedy": "slice 9 (sequence parallelism)",
    "sp_beam": "slice 9 (sequence parallelism)",
    "rnnt_greedy": "slice 9 (RNN-T)",
    "rnnt_beam": "slice 9 (RNN-T)",
}


def restore_params(checkpoint_dir: str, average_last: int = 0
                   ) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)`` of the newest training step in
    ``checkpoint_dir`` (flax-layout numpy trees); ``average_last`` > 1
    averages the params of that many newest steps. Reads the port's own
    checkpoints, or a JAX orbax directory through
    ``checkpoint_import`` (which raises ``ImportError`` naming its
    converter where ``tensorstore`` is missing)."""
    from .checkpoint import CheckpointManager, average_checkpoints, \
        average_params
    from .checkpoint_import import (import_orbax_step, is_orbax_dir,
                                    orbax_steps)

    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(
            f"no checkpoint found in {checkpoint_dir!r}")
    if is_orbax_dir(checkpoint_dir):
        if average_last > 1:
            return average_params(
                import_orbax_step(checkpoint_dir, s)[:2]
                for s in orbax_steps(checkpoint_dir)[-average_last:])
        return import_orbax_step(checkpoint_dir)[:2]
    if average_last > 1:
        return average_checkpoints(checkpoint_dir, average_last)
    raw = CheckpointManager(checkpoint_dir).restore()
    if raw is None:
        raise FileNotFoundError(
            f"no checkpoint found in {checkpoint_dir!r}")
    return raw["params"], raw["batch_stats"]


class Inferencer:
    """Batched greedy decoding with given or restored weights.

    ``params`` / ``batch_stats`` are flax-layout trees of numpy arrays
    (the JAX package's, or ``bridge.init_params`` / ``bridge.load_npz``);
    ``params=None`` restores them from ``cfg.train.checkpoint_dir``
    (``restore_params``).
    ``device`` None means the card (raises without CUDA); pass "cpu" to
    run the plain versions on the CPU. ``quantize="int8"`` quantizes
    ``params`` once here (``quantize_calls``, ``quantize_report``) and
    serves the int8 model; ``kernel_regime`` is "resident-q",
    "blocked-q" or "fp".
    """

    def __init__(self, cfg: Config, tokenizer: CharTokenizer,
                 params=None, batch_stats=None, device=None,
                 quantize: str = ""):
        mode = cfg.decode.mode
        if quantize and quantize != "int8":
            raise ValueError(f"quantize={quantize!r}; only 'int8'")
        if quantize and mode != "streaming" and mode not in _OFFLINE_MODES:
            raise ValueError(
                f"--quantize-weights is for the offline decode modes "
                f"{_OFFLINE_MODES} and streaming; {mode!r} threads "
                f"full-precision params")
        if mode != "greedy":
            if mode not in _LATER:
                raise ValueError(f"unknown decode mode {mode!r}")
            raise NotImplementedError(
                f"decode.mode={mode!r} comes with {_LATER[mode]} of the "
                "port")
        if cfg.decode.lm_path:
            raise NotImplementedError(
                "LM fusion/rescoring comes with slice 6 of the port")
        if cfg.decode.timestamps:
            raise NotImplementedError(
                "greedy timestamps come with slice 3 of the port")
        if params is None:
            params, batch_stats = restore_params(cfg.train.checkpoint_dir)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.quantize_calls = 0
        self.quantize_report = None
        if quantize:
            qtree, report = quantize_params(params)
            _log.info(
                "int8 weight-only PTQ: %d leaves quantized, %d kept, "
                "%.1f MB -> %.1f MB, max rel err %.4f",
                report["quantized"], report["kept"],
                report["bytes_before"] / 1e6, report["bytes_after"] / 1e6,
                quantization_error(params, qtree))
            params = qtree
            self.quantize_calls += 1
            self.quantize_report = report
        self.model = DeepSpeech2(cfg.model, cfg.features.num_features,
                                 quantized=bool(quantize))
        self.model.load_state_dict(from_flax(params, batch_stats or {}))
        self.model.to(self.device).eval()
        card = card_limits(self.device) if self.device.type == "cuda" else ()
        self.kernel_regime = kernel_regime(cfg.model, bool(quantize),
                                           card=card)
        self._last_nbest = None  # beam modes would stash [(text, score)]
        self._last_times = None  # timestamp mode would stash spans

    def forward(self, features, feat_lens
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """features [B, T, F], feat_lens [B] (numpy or tensors) ->
        (log-probs [B, T', V] f32, out lens [B]) on the device."""
        feats = torch.as_tensor(np.asarray(features, np.float32))
        lens = torch.as_tensor(np.asarray(feat_lens, np.int64))
        with torch.inference_mode():
            logits, out_lens = self.model(feats.to(self.device),
                                          lens.to(self.device))
            return torch.log_softmax(logits, dim=-1), out_lens

    def decode_batch(self, batch: Dict[str, np.ndarray]) -> List[str]:
        lp, lens = self.forward(batch["features"], batch["feat_lens"])
        with torch.inference_mode():
            ids, out_lens = greedy_decode(lp, lens)
        return ids_to_texts(ids, out_lens, self.tokenizer)

    def decode_batch_bucketed(self, batch: Dict[str, np.ndarray],
                              plans=None) -> List[str]:
        """Ladder-bucketed decode of one mixed-length host batch: plan
        the rows onto the ``(B, T)`` ladder, decode each plan's sub-batch
        through ``decode_batch``, and return texts in request order.
        ``plans`` lets a caller that already shaped the batch skip the
        planner."""
        lens = np.asarray(batch["feat_lens"])
        if plans is None:
            plans = plan_infer_buckets(lens, self.cfg.data.bucket_frames,
                                       self.cfg.data.batch_size)
        texts = [self.decode_batch(slice_to_plan(batch, plan))
                 for plan in plans]
        self._last_nbest = None
        self._last_times = None
        return unbucket(plans, texts)

    def ladder(self) -> List[tuple]:
        """This engine's full ``(B, T)`` rung ladder."""
        return ladder_shapes(self.cfg.data.bucket_frames,
                             self.cfg.data.batch_size)

    def run(self, batches: Iterable[Tuple[Dict, int]], logger=None,
            refs_of=None) -> Dict[str, float]:
        """Decode ``(batch, n_valid)`` pairs; report WER/CER vs labels.

        ``logger.log(event, **fields)``, when given, receives one "utt"
        event per utterance and the "infer_summary". ``refs_of(batch,
        n_valid)`` may override the reference transcripts, which by
        default come from the padded label ids.
        """
        refs: List[str] = []
        hyps: List[str] = []
        for batch, n_valid in batches:
            texts = self.decode_batch(batch)[:n_valid]
            if refs_of is not None:
                batch_refs = refs_of(batch, n_valid)
            else:
                batch_refs = [
                    self.tokenizer.decode(row[:n]) for row, n in
                    list(zip(batch["labels"], batch["label_lens"]))[:n_valid]]
            if logger is not None:
                for r, h in zip(batch_refs, texts):
                    logger.log("utt", ref=r, hyp=h)
            refs.extend(batch_refs)
            hyps.extend(texts)
        summary = {"wer": wer(refs, hyps), "cer": cer(refs, hyps),
                   "n_utts": len(refs)}
        if logger is not None:
            logger.log("infer_summary", **summary)
        return summary


class PrintLogger:
    """One JSON object per line on stdout."""

    def log(self, event: str, **fields) -> None:
        print(json.dumps({"event": event, **fields}), flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from .bridge import init_params, load_npz
    from .config import apply_overrides, get_config, parse_cli_overrides
    from .data.manifest import load_manifest
    from .data.pipeline import DataPipeline
    from .data.synthetic import SyntheticPipeline
    from .data.tokenizer import resolve_tokenizer

    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.infer")
    parser.add_argument("--config", default="ds2_small")
    parser.add_argument("--checkpoint-dir", default="",
                        help="default: train.checkpoint_dir")
    parser.add_argument("--manifest", default="",
                        help="eval manifest (default: data.eval_manifest)")
    parser.add_argument("--vocab", default="", help="tokenizer vocab file")
    parser.add_argument("--average-last", type=int, default=0,
                        help="average the params of the last K saved "
                             "steps; 0/1 = the newest only")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="decode N synthetic utterances")
    parser.add_argument("--params", default="",
                        help=".npz from bridge.save_npz (or a checkpoint "
                             "step's params.npz); overrides the "
                             "checkpoint directory")
    parser.add_argument("--seed", type=int, default=0,
                        help="with --synthetic and no weights: the seed "
                             "of a random init")
    parser.add_argument("--device", default=None,
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--quantize-weights", default="",
                        choices=["", "int8"],
                        help="weight-only post-training quantization: "
                             "int8 weights with per-output-channel scales, "
                             "quantized once at engine init")
    args, extra = parser.parse_known_args(argv)
    cfg = apply_overrides(get_config(args.config),
                          parse_cli_overrides(extra))
    if args.checkpoint_dir:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=args.checkpoint_dir))
    if args.synthetic:
        tokenizer, cfg = resolve_tokenizer(cfg, synthetic=True,
                                           vocab_override=args.vocab)
        batches = SyntheticPipeline(cfg, args.synthetic).eval_epoch()
    else:
        manifest = args.manifest or cfg.data.eval_manifest
        if not manifest:
            raise SystemExit("need --manifest, --synthetic, or "
                             "data.eval_manifest")
        utts = load_manifest(manifest, cfg.data.min_duration_s,
                             cfg.data.max_duration_s)
        # A zh vocabulary comes from an explicit file or the training
        # run's <checkpoint_dir>/vocab.txt, never from eval transcripts.
        tokenizer, cfg = resolve_tokenizer(cfg, utterances=utts,
                                           vocab_override=args.vocab)
        batches = DataPipeline(cfg, tokenizer, utterances=utts).eval_epoch()
    if args.params:
        params, batch_stats = load_npz(args.params)
    elif args.synthetic and not args.checkpoint_dir:
        params, batch_stats = init_params(
            cfg, torch.Generator().manual_seed(args.seed))
    else:
        params, batch_stats = restore_params(cfg.train.checkpoint_dir,
                                             args.average_last)
    inf = Inferencer(cfg, tokenizer, params, batch_stats, device=args.device,
                     quantize=args.quantize_weights)
    summary = inf.run(batches, PrintLogger())
    print(json.dumps({"event": "done", **summary}))


if __name__ == "__main__":
    main()
