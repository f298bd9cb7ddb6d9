"""Inference entry point: forward -> log-softmax -> CTC decode.

The port's counterpart of ``deepspeech_tpu/infer.py``:
``Inferencer.decode_batch`` / ``decode_batch_bucketed`` over the
``(B, T)`` ladder (data/infer_bucket.py), for a GRU or an LSTM model
(``model.rnn_type``), with the attribute names (``_last_nbest``,
``_last_times``, ``_last_word_times``) the serving plane reads. The
decode modes:

- ``greedy``; ``streaming`` through the chunked engine (streaming.py);
  ``decode.timestamps`` stashes each symbol's argmax-alignment span in
  these two;
- ``beam``: the on-device prefix beam search (decode/beam.py) on the
  log-probs where the forward left them; with ``decode.lm_path`` the
  n-best is rescored on the host (``rescore_nbest``);
- ``beam_fused_device``: the same search with the LM fused on the device
  through a dense or hashed fusion table (``decode.device_lm_impl``);
- ``beam_fused``: the log-probs copied to the host and searched there
  with word-LM shallow fusion, by the C++ decoder (``csrc/host``,
  ``native.py``) or the Python one (``decode/beam_host.py``), as
  ``decode.host_impl`` says ("native" raises if the C++ library does
  not build or load; "auto" takes it where it does).

Sequence-parallel and transducer decoding raise ``NotImplementedError``
naming the slice of the port that brings them.

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
``--model.rnn_type=lstm`` for the LSTM variant of a preset, or
``--config=ds2_beam_lm --decode.lm_path=lm.arpa`` for beam search with
n-best LM rescoring (``--decode.mode=beam_fused_device`` fuses it on
the device). With ``decode.nbest`` > 1 each ``utt`` line of a beam mode
carries its ``nbest`` list. It decodes
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
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import native, obs
from .bridge import from_flax
from .config import Config
from .data.infer_bucket import (ladder_shapes, plan_infer_buckets,
                                slice_to_plan, unbucket)
from .data.tokenizer import CharTokenizer
from .data.pipeline import device_prefetch
from .decode.beam import beam_search
from .decode.beam_host import prefix_beam_search_host
from .decode.greedy import (collapse_ids, collapse_ids_with_times,
                            greedy_decode, ids_to_texts)
from .decode.ngram import load_lm, rescore_nbest
from .device import resolve_device
from .metrics import cer, wer
from .models.ds2 import DeepSpeech2
from .ops.gru import card_limits
from .streaming import StreamingTranscriber
from .utils.cache import ShapeBucketCache
from .utils.quantize import (kernel_regime, quantization_error,
                             quantize_params)

_log = logging.getLogger(__name__)

# The decode modes whose forward dequantizes the quantized tree
# (infer.py:159-161); streaming runs its own PTQ (streaming.py).
_OFFLINE_MODES = ("greedy", "beam", "beam_fused", "beam_fused_device",
                  "rnnt_greedy", "rnnt_beam")

_BEAM_MODES = ("beam", "beam_fused", "beam_fused_device")

_LATER = {
    "sp_greedy": "slice 9 (sequence parallelism)",
    "sp_beam": "slice 9 (sequence parallelism)",
    "rnnt_greedy": "slice 9 (RNN-T)",
    "rnnt_beam": "slice 9 (RNN-T)",
}


def _words_from_char_times(spans):
    """[[char, s, e]] -> [[word, s, e]]: split on space chars, word
    span = first char's start to last char's end."""
    words, cur = [], None
    for ch, s, e in spans:
        if ch == " ":
            if cur:
                words.append(cur)
            cur = None
            continue
        if cur is None:
            cur = [ch, s, e]
        else:
            cur[0] += ch
            cur[2] = e
    if cur:
        words.append(cur)
    return words


def _valid_frames(lens, t: int) -> int:
    """Real frames of a batch clipped to its T rung, for the rung
    ledger. ``run`` hands ``decode_batch`` its prefetched CUDA tensors,
    whose sum is read back (one [B] copy)."""
    if isinstance(lens, torch.Tensor):
        return int(lens.clamp(max=t).sum())
    return int(np.minimum(np.asarray(lens), t).sum())


def _tensor(x, dtype) -> torch.Tensor:
    """A tensor as given (a prefetched batch's), or one made from host
    data."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype))


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
    "blocked-q" or "fp". ``decode.mode="streaming"`` builds a
    ``StreamingTranscriber`` here, which runs the PTQ itself, and
    shares its model.
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
        if cfg.decode.timestamps and mode not in (
                "greedy", "streaming", "rnnt_greedy"):
            raise ValueError(
                "decode.timestamps needs a unique alignment (CTC argmax "
                "or the transducer's emission frames) — greedy/"
                "streaming/rnnt_greedy modes only; beam hypotheses "
                f"don't carry one ({mode!r})")
        if mode not in ("greedy", "streaming") + _BEAM_MODES:
            if mode not in _LATER:
                raise ValueError(f"unknown decode mode {mode!r}")
            raise NotImplementedError(
                f"decode.mode={mode!r} comes with {_LATER[mode]} of the "
                "port")
        if params is None:
            params, batch_stats = restore_params(cfg.train.checkpoint_dir)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.quantize_calls = 0
        self.quantize_report = None
        self._streamer = None
        if mode == "streaming":
            self._streamer = StreamingTranscriber(
                cfg, params, batch_stats, tokenizer,
                chunk_frames=cfg.decode.chunk_frames, quantize=quantize,
                device=self.device)
            self.model = self._streamer.model
            if quantize:
                self.quantize_calls += 1
                self.quantize_report = self._streamer.quantize_report
        elif quantize:
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
        if self._streamer is None:
            self.model = DeepSpeech2(cfg.model, cfg.features.num_features,
                                     quantized=bool(quantize))
            self.model.load_state_dict(from_flax(params, batch_stats or {}))
            self.model.to(self.device).eval()
        card = card_limits(self.device) if self.device.type == "cuda" else ()
        self.kernel_regime = kernel_regime(
            cfg.model, bool(quantize), streaming=mode == "streaming",
            card=card)
        self._last_nbest = None  # beam modes stash [(text, score)]
        self._last_times = None  # timestamp mode stashes char spans
        self._last_word_times = None  # word spans (spaced vocabularies)
        self._space_id = None
        # A space-less vocabulary (Mandarin) means a character LM:
        # fusion closes a "word" a character, and rescoring space-joins
        # the characters for the LM.
        self._to_lm_text = None
        if " " in getattr(tokenizer, "chars", []):
            self._space_id = tokenizer.chars.index(" ") + 1
        else:
            self._to_lm_text = lambda t: " ".join(t)
        self.lm = load_lm(cfg.decode.lm_path) if cfg.decode.lm_path else None
        # The C++ LM handle of the host fused decoder (None when the LM
        # came from another engine or the library is not there).
        self._native_lm = None
        if isinstance(self.lm, native.NativeNGram):
            self._native_lm = self.lm
        elif (cfg.decode.lm_path and mode == "beam_fused"
              and cfg.decode.host_impl != "python" and native.available()):
            try:
                self._native_lm = native.NativeNGram(cfg.decode.lm_path)
            except (ValueError, RuntimeError):
                self._native_lm = None
        self._device_lm = None  # the fusion table (dense/hashed), lazy
        # Rung ledger, bounded by the planner's (B, T) ladder: a rung's
        # first use (cuDNN/cuBLAS plans, allocator growth) is counted
        # as its compile, and the serving plane reads the counts, the
        # padding volume and the usage feedback (serving/replica.py).
        self.shape_cache = ShapeBucketCache(max_shapes=len(self.ladder()))

    def forward(self, features, feat_lens
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """features [B, T, F], feat_lens [B] (numpy or tensors) ->
        (log-probs [B, T', V] f32, out lens [B]) on the device."""
        feats = _tensor(features, np.float32).to(self.device)
        lens = _tensor(feat_lens, np.int64).to(self.device, torch.int64)
        with torch.inference_mode():
            logits, out_lens = self.model(feats, lens)
            return torch.log_softmax(logits, dim=-1), out_lens

    def decode_batch_nbest(self, batch: Dict[str, np.ndarray]
                           ) -> List[List[tuple]]:
        """Per-utterance n-best ``[(text, score)]`` lists, best first,
        ``decode.nbest`` deep. Beam modes return the beam scores
        (LM-rescored when an LM is loaded and not fused); greedy and
        streaming have one hypothesis, scored 0.0."""
        self._last_nbest = None
        texts = self.decode_batch(batch)
        if self._last_nbest is None:
            return [[(t, 0.0)] for t in texts]
        return self._last_nbest

    def decode_batch(self, batch: Dict[str, np.ndarray]) -> List[str]:
        if self._streamer is not None:
            return self._decode_streaming(batch)
        b, t = batch["features"].shape[:2]
        hit = self.shape_cache.note(b, t, _valid_frames(batch["feat_lens"],
                                                        t))
        with obs.span("infer.forward", rung=f"{b}x{t}", cached=hit):
            lp, lens = self.forward(batch["features"], batch["feat_lens"])
        mode = self.cfg.decode.mode
        with torch.inference_mode(), obs.span("infer.decode", mode=mode):
            if mode == "beam":
                return self._decode_beam(lp, lens)
            if mode == "beam_fused_device":
                return self._decode_beam(lp, lens, lm_table=self._lm_table())
            if mode == "beam_fused":
                return self._decode_beam_fused(lp, lens)
            if self.cfg.decode.timestamps:
                return self._greedy_with_times(torch.argmax(lp, -1), lens)
            ids, out_lens = greedy_decode(lp, lens)
        return ids_to_texts(ids, out_lens, self.tokenizer)

    # -- beam modes ------------------------------------------------------
    def _decode_beam(self, lp, lens, lm_table=None) -> List[str]:
        """The on-device search on ``lp`` where it lies; only the first
        ``decode.nbest`` finalized hypotheses cross to the host."""
        d = self.cfg.decode
        v = lp.shape[-1]
        prefixes, plens, scores = beam_search(
            lp, lens, beam_width=d.beam_width,
            prune_top_k=min(d.prune_top_k, v - 1),
            max_len=self.cfg.data.max_label_len, lm_table=lm_table,
            merge_impl=d.merge_impl)
        return self._nbest_texts(prefixes, plens, scores,
                                 lm_fused=lm_table is not None)

    def _nbest_lists(self, prefixes, plens, scores,
                     lm_fused: bool) -> List[List[tuple]]:
        """Per-utterance [(text, score)] lists, best first, ``nbest``
        deep. LM rescoring (an LM loaded and not already fused) reorders
        within the list."""
        d = self.cfg.decode
        n = min(d.nbest, prefixes.shape[1])
        prefixes = prefixes[:, :n].cpu().numpy()
        plens = plens[:, :n].cpu().numpy()
        scores = scores[:, :n].cpu().numpy()
        out = []
        for b in range(prefixes.shape[0]):
            nbest = [(self.tokenizer.decode(prefixes[b, k, :plens[b, k]]),
                      float(scores[b, k])) for k in range(n)
                     if scores[b, k] > -1e29]
            # With on-device fusion the scores hold the LM already;
            # rescoring would count it twice.
            if not lm_fused and self.lm is not None and nbest:
                nbest = rescore_nbest(nbest, self.lm, d.lm_alpha, d.lm_beta,
                                      to_lm_text=self._to_lm_text)
            out.append(nbest)
        self._last_nbest = out
        return out

    def _nbest_texts(self, prefixes, plens, scores,
                     lm_fused: bool) -> List[str]:
        return [nb[0][0] if nb else ""
                for nb in self._nbest_lists(prefixes, plens, scores,
                                            lm_fused)]

    def _lm_table(self):
        """The device fusion table, built once an Inferencer and moved to
        its device: a dense ``[V^k, V]`` tensor or a
        ``HashedFusionTable``, as ``decode.device_lm_impl`` says
        (``fusion_table_for`` picks under "auto"). The build walks the
        Python reader's n-gram dicts, so the LM must be ARPA text."""
        if self._device_lm is None:
            d = self.cfg.decode
            if not d.lm_path:
                raise ValueError("beam_fused_device needs decode.lm_path")
            from .decode.ngram import NGramLM, fusion_table_for

            self._device_lm = fusion_table_for(
                self.lm if isinstance(self.lm, NGramLM) else d.lm_path,
                lambda i: self.tokenizer.decode([i]),
                self.cfg.model.vocab_size, d.lm_alpha, d.lm_beta,
                context_size=d.device_lm_context,
                vocab_has_space=self._space_id is not None,
                impl=d.device_lm_impl).to(self.device)
        return self._device_lm

    def _decode_beam_fused(self, lp, lens) -> List[str]:
        """Host search with word-LM fusion: the log-probs cross to the
        host here, the C++ batch decoder or the Python one per
        ``decode.host_impl``."""
        d = self.cfg.decode
        lens = lens.cpu().numpy() if isinstance(lens, torch.Tensor) \
            else np.asarray(lens)
        lp = lp.float().cpu().numpy()
        if self._use_native_fused():
            res = native.beam_search_batch_native(
                lp, lens, beam_width=d.beam_width,
                prune_log_prob=d.prune_log_prob, lm=self._native_lm,
                lm_alpha=d.lm_alpha, lm_beta=d.lm_beta,
                space_id=self._space_id,
                id_to_char=lambda i: self.tokenizer.decode([i]),
                nbest=d.nbest)
            nbest = [[(self.tokenizer.decode(ids), float(score))
                      for ids, score in r[:d.nbest]] for r in res]
        else:
            lp64 = lp.astype(np.float64)
            nbest = []
            for b in range(lp64.shape[0]):
                beams = prefix_beam_search_host(
                    lp64[b, :lens[b]], beam_width=d.beam_width,
                    prune_log_prob=d.prune_log_prob,
                    lm=self.lm, lm_alpha=d.lm_alpha, lm_beta=d.lm_beta,
                    space_id=self._space_id,
                    id_to_char=lambda i: self.tokenizer.decode([i]))
                nbest.append([(self.tokenizer.decode(ids), float(score))
                              for ids, score in beams[:d.nbest]])
        # The scores hold the fused LM: no rescoring pass.
        self._last_nbest = nbest
        return [nb[0][0] if nb else "" for nb in nbest]

    def _use_native_fused(self) -> bool:
        """The C++ batch decoder for beam_fused (``decode.host_impl``):
        "python" never, "native" always (raising when the library or the
        LM cannot be had), "auto" where the library loads and the LM, if
        any, is the C++ engine's (a KenLM binary read through the kenlm
        package fuses in Python)."""
        impl = self.cfg.decode.host_impl
        if impl == "python":
            return False
        ok = native.available() and (
            self.lm is None or self._native_lm is not None)
        if impl == "native" and not ok:
            why = (native.build_error()
                   or "LM not loadable by the native engine")
            raise RuntimeError(f"decode.host_impl=native but: {why}")
        return ok

    def _decode_streaming(self, batch: Dict[str, np.ndarray]) -> List[str]:
        """Greedy decode through the chunked streaming engine, the live
        path over a dataset: it equals offline greedy for a streamable
        model (tests/test_torch_streaming.py)."""
        logits, lens = self._streamer.transcribe(batch["features"],
                                                 batch["feat_lens"])
        best = torch.argmax(torch.as_tensor(logits), dim=-1)
        lens = torch.as_tensor(lens)
        if self.cfg.decode.timestamps:
            return self._greedy_with_times(best, lens)
        return ids_to_texts(*collapse_ids(best, lens), self.tokenizer)

    def _greedy_with_times(self, best, lens) -> List[str]:
        """CTC-collapse with argmax-alignment character spans
        (decode.timestamps): stashes per-utt [[char, start_ms, end_ms]]
        and returns the texts."""
        ids, out_lens, start, end = (
            x.cpu().numpy() for x in collapse_ids_with_times(best, lens))
        texts = ids_to_texts(ids, out_lens, self.tokenizer)
        self._stash_char_times([
            [(ids[b, k], int(start[b, k]), int(end[b, k]) + 1)
             for k in range(out_lens[b])]
            for b in range(ids.shape[0])])
        return texts

    def _stash_char_times(self, per_utt) -> None:
        """``per_utt`` holds [(symbol_id, start_frame, end_frame_excl)]
        lists in post-conv frames; one post-conv frame is time_stride
        raw frames of stride_ms. Labels decode per symbol. Word spans
        aggregate on spaces for a spaced vocabulary (a spaceless one has
        char == word)."""
        ms = self.cfg.model.time_stride * self.cfg.features.stride_ms
        self._last_times = [
            [[self.tokenizer.decode([k]), float(s * ms), float(e * ms)]
             for k, s, e in spans]
            for spans in per_utt]
        self._last_word_times = None
        if self._space_id is not None:
            self._last_word_times = [
                _words_from_char_times(spans) for spans in self._last_times]

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
        texts, nbest, times, wtimes = [], [], [], []
        for plan in plans:
            self._last_nbest = None
            self._last_times = self._last_word_times = None
            texts.append(self.decode_batch(slice_to_plan(batch, plan)))
            nbest.append(self._last_nbest)
            times.append(self._last_times)
            wtimes.append(self._last_word_times)

        def _gather(per_plan):
            if any(x is None for x in per_plan):
                return None
            return unbucket(plans, per_plan)

        self._last_nbest = _gather(nbest)
        self._last_times = _gather(times)
        self._last_word_times = _gather(wtimes)
        return unbucket(plans, texts)

    def ladder(self) -> List[tuple]:
        """This engine's full ``(B, T)`` rung ladder."""
        return ladder_shapes(self.cfg.data.bucket_frames,
                             self.cfg.data.batch_size)

    def run(self, batches: Iterable[Tuple[Dict, int]], logger=None,
            refs_of=None) -> Dict[str, float]:
        """Decode ``(batch, n_valid)`` pairs; report WER/CER vs labels.

        ``logger.log(event, **fields)``, when given, receives one "utt"
        event per utterance (with ``times`` and ``word_times`` under
        ``decode.timestamps``) and the "infer_summary". ``refs_of(batch,
        n_valid)`` may override the reference transcripts, which by
        default come from the padded label ids.

        The offline modes copy each batch's features to the device
        through ``device_prefetch``, one batch ahead of the decode; the
        labels stay on the host. Streaming reads host arrays.
        """
        refs: List[str] = []
        hyps: List[str] = []
        for batch, n_valid in self._feed(batches):
            self._last_nbest = None
            self._last_times = self._last_word_times = None
            texts = self.decode_batch(batch)[:n_valid]
            # Beam modes with decode.nbest > 1: the alternatives (with
            # scores) beside each top-1 hypothesis.
            nbest = (self._last_nbest[:n_valid]
                     if self._last_nbest is not None
                     and self.cfg.decode.nbest > 1 else None)
            if refs_of is not None:
                batch_refs = refs_of(batch, n_valid)
            else:
                batch_refs = [
                    self.tokenizer.decode(row[:n]) for row, n in
                    list(zip(batch["labels"], batch["label_lens"]))[:n_valid]]
            times, word_times = self._last_times, self._last_word_times
            if logger is not None:
                for i, (r, h) in enumerate(zip(batch_refs, texts)):
                    extra = {"nbest": nbest[i]} if nbest else {}
                    if times is not None:
                        extra["times"] = times[i]
                    if word_times is not None:
                        extra["word_times"] = word_times[i]
                    logger.log("utt", ref=r, hyp=h, **extra)
            refs.extend(batch_refs)
            hyps.extend(texts)
        summary = {"wer": wer(refs, hyps), "cer": cer(refs, hyps),
                   "n_utts": len(refs)}
        if logger is not None:
            logger.log("infer_summary", **summary)
        return summary


    def _feed(self, batches: Iterable[Tuple[Dict, int]]
              ) -> Iterator[Tuple[Dict, int]]:
        """``batches`` with, in the offline modes, ``features`` and
        ``feat_lens`` replaced by their ``device_prefetch`` copies."""
        if self._streamer is not None:
            yield from batches
            return
        held: deque = deque()

        def feats():
            for batch, n_valid in batches:
                held.append((batch, n_valid))
                yield {"features": batch["features"],
                       "feat_lens": batch["feat_lens"]}

        for dev in device_prefetch(feats(), self.device):
            batch, n_valid = held.popleft()
            yield {**batch, **dev}, n_valid


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
