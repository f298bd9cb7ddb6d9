"""Host data pipeline: manifest -> featurized, padded, bucketed batches,
and ``device_prefetch``, which copies them to the card ahead of use.

The port's counterpart of the JAX package's ``data/pipeline.py``. Two
stages overlap the step: ``DataPipeline.epoch`` featurizes and pads
batch k+1 on a background thread while batch k computes, and
``device_prefetch`` copies batch k+1 from pinned host memory on a side
CUDA stream while the compute stream runs batch k.

Batch contract: dict of
  features   [B, T_bucket, F] float32
  feat_lens  [B]              int32   (frames before padding)
  labels     [B, L_max]       int32   (blank=0 padded)
  label_lens [B]              int32

Corrupt-sample quarantine (``data.quarantine_corrupt``, on by
default): a sample with non-finite features, an empty label, or a label
longer than its frames can carry (CTC's T' >= 2L+1) never reaches the
device; its row is replaced by a healthy donor row (shapes unchanged),
the pipeline counts it (``quarantined``, and ``samples_quarantined``
with and without a ``trigger`` label in the metrics registry), writes a
``corrupt_sample`` postmortem record (``resilience/postmortem.py``), as
the JAX package's pipeline does, and logs a ``corrupt_sample`` event
through its ``logger`` (the trainer's).

Fault points (``resilience/faults.py``): ``pipeline.materialize`` fires
in front of each quarantine scan (``corrupt_batch`` poisons sample 0's
features with NaN, so the scrubber catches it, or, with quarantine off,
the training guardian does) and ``pipeline.device_prefetch`` before each
batch's copy to the device (``latency`` stalls it, ``error`` fails it).

Features: the C++ loader (``csrc/host/dsp.cc`` through ``native.py``'s
``load_featurize_batch``: WAVs read and featurized on a thread pool,
outside the interpreter lock) where the JAX pipeline takes it, that is
``data.native_loader`` on, the feature cache off (a corpus past
``MAX_CACHED_UTTS``, or ``cache=False``) and no waveform augmentation;
SpecAugment masks its batch in place. A batch with a file that is not a
``.wav`` or does not parse there goes through numpy (``featurize_np``),
as the JAX pipeline's does: the reference's own data semantics, counted
in ``native_fallbacks`` beside ``native_batches``. Small cached corpora
featurize once with numpy.

Under a process group (``parallel/``) each process builds only its rows
of a global batch (``parallel.process_local_span``: the process-major
equal split) and leaves the others zero; the SortaGrad plan, the
augmentation keys and the quarantine stay per utterance, so a row's
bits do not depend on the rank that builds it.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections import deque
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .. import obs
from ..config import Config
from ..resilience import faults
from ..resilience import postmortem as _postmortem
from ..parallel.mesh import process_local_span
from .features import featurize_np, load_audio
from .manifest import Utterance, load_manifest
from .sampler import BatchPlan, SortaGradSampler
from .tokenizer import CharTokenizer

Batch = Dict[str, np.ndarray]
# Called once per quarantined sample: (row, trigger, utt, frames,
# label_len).
OnQuarantine = Callable[[int, str, str, int, int], None]


def _background(items: Iterable, fn: Callable, depth: int) -> Iterator:
    """Yield ``fn(item)`` for each of ``items``, computed on a background
    thread up to ``depth`` ahead; an error there is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    cancel = threading.Event()

    def put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if not put(fn(item)):
                    return
            put(stop)
        except BaseException as e:  # re-raised in the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # A consumer that stops early (an error, or a closed generator)
        # releases the worker instead of leaving it blocked on a full
        # queue.
        cancel.set()
        t.join()


def device_prefetch(batches: Iterable[Batch], device, depth: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield ``batches`` as tensors on ``device``, ``depth - 1`` copies
    ahead of the consumer.

    On a CUDA device a background thread copies each batch into pinned
    host memory, up to ``depth`` batches ahead, so the consumer's thread
    only enqueues its ``non_blocking`` copies on a side stream, with an
    event recorded after them. A batch is yielded only after the consumer's
    current stream waits on its event, so no kernel reads a half-copied
    batch, and each of its tensors is marked with ``record_stream`` for
    that stream, so the caching allocator does not hand its memory out
    while work queued there still reads it. The pinned buffers return to
    PyTorch's pinned-memory cache, which reuses a block only after the
    copies recorded on it have completed.

    On the CPU the batches are copied into tensors as they come: the
    caller asked for the CPU.
    """
    if depth < 1:
        raise ValueError(f"device_prefetch depth must be >= 1, got {depth}")
    device = torch.device(device)
    if device.type == "cpu":
        for b in batches:
            faults.inject("pipeline.device_prefetch")
            yield {k: torch.tensor(np.asarray(v)) for k, v in b.items()}
        return
    side = torch.cuda.Stream(device)
    buf: deque = deque()

    def pin(b: Batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in b.items()}

    def send(pinned: Dict[str, torch.Tensor]):
        faults.inject("pipeline.device_prefetch")
        with torch.cuda.stream(side):
            dev = {k: t.to(device, non_blocking=True)
                   for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(side)
        return dev, done

    def ready(entry):
        dev, done = entry
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        for t in dev.values():
            t.record_stream(compute)
        return dev

    for pinned in _background(batches, pin, depth):
        buf.append(send(pinned))
        if len(buf) >= depth:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())


def pad_batch(features: List[np.ndarray], labels: List[List[int]],
              bucket_frames: int, max_label_len: int,
              time_stride: int) -> Batch:
    """Pad a list of [T_i, F] features + label lists to static shapes.

    Labels are clipped to the longest length CTC can align in
    T' = ceil(t / time_stride) output frames (T' >= 2L+1).
    """
    b = len(features)
    f = features[0].shape[1]
    feats = np.zeros((b, bucket_frames, f), dtype=np.float32)
    feat_lens = np.zeros((b,), dtype=np.int32)
    labs = np.zeros((b, max_label_len), dtype=np.int32)
    lab_lens = np.zeros((b,), dtype=np.int32)
    for i, (x, y) in enumerate(zip(features, labels)):
        t = min(x.shape[0], bucket_frames)
        feats[i, :t] = x[:t]
        feat_lens[i] = t
        max_feasible = max(((-(-t // time_stride)) - 1) // 2, 0)
        y = y[:min(len(y), max_label_len, max_feasible)]
        labs[i, :len(y)] = y
        lab_lens[i] = len(y)
    return {"features": feats, "feat_lens": feat_lens,
            "labels": labs, "label_lens": lab_lens}


def _max_feasible_labels(frames: int, bucket_frames: int,
                         time_stride: int) -> int:
    """The longest label a ``frames``-frame sample (clipped to the
    bucket) can align under CTC."""
    t = min(int(frames), bucket_frames)
    return max(((-(-t // time_stride)) - 1) // 2, 0)


def _utt(ids: Optional[Sequence], i: int) -> str:
    return str(ids[i]) if ids is not None and i < len(ids) else str(i)


def scrub_samples(feats: List[np.ndarray], labels: List[List[int]], *,
                  bucket_frames: int, max_label_len: int,
                  time_stride: int, ids: Optional[Sequence] = None,
                  enabled: bool = True,
                  on_quarantine: Optional[OnQuarantine] = None
                  ) -> Tuple[List[np.ndarray], List[List[int]], int]:
    """Corrupt-sample quarantine over per-utterance lists (in front of
    :func:`pad_batch`).

    Flags non-finite features, empty labels, and labels longer than
    their frames can carry; each flagged sample is replaced by the
    first healthy one (batch shape and size unchanged). If the whole
    batch is corrupt, features are sanitized (``nan_to_num``) and labels
    clipped. Returns ``(feats, labels, n_quarantined)``. The
    ``pipeline.materialize`` fault point fires first (module docstring).
    """
    feats = list(feats)
    labels = list(labels)
    spec = faults.inject("pipeline.materialize")
    if spec is not None and spec.kind == "corrupt_batch" and feats:
        feats[0] = np.full_like(feats[0], np.nan)
    if not enabled or not feats:
        return feats, labels, 0

    def problem(x: np.ndarray, y: List[int]) -> Optional[str]:
        if not np.isfinite(x).all():
            return "nonfinite_features"
        if len(y) == 0:
            return "empty_label"
        if min(len(y), max_label_len) > _max_feasible_labels(
                x.shape[0], bucket_frames, time_stride):
            return "overlong_label"
        return None

    problems = [problem(x, y) for x, y in zip(feats, labels)]
    donor = next((i for i, p in enumerate(problems) if p is None), None)
    n_bad = 0
    for i, p in enumerate(problems):
        if p is None:
            continue
        n_bad += 1
        if on_quarantine is not None:
            on_quarantine(i, p, _utt(ids, i), int(feats[i].shape[0]),
                          int(len(labels[i])))
        if donor is not None:
            feats[i] = feats[donor]
            labels[i] = labels[donor]
        else:
            feats[i] = np.nan_to_num(feats[i], copy=True,
                                     posinf=0.0, neginf=0.0)
            labels[i] = labels[i][:_max_feasible_labels(
                feats[i].shape[0], bucket_frames, time_stride)]
    return feats, labels, n_bad


def scrub_padded_batch(batch: Batch, *, ids: Optional[Sequence] = None,
                       enabled: bool = True,
                       on_quarantine: Optional[OnQuarantine] = None
                       ) -> Tuple[Batch, int]:
    """Quarantine over an already-padded batch (synthetic streams and
    other padded sources): :func:`scrub_samples`' policy without the
    overlong-label check, since padding already clipped labels to
    feasibility and the symptom left is an empty label. Mutates
    ``batch``'s rows in place; returns ``(batch, n_quarantined)``."""
    spec = faults.inject("pipeline.materialize")
    feats = batch["features"]
    if spec is not None and spec.kind == "corrupt_batch" \
            and len(feats):
        feats[0] = np.nan
    if not enabled or not len(feats):
        return batch, 0
    finite = np.isfinite(feats).all(axis=tuple(range(1, feats.ndim)))
    empty = np.asarray(batch["label_lens"]) == 0
    bad = ~finite | empty
    if not bad.any():
        return batch, 0
    donors = np.flatnonzero(~bad)
    donor = int(donors[0]) if len(donors) else None
    n_bad = 0
    for i in np.flatnonzero(bad):
        i = int(i)
        n_bad += 1
        trigger = "nonfinite_features" if not finite[i] else "empty_label"
        if on_quarantine is not None:
            on_quarantine(i, trigger, _utt(ids, i),
                          int(batch["feat_lens"][i]),
                          int(batch["label_lens"][i]))
        if donor is not None:
            for k in batch:
                batch[k][i] = batch[k][donor]
        else:
            feats[i] = np.nan_to_num(feats[i], posinf=0.0, neginf=0.0)
    return batch, n_bad


class DataPipeline:
    """End-to-end host pipeline for one manifest.

    Each quarantined sample counts in ``quarantined`` and in the
    registry's ``samples_quarantined`` (bare and ``{trigger}``), and
    writes one ``corrupt_sample`` postmortem record; ``logger``
    (``log(event, **fields)``), when set, also receives one
    ``corrupt_sample`` event. The trainer sets its own logger on a
    pipeline that has none.
    """

    # Cache featurized utterances only for small (overfit-slice-sized)
    # datasets; a 960 h corpus would take hundreds of GB.
    MAX_CACHED_UTTS = 2048
    # Batches the epoch's worker thread may hold ready.
    PREFETCH = 2

    def __init__(self, cfg: Config, tokenizer: CharTokenizer,
                 manifest_path: Optional[str] = None,
                 utterances: Optional[List[Utterance]] = None,
                 logger=None, cache: Optional[bool] = None):
        """``cache`` overrides the size rule of the feature cache (None:
        cache when the corpus has at most ``MAX_CACHED_UTTS``
        utterances); ``cache=False`` takes the big-corpus path, fresh
        featurization a batch, through the C++ loader where it applies."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        if utterances is None:
            utterances = load_manifest(
                manifest_path, cfg.data.min_duration_s, cfg.data.max_duration_s)
        self.utts = utterances
        frames_per_sec = 1000.0 / cfg.features.stride_ms
        self.sampler = SortaGradSampler(
            [u.duration for u in self.utts], frames_per_sec,
            cfg.data.bucket_frames, cfg.data.batch_size,
            sortagrad=cfg.data.sortagrad, seed=cfg.data.shuffle_seed)
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_enabled = (len(self.utts) <= self.MAX_CACHED_UTTS
                               if cache is None else cache)
        # The C++ loader: for big uncached corpora, where a batch's
        # featurization is on the step's critical path.
        self._native = bool(cfg.data.native_loader
                            and not self._cache_enabled)
        self.native_batches = 0
        self.native_fallbacks = 0
        self.logger = logger
        self.quarantined = 0
        self._lock = threading.Lock()

    def _on_quarantine(self, row: int, trigger: str, utt: str, frames: int,
                       label_len: int) -> None:
        with self._lock:
            self.quarantined += 1
        reg = obs.registry()
        reg.count("samples_quarantined")
        reg.count("samples_quarantined", labels={"trigger": trigger})
        _postmortem.writer().write("corrupt_sample", trigger, utt=utt,
                                   row=int(row), step=None, frames=frames,
                                   label_len=label_len)
        if self.logger is not None:
            self.logger.log("corrupt_sample", trigger=trigger, utt=utt,
                            row=row, frames=frames, label_len=label_len)

    def _features_for(self, idx: int) -> np.ndarray:
        if idx in self._cache:
            return self._cache[idx]
        audio = load_audio(self.utts[idx].audio,
                           self.cfg.features.sample_rate)
        feats = featurize_np(audio, self.cfg.features)
        if self._cache_enabled:
            self._cache[idx] = feats
        return feats

    def _utt_ids(self, plan: BatchPlan) -> List[str]:
        return [self.utts[int(i)].audio or str(int(i))
                for i in plan.indices]

    def _materialize(self, plan: BatchPlan,
                     epoch: Optional[int] = None) -> Batch:
        """One batch plan -> a padded host batch; under a process group
        only this process's rows are built, the rest left zero. ``epoch``
        is set for training batches and keys the augmentation; None
        (eval, peek) never augments."""
        b = len(plan.indices)
        lo, hi = process_local_span(b)
        if (lo, hi) == (0, b):
            return self._materialize_local(plan, epoch)
        local = self._materialize_local(
            BatchPlan(plan.indices[lo:hi], plan.bucket_frames, plan.bucket_id),
            epoch)
        out = {k: np.zeros((b,) + v.shape[1:], v.dtype)
               for k, v in local.items()}
        for k, v in local.items():
            out[k][lo:hi] = v
        return out

    def _materialize_local(self, plan: BatchPlan,
                           epoch: Optional[int] = None) -> Batch:
        data = self.cfg.data
        labels = [self.tokenizer.encode(self.utts[int(i)].text)
                  for i in plan.indices]
        augment = data.augment and epoch is not None
        spec_aug = data.spec_augment and epoch is not None
        if self._native and not augment:
            batch = self._materialize_native(plan, labels)
            if batch is not None:
                if spec_aug:
                    from .augment import spec_augment_features

                    # Mask each row's valid frames in place (only the
                    # waveform augmentation needs fresh featurization).
                    for r, i in enumerate(plan.indices):
                        n = int(batch["feat_lens"][r])
                        spec_augment_features(
                            batch["features"][r, :n], data.shuffle_seed,
                            epoch, int(i), copy=False)
                batch, _ = scrub_padded_batch(
                    batch, ids=self._utt_ids(plan),
                    enabled=data.quarantine_corrupt,
                    on_quarantine=self._on_quarantine)
                return batch
        if augment:
            from .augment import augment_audio

            feats = []
            for i in plan.indices:
                i = int(i)
                audio = load_audio(self.utts[i].audio,
                                   self.cfg.features.sample_rate)
                audio = augment_audio(audio, self.cfg.features.sample_rate,
                                      data.shuffle_seed, epoch, i)
                feats.append(featurize_np(audio, self.cfg.features))
        else:
            feats = [self._features_for(int(i)) for i in plan.indices]
        if spec_aug:
            from .augment import spec_augment_features

            # Truncate to the bucket before masking, so the mask draws
            # and the fill mean see exactly the frames pad_batch keeps.
            feats = [spec_augment_features(f[:plan.bucket_frames],
                                           data.shuffle_seed, epoch, int(i))
                     for f, i in zip(feats, plan.indices)]
        feats, labels, _ = scrub_samples(
            feats, labels, bucket_frames=plan.bucket_frames,
            max_label_len=data.max_label_len,
            time_stride=self.cfg.model.time_stride,
            ids=self._utt_ids(plan), enabled=data.quarantine_corrupt,
            on_quarantine=self._on_quarantine)
        return pad_batch(feats, labels, plan.bucket_frames,
                         data.max_label_len, self.cfg.model.time_stride)

    def _materialize_native(self, plan: BatchPlan,
                            labels: List[List[int]]) -> Optional[Batch]:
        """A batch's WAVs read and featurized by the C++ loader. None
        (the caller featurizes with numpy, counted in
        ``native_fallbacks``) when a file is not a ``.wav`` or fails to
        parse there."""
        from .. import native

        paths = [self.utts[int(i)].audio for i in plan.indices]
        frames = None
        if all(p.endswith(".wav") for p in paths):
            feats, frames = native.load_featurize_batch(
                paths, self.cfg.features, max_frames=plan.bucket_frames)
        if frames is None or np.any(frames < 0):
            with self._lock:
                self.native_fallbacks += 1
            return None
        with self._lock:
            self.native_batches += 1
        b = len(paths)
        data = self.cfg.data
        labs = np.zeros((b, data.max_label_len), dtype=np.int32)
        lab_lens = np.zeros((b,), dtype=np.int32)
        for i, y in enumerate(labels):
            y = y[:min(len(y), data.max_label_len, _max_feasible_labels(
                int(frames[i]), plan.bucket_frames,
                self.cfg.model.time_stride))]
            labs[i, :len(y)] = y
            lab_lens[i] = len(y)
        return {"features": feats, "feat_lens": frames.astype(np.int32),
                "labels": labs, "label_lens": lab_lens}

    def peek(self) -> Batch:
        """First epoch-0 batch, materialized synchronously (no worker)."""
        plan = next(iter(self.sampler.epoch(0)))
        return self._materialize(plan)

    def eval_epoch(self) -> Iterator[Tuple[Batch, int]]:
        """Yield ``(batch, n_valid)`` covering every utterance once.

        Partial trailing batches are kept: the last batch of each
        bucket repeats its final utterance and ``n_valid`` says how many
        rows count.
        """
        order = np.argsort(self.sampler.frames, kind="stable")
        order = order[self.sampler._valid[order]]
        by_bucket: Dict[int, List[int]] = {}
        for i in order:
            by_bucket.setdefault(int(self.sampler.bucket_of[i]),
                                 []).append(int(i))
        bs = self.cfg.data.batch_size
        for b, members in sorted(by_bucket.items()):
            for start in range(0, len(members), bs):
                chunk = members[start:start + bs]
                n_valid = len(chunk)
                chunk = chunk + [chunk[-1]] * (bs - n_valid)
                plan = BatchPlan(np.asarray(chunk, np.int64),
                                 self.sampler.bucket_frames[b], b)
                yield self._materialize(plan), n_valid

    def epoch(self, epoch_idx: int, start: int = 0) -> Iterator[Batch]:
        """Batches for one epoch from its ``start``-th on, materialized
        on a background thread up to ``PREFETCH`` ahead; a worker's error
        is raised here. The plans before ``start`` (a resume's, already
        consumed) are skipped unread."""
        plans = itertools.islice(self.sampler.epoch(epoch_idx), start, None)
        return _background(
            plans, lambda plan: self._materialize(plan, epoch=epoch_idx),
            self.PREFETCH)

    def batches_per_epoch(self, epoch_idx: int) -> int:
        return self.sampler.batches_per_epoch(epoch_idx)
