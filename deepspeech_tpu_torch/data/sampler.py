"""SortaGrad curriculum and bucketed batch plans for training, and the
bucket assignment the inference planner (data/infer_bucket.py) shares.

The port's own copy of the JAX package's ``data/sampler.py``. Epoch 0
(with ``sortagrad``) iterates utterances sorted by duration, short
first; later epochs shuffle within each bucket and shuffle the batch
order, from ``np.random.default_rng([seed, epoch])``. Every batch pads
to its bucket's edge; incomplete trailing batches are dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np


@dataclass(frozen=True)
class BatchPlan:
    """A planned batch: utterance indices + the static shapes to pad to."""

    indices: np.ndarray  # [B] int64 indices into the manifest
    bucket_frames: int  # pad/crop features to this many frames
    bucket_id: int


def assign_buckets(frames, bucket_frames: Sequence[int]) -> np.ndarray:
    """Index of the smallest bucket edge >= frames, vectorized.

    Returns ``len(bucket_frames)`` for frames beyond the largest edge
    (the sampler drops those; the infer planner routes them to
    overflow rungs).
    """
    return np.searchsorted(sorted(bucket_frames),
                           np.asarray(frames), side="left")


class SortaGradSampler:
    """Yields ``BatchPlan``s for one epoch at a time; each epoch's
    plans are a pure function of ``(seed, epoch)``, which is what a
    mid-epoch resume relies on."""

    def __init__(self, durations_s: Sequence[float], frames_per_sec: float,
                 bucket_frames: Sequence[int], batch_size: int,
                 sortagrad: bool = True, seed: int = 1234):
        self.batch_size = batch_size
        self.bucket_frames = sorted(bucket_frames)
        self.sortagrad = sortagrad
        self.seed = seed
        durations = np.asarray(durations_s, dtype=np.float64)
        self.frames = np.minimum(
            (durations * frames_per_sec).astype(np.int64),
            np.iinfo(np.int64).max)
        self.bucket_of = assign_buckets(self.frames, self.bucket_frames)
        # Utterances beyond the largest bucket are dropped.
        self._valid = self.bucket_of < len(self.bucket_frames)
        self.num_utts = int(self._valid.sum())
        if self.num_utts == 0:
            raise ValueError("no utterances fit in the configured buckets")

    def epoch(self, epoch_idx: int) -> Iterator[BatchPlan]:
        if self.sortagrad and epoch_idx == 0:
            yield from self._sorted_epoch()
        else:
            yield from self._shuffled_epoch(epoch_idx)

    def _sorted_epoch(self) -> Iterator[BatchPlan]:
        order = np.argsort(self.frames, kind="stable")
        order = order[self._valid[order]]
        for start in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
            idx = order[start:start + self.batch_size]
            b = int(self.bucket_of[idx].max())
            yield BatchPlan(idx, self.bucket_frames[b], b)

    def _shuffled_epoch(self, epoch_idx: int) -> Iterator[BatchPlan]:
        rng = np.random.default_rng([self.seed, epoch_idx])
        plans: List[BatchPlan] = []
        for b in range(len(self.bucket_frames)):
            members = np.flatnonzero(self._valid & (self.bucket_of == b))
            rng.shuffle(members)
            for start in range(0, len(members) - self.batch_size + 1,
                               self.batch_size):
                plans.append(BatchPlan(members[start:start + self.batch_size],
                                       self.bucket_frames[b], b))
        order = rng.permutation(len(plans))
        for i in order:
            yield plans[i]

    def batches_per_epoch(self, epoch_idx: int) -> int:
        if self.sortagrad and epoch_idx == 0:
            return self.num_utts // self.batch_size
        n = 0
        for b in range(len(self.bucket_frames)):
            members = int((self._valid & (self.bucket_of == b)).sum())
            n += members // self.batch_size
        return n
