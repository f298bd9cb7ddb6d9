"""Synthetic speech-like batches for tests, smoke runs and the CLI.

Each "utterance" is a feature sequence whose frames encode its label
sequence through a fixed random linear map plus noise, made with numpy
from a seed, so both packages see the same batches.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import Config
from .pipeline import Batch, pad_batch


def synthetic_batch(cfg: Config, batch_size: int, frames: int,
                    label_len: int, seed: int = 0,
                    frames_per_label: int = 8) -> Tuple[Batch, List[List[int]]]:
    """A batch whose features linearly encode repeated label frames."""
    rng = np.random.default_rng(seed)
    v = cfg.model.vocab_size
    f = cfg.features.num_features
    emb = np.random.default_rng(7).normal(size=(v, f)).astype(np.float32)
    feats, labels = [], []
    for _ in range(batch_size):
        ln = int(rng.integers(max(label_len // 2, 1), label_len + 1))
        y = rng.integers(1, v, size=ln).tolist()
        t = min(ln * frames_per_label, frames)
        stretch = np.repeat(np.asarray(y), frames_per_label)[:t]
        x = emb[stretch] + 0.1 * rng.normal(size=(t, f)).astype(np.float32)
        feats.append(x.astype(np.float32))
        labels.append(y)
    batch = pad_batch(feats, labels, frames, cfg.data.max_label_len,
                      cfg.model.time_stride)
    return batch, labels


class SyntheticPipeline:
    """``n_utts`` synthetic utterances as ``cfg.data.batch_size`` batches
    of ``frames`` frames (default: the smallest bucket), with the
    interface the trainer reads (JAX ``train._SyntheticPipeline``):
    every epoch yields the same batches in the same order."""

    def __init__(self, cfg: Config, n_utts: int, frames: int = 0,
                 label_len: int = 12):
        self.cfg = cfg
        frames = frames or min(cfg.data.bucket_frames)
        bs = cfg.data.batch_size
        self.n_batches = max(n_utts // bs, 1)
        self.batches = [
            synthetic_batch(cfg, bs, frames, label_len, seed=i)[0]
            for i in range(self.n_batches)]

    def peek(self):
        return self.batches[0]

    def epoch(self, epoch_idx: int, start: int = 0):
        return iter(self.batches[start:])

    def batches_per_epoch(self, epoch_idx: int) -> int:
        return self.n_batches

    def eval_epoch(self):
        """``(batch, n_valid)`` pairs, every row valid."""
        bs = len(self.batches[0]["feat_lens"])
        return iter([(b, bs) for b in self.batches])
