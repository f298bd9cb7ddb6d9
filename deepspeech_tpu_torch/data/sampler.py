"""Bucket assignment shared by the training sampler (a later slice) and
the inference planner (data/infer_bucket.py)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def assign_buckets(frames, bucket_frames: Sequence[int]) -> np.ndarray:
    """Index of the smallest bucket edge >= frames, vectorized.

    Returns ``len(bucket_frames)`` for frames beyond the largest edge
    (the infer planner routes those to overflow rungs).
    """
    return np.searchsorted(sorted(bucket_frames),
                           np.asarray(frames), side="left")
