"""Host batch assembly.

Batch contract: dict of
  features   [B, T_bucket, F] float32
  feat_lens  [B]              int32   (frames before padding)
  labels     [B, L_max]       int32   (blank=0 padded)
  label_lens [B]              int32
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

Batch = Dict[str, np.ndarray]


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
