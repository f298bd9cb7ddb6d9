"""Host-side data: tokenizer, features, batch assembly, bucket plans."""

from .features import featurize_np, load_audio, num_frames
from .infer_bucket import (InferBucketPlan, ladder_shapes, plan_infer_buckets,
                           slice_to_plan, unbucket)
from .pipeline import pad_batch
from .synthetic import SyntheticPipeline, synthetic_batch
from .tokenizer import CharTokenizer, get_tokenizer

__all__ = [
    "CharTokenizer", "InferBucketPlan", "SyntheticPipeline", "featurize_np",
    "get_tokenizer", "ladder_shapes", "load_audio", "num_frames",
    "pad_batch", "plan_infer_buckets", "slice_to_plan", "synthetic_batch",
    "unbucket",
]
