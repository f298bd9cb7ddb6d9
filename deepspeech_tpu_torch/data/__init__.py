"""Host-side data: manifests, tokenizer, features, augmentation,
SortaGrad batch plans, the pipeline and its device prefetch, and the
inference planner."""

from .augment import augment_audio, spec_augment_features
from .features import featurize, featurize_np, load_audio, num_frames
from .infer_bucket import (InferBucketPlan, ladder_shapes, plan_infer_buckets,
                           slice_to_plan, unbucket)
from .manifest import Utterance, load_manifest, save_manifest
from .pipeline import (Batch, DataPipeline, device_prefetch, pad_batch,
                       scrub_padded_batch, scrub_samples)
from .sampler import BatchPlan, SortaGradSampler, assign_buckets
from .synthetic import SyntheticPipeline, synthetic_batch
from .tokenizer import (BLANK_ID, CharTokenizer, get_tokenizer,
                        resolve_tokenizer)

__all__ = [
    "BLANK_ID", "Batch", "BatchPlan", "CharTokenizer", "DataPipeline",
    "InferBucketPlan", "SortaGradSampler", "SyntheticPipeline",
    "Utterance", "assign_buckets", "augment_audio", "device_prefetch",
    "featurize", "featurize_np", "get_tokenizer", "ladder_shapes",
    "load_audio", "load_manifest", "num_frames", "pad_batch",
    "plan_infer_buckets", "resolve_tokenizer", "save_manifest",
    "scrub_padded_batch", "scrub_samples", "slice_to_plan",
    "spec_augment_features", "synthetic_batch", "unbucket",
]
