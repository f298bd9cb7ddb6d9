"""Typed configuration for models, data, training and decoding.

The port's own copy of ``deepspeech_tpu/config.py``: the same frozen
dataclasses, field names, defaults and presets, so a preset name or a
``--section.key=value`` override means the same model on both sides
(the parity tests build both configs from one override dict). Fields
that drive parts of the system not yet ported are kept so overrides and
saved configs stay interchangeable; the code that would read them
raises ``NotImplementedError`` naming the later slice.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class FeatureConfig:
    """Log-spectrogram frontend."""

    sample_rate: int = 16000
    window_ms: float = 20.0
    stride_ms: float = 10.0
    # 320-sample window at 16 kHz -> rfft -> 161 bins, the DS2 layout.
    num_features: int = 161
    # Per-utterance mean/std normalization over valid frames.
    normalize: bool = True
    preemphasis: float = 0.97
    eps: float = 1e-6


@dataclass(frozen=True)
class ModelConfig:
    """DS2 model family."""

    # Conv frontend: (time_kernel, freq_kernel, time_stride, freq_stride).
    conv_layers: Tuple[Tuple[int, int, int, int], ...] = (
        (11, 41, 2, 2),
        (11, 21, 1, 2),
    )
    conv_channels: Tuple[int, ...] = (32, 32)
    # RNN stack.
    rnn_layers: int = 3
    rnn_hidden: int = 800
    rnn_type: str = "gru"  # "gru" | "lstm"
    bidirectional: bool = True
    # Streaming variant: unidirectional + lookahead conv over future frames.
    lookahead_context: int = 0  # 0 disables lookahead conv
    # Batch norm between RNN layers (sequence-wise, masked).
    rnn_batch_norm: bool = True
    vocab_size: int = 29  # EN: blank + a-z + space + apostrophe
    relu_clip: float = 20.0
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    # The port has one recurrence for each cell, ops/gru.py's gru_fwd
    # and ops/lstm.py's lstm_fwd (the CUDA kernels for CUDA tensors,
    # their plain versions for CPU tensors). The field stays so that the
    # JAX package's configs parse: "auto" and "pallas" both name them,
    # and any other value raises.
    rnn_impl: str = "auto"
    # Training only (a later slice).
    rnn_remat_chunk: int = 0
    # Pipeline parallelism (a later slice); 1 = off.
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    # RNN-T family (a later slice).
    rnnt_pred_hidden: int = 128
    rnnt_joint_dim: int = 256

    @property
    def time_stride(self) -> int:
        s = 1
        for (_, _, ts, _) in self.conv_layers:
            s *= ts
        return s


@dataclass(frozen=True)
class DataConfig:
    """Manifest + bucketing."""

    train_manifest: str = ""
    eval_manifest: str = ""
    # Batch per step; also the largest B rung of the inference ladder.
    batch_size: int = 32
    max_duration_s: float = 16.5
    min_duration_s: float = 0.3
    # Bucket boundaries in feature frames; also the T rungs of the
    # inference ladder (data/infer_bucket.py).
    bucket_frames: Tuple[int, ...] = (400, 800, 1200, 1700)
    max_label_len: int = 256
    sortagrad: bool = True
    augment: bool = False
    spec_augment: bool = False
    shuffle_seed: int = 1234
    language: str = "en"  # "en" | "zh"
    vocab_path: str = ""
    # The JAX package's C++ loader, which computes the same features;
    # the port featurizes with numpy (data/pipeline.py) and reads
    # nothing here.
    native_loader: bool = True
    quarantine_corrupt: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer/schedule/loop and checkpoints."""

    optimizer: str = "sgd"  # "sgd" | "adamw"
    learning_rate: float = 3e-4
    momentum: float = 0.99
    weight_decay: float = 0.0
    grad_clip_norm: float = 400.0
    lr_anneal: float = 1.1
    warmup_steps: int = 500
    epochs: int = 20
    log_every: int = 10
    eval_every_steps: int = 1000
    checkpoint_every_steps: int = 1000
    # Under the temp directory ($TMPDIR) of the process that builds the
    # config, so runs that each have a temp directory of their own never
    # resume or serve each other's steps.
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "deepspeech_tpu_ckpt"))
    keep_checkpoints: int = 3
    seed: int = 0
    mesh_shape: Tuple[int, ...] = (0, 1)
    accum_steps: int = 1
    zero_opt_sharding: bool = False
    loss_impl: str = "auto"
    objective: str = "ctc"
    sequence_parallel: bool = False
    tensorboard_dir: str = ""
    profile_dir: str = ""
    profile_start_step: int = 10
    profile_steps: int = 3
    guardian: bool = False


@dataclass(frozen=True)
class DecodeConfig:
    """Decoding. The port decodes ``mode="greedy"`` only so far; the
    other modes of the JAX package (beam, LM fusion, streaming,
    sequence-parallel, transducer) raise ``NotImplementedError``."""

    mode: str = "greedy"
    chunk_frames: int = 64
    beam_width: int = 64
    prune_top_k: int = 40
    nbest: int = 8
    lm_path: str = ""
    lm_alpha: float = 0.5
    lm_beta: float = 1.0
    prune_log_prob: float = -12.0
    device_lm_context: int = 0
    device_lm_impl: str = "auto"
    host_impl: str = "auto"
    merge_impl: str = "auto"
    timestamps: bool = False


@dataclass(frozen=True)
class Config:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    name: str = "ds2_small"


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def ds2_small() -> Config:
    """DS2-small: 2 conv + 3 BiGRU, H=800."""
    return Config(name="ds2_small")


def ds2_full() -> Config:
    """Full DS2: 2 conv + 7 BiGRU, H=1760."""
    c = Config(name="ds2_full")
    return _replace(
        c,
        model=_replace(c.model, rnn_layers=7, rnn_hidden=1760),
    )


def ds2_streaming() -> Config:
    """Streaming: 5 unidirectional GRU layers + lookahead conv."""
    c = Config(name="ds2_streaming")
    return _replace(
        c,
        model=_replace(
            c.model,
            rnn_layers=5,
            rnn_hidden=800,
            bidirectional=False,
            lookahead_context=20,
        ),
    )


def ds2_beam_lm() -> Config:
    """Beam-search decode with external n-gram rescoring."""
    c = ds2_small()
    return _replace(
        c,
        name="ds2_beam_lm",
        decode=_replace(c.decode, mode="beam", beam_width=128),
    )


def aishell() -> Config:
    """Mandarin character CTC, AISHELL-1 (vocab ~4.3k chars + blank)."""
    c = Config(name="aishell")
    return _replace(
        c,
        model=_replace(c.model, vocab_size=4336),
        data=_replace(c.data, language="zh"),
    )


def dev_slice() -> Config:
    """100-utterance dev-clean overfit slice."""
    c = ds2_small()
    return _replace(
        c,
        name="dev_slice",
        data=_replace(c.data, batch_size=8, bucket_frames=(400, 800, 1700)),
        train=_replace(c.train, epochs=50, learning_rate=1e-3,
                       optimizer="adamw"),
    )


PRESETS = {
    "ds2_small": ds2_small,
    "ds2_full": ds2_full,
    "ds2_streaming": ds2_streaming,
    "ds2_beam_lm": ds2_beam_lm,
    "aishell": aishell,
    "dev_slice": dev_slice,
}


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()


def _coerce(value, template):
    """Parse ``value`` (possibly a CLI string) to the type of ``template``."""
    if value is None or template is None:
        return value
    if isinstance(value, type(template)) and not isinstance(template, bool):
        return value
    if isinstance(template, bool):
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse {value!r} as bool")
    if isinstance(template, tuple):
        if isinstance(value, (list, tuple)):
            items = value
        else:
            items = [p for p in str(value).split(",") if p.strip()]
        elem = template[0] if template else str
        return tuple(type(elem)(p) for p in items)
    return type(template)(value)


def parse_cli_overrides(extra) -> dict:
    """``--section.key=value`` leftovers from parse_known_args -> dict
    for apply_overrides."""
    overrides = {}
    for item in extra:
        if not item.startswith("--") or "=" not in item:
            raise SystemExit(f"unrecognized arg {item!r}")
        k, v = item[2:].split("=", 1)
        overrides[k] = v
    return overrides


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Apply dotted-key overrides, e.g. {"model.rnn_hidden": "32"}.

    Values may be strings (as they arrive from --key=value CLI flags);
    they are parsed to the field's existing type, including bools
    ("false" -> False) and comma-separated tuples ("400,800" -> (400, 800)).
    """
    for key, value in overrides.items():
        parts = key.split(".")
        if len(parts) == 1:
            cfg = _replace(cfg, **{parts[0]: _coerce(value, getattr(cfg, parts[0]))})
            continue
        if len(parts) != 2:
            raise KeyError(f"override key {key!r} must be section.field")
        section = getattr(cfg, parts[0])
        value = _coerce(value, getattr(section, parts[1]))
        cfg = _replace(cfg, **{parts[0]: _replace(section, **{parts[1]: value})})
    return cfg
