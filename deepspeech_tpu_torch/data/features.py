"""Log-spectrogram featurizer: ``featurize`` in torch on the tensor's
device, ``featurize_np`` in numpy for the host pipeline.

Pre-emphasis -> framing -> Hann window -> rFFT -> log-magnitude ->
per-utterance normalization. Audio ``[N]`` float32 in [-1, 1] ->
features ``[T, F]`` with ``F = n_fft // 2 + 1`` (320-point FFT at
16 kHz -> 161 bins, the DS2 layout). The two agree to about 1e-4 in
float32 (their FFTs sum in different orders); the host pipeline uses
``featurize_np``, as the JAX package's does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import FeatureConfig


def frame_params(cfg: FeatureConfig) -> Tuple[int, int, int]:
    """(window_samples, stride_samples, n_fft)."""
    win = int(cfg.sample_rate * cfg.window_ms / 1000.0)
    hop = int(cfg.sample_rate * cfg.stride_ms / 1000.0)
    n_fft = 2 * (cfg.num_features - 1)
    if n_fft < win:
        raise ValueError(
            f"n_fft={n_fft} < window={win}; raise num_features or shrink window")
    return win, hop, n_fft


def num_frames(num_samples: int, cfg: FeatureConfig) -> int:
    win, hop, _ = frame_params(cfg)
    if num_samples < win:
        return 0
    return 1 + (num_samples - win) // hop


def featurize(audio: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """audio [N] -> log-spectrogram [T, num_features] float32, computed
    on ``audio``'s device. Raises on audio shorter than one window
    (filter those upstream with ``data.min_duration_s``)."""
    win, hop, n_fft = frame_params(cfg)
    if audio.shape[0] < win:
        raise ValueError(
            f"audio has {audio.shape[0]} samples < one window ({win}); "
            "filter short utterances upstream (DataConfig.min_duration_s)")
    audio = torch.as_tensor(audio).to(torch.float32)
    if cfg.preemphasis > 0:
        audio = torch.cat([audio[:1],
                           audio[1:] - cfg.preemphasis * audio[:-1]])
    frames = audio.unfold(0, win, hop)  # [T, win], T = 1 + (N - win) // hop
    window = torch.hann_window(win, periodic=False, dtype=torch.float32,
                               device=audio.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    feats = torch.log(spec.abs() + cfg.eps)
    if cfg.normalize:
        mean = feats.mean(dim=0, keepdim=True)
        std = feats.std(dim=0, keepdim=True, correction=0)
        feats = (feats - mean) / (std + cfg.eps)
    return feats


def featurize_np(audio: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """audio [N] -> log-spectrogram [T, num_features] float32.

    Audio shorter than one window returns [0, F].
    """
    win, hop, n_fft = frame_params(cfg)
    audio = np.asarray(audio, np.float32)
    if cfg.preemphasis > 0:
        audio = np.concatenate(
            [audio[:1], audio[1:] - cfg.preemphasis * audio[:-1]])
    n = audio.shape[0]
    if n < win:
        return np.zeros((0, cfg.num_features), np.float32)
    t = 1 + (n - win) // hop
    idx = (np.arange(t) * hop)[:, None] + np.arange(win)[None, :]
    frames = audio[idx] * np.hanning(win).astype(np.float32)
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    feats = np.log(np.abs(spec).astype(np.float32) + cfg.eps)
    if cfg.normalize:
        mean = feats.mean(axis=0, keepdims=True)
        std = feats.std(axis=0, keepdims=True)
        feats = (feats - mean) / (std + cfg.eps)
    return feats.astype(np.float32)


def load_audio(path: str, sample_rate: int) -> np.ndarray:
    """Load a .wav file (stdlib ``wave``) to float32 mono at the given
    rate; other formats need ``soundfile`` where it is installed."""
    if path.endswith(".wav"):
        import wave

        with wave.open(path, "rb") as w:
            if w.getframerate() != sample_rate:
                raise ValueError(
                    f"{path}: rate {w.getframerate()} != {sample_rate}; "
                    "resample offline")
            raw = w.readframes(w.getnframes())
            width = w.getsampwidth()
            if width == 1:
                # 8-bit WAV PCM is unsigned (128 = silence).
                audio = (np.frombuffer(raw, np.uint8).astype(np.float32)
                         - 128.0) / 128.0
            else:
                dtype = {2: np.int16, 4: np.int32}[width]
                audio = np.frombuffer(raw, dtype=dtype).astype(np.float32)
                audio /= float(np.iinfo(dtype).max)
            if w.getnchannels() > 1:
                audio = audio.reshape(-1, w.getnchannels()).mean(axis=1)
            return audio
    try:
        import soundfile as sf
    except ImportError as e:
        raise ValueError(
            f"cannot load {path}: only .wav supported without soundfile") from e
    audio, sr = sf.read(path, dtype="float32")
    if sr != sample_rate:
        raise ValueError(f"{path}: rate {sr} != {sample_rate}")
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    return audio
