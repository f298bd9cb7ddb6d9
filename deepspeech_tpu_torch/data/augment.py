"""Training-time augmentation, numpy on the host (train epochs only).

The port's own copy of the JAX package's ``data/augment.py``:

- ``augment_audio``: random gain, white noise at a random SNR and a
  small zero-filled shift of the waveform; the same length out.
- ``spec_augment_features``: time and frequency stripes of a ``[T, F]``
  feature matrix set to its mean (opt-in, ``data.spec_augment``).

Both are pure functions of ``(seed, epoch, utt_idx)``, so a mid-epoch
resume replays the same augmented samples, and they draw the JAX
package's numbers from the same numpy streams.
"""

from __future__ import annotations

import numpy as np

GAIN_DB = (-6.0, 6.0)
NOISE_SNR_DB = (10.0, 40.0)
MAX_SHIFT_MS = 5.0


def augment_audio(audio: np.ndarray, sample_rate: int,
                  seed: int, epoch: int, utt_idx: int) -> np.ndarray:
    """Gain + white noise + small shift; float32 in, float32 out,
    same length."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, epoch, utt_idx]))
    out = audio.astype(np.float32, copy=True)

    gain = 10.0 ** (rng.uniform(*GAIN_DB) / 20.0)
    out *= gain

    power = float(np.mean(out * out)) + 1e-10
    snr_db = rng.uniform(*NOISE_SNR_DB)
    noise_power = power / (10.0 ** (snr_db / 10.0))
    out += rng.normal(0.0, np.sqrt(noise_power),
                      size=out.shape).astype(np.float32)

    max_shift = int(sample_rate * MAX_SHIFT_MS / 1000.0)
    if max_shift > 0:
        shift = int(rng.integers(-max_shift, max_shift + 1))
        if shift:
            shifted = np.zeros_like(out)
            if shift > 0:
                shifted[shift:] = out[:-shift]
            else:
                shifted[:shift] = out[-shift:]
            out = shifted

    np.clip(out, -1.0, 1.0, out=out)
    return out


SPEC_TIME_MASKS = 2
SPEC_TIME_WIDTH = 30   # max frames per time mask
SPEC_TIME_FRAC = 0.2   # ...and at most this fraction of the utterance
SPEC_FREQ_MASKS = 2
SPEC_FREQ_WIDTH = 20   # max bins per frequency mask


def spec_augment_features(feats: np.ndarray, seed: int, epoch: int,
                          utt_idx: int, copy: bool = True) -> np.ndarray:
    """Mask random time/frequency stripes of a [T, F] feature matrix
    with its mean. Copies by default (inputs may be cached);
    ``copy=False`` fills the stripes in place and needs a float32
    ndarray view of the caller's buffer."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, epoch, utt_idx, 0x5bec]))
    if copy:
        out = np.asarray(feats).astype(np.float32, copy=True)
    else:
        out = np.asarray(feats, np.float32)
        # shares_memory is False for zero-size arrays even when asarray
        # returned the same object: identity first.
        if out is not feats and not np.shares_memory(out, feats):
            raise ValueError(
                f"spec_augment_features(copy=False) needs a float32 "
                f"ndarray view, got "
                f"dtype={getattr(feats, 'dtype', type(feats).__name__)}")
    t, f = out.shape
    fill = float(out.mean()) if out.size else 0.0
    # The published policy's p*T bound: short utterances keep most of
    # their frames while the whole transcript stays the target.
    t_cap = min(SPEC_TIME_WIDTH, int(SPEC_TIME_FRAC * t))
    for _ in range(SPEC_TIME_MASKS):
        w = int(rng.integers(0, t_cap + 1))
        if w:
            start = int(rng.integers(0, t - w + 1))
            out[start:start + w, :] = fill
    for _ in range(SPEC_FREQ_MASKS):
        w = int(rng.integers(0, min(SPEC_FREQ_WIDTH, f) + 1))
        if w:
            start = int(rng.integers(0, f - w + 1))
            out[:, start:start + w] = fill
    return out
