"""The port's own copies of the host-side data modules, tokenizer and
metrics against the JAX package's: same inputs, same outputs."""

import wave

import numpy as np
import pytest
import torch

from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data.features import featurize_np as jax_featurize_np
from deepspeech_tpu.data.features import num_frames as jax_num_frames
from deepspeech_tpu.data.infer_bucket import (
    plan_infer_buckets as jax_plan_infer_buckets)
from deepspeech_tpu.data.synthetic import (
    synthetic_batch as jax_synthetic_batch)
from deepspeech_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.metrics import cer as jax_cer
from deepspeech_tpu.metrics import wer as jax_wer
from deepspeech_tpu_torch.config import get_config
from deepspeech_tpu_torch.data import (CharTokenizer, featurize_np,
                                       get_tokenizer, load_audio,
                                       num_frames, plan_infer_buckets,
                                       slice_to_plan, synthetic_batch,
                                       unbucket)
from deepspeech_tpu_torch.metrics import cer, edit_distance, wer

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)


def test_featurize_and_load_audio_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    pcm = (rng.uniform(-0.5, 0.5, size=16000 + 123) * 32767).astype(np.int16)
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    audio = load_audio(path, 16000)
    np.testing.assert_array_equal(audio, pcm.astype(np.float32) / 32767)
    feats_cfg = get_config("ds2_small").features
    jax_feats_cfg = jax_get_config("ds2_small").features
    got = featurize_np(audio, feats_cfg)
    np.testing.assert_array_equal(got, jax_featurize_np(audio,
                                                        jax_feats_cfg))
    assert got.shape == (num_frames(len(audio), feats_cfg), 161)
    assert num_frames(len(audio), feats_cfg) == jax_num_frames(
        len(audio), jax_feats_cfg)
    with pytest.raises(ValueError, match="rate"):
        load_audio(path, 8000)


@pytest.mark.parametrize("preset", ["ds2_small", "ds2_streaming"])
def test_synthetic_batch_matches_jax(preset):
    got, labels = synthetic_batch(get_config(preset), 4, 64, 6, seed=3)
    ref, ref_labels = jax_synthetic_batch(jax_get_config(preset), 4, 64, 6,
                                          seed=3)
    assert labels == ref_labels
    assert sorted(got) == sorted(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("lens,max_batch", [
    ([300, 1700, 420, 1999, 800, 801, 5, 1200], 4),
    ([1700] * 9, 4), ([17], 32)])
def test_infer_plans_match_jax(lens, max_batch):
    edges = (400, 800, 1200, 1700)
    plans = plan_infer_buckets(lens, edges, max_batch)
    ref = jax_plan_infer_buckets(lens, edges, max_batch)
    assert [(p.indices.tolist(), p.batch_pad, p.bucket_frames)
            for p in plans] == [(p.indices.tolist(), p.batch_pad,
                                 p.bucket_frames) for p in ref]
    batch = {"features": np.zeros((len(lens), max(lens), 3), np.float32),
             "feat_lens": np.asarray(lens, np.int32)}
    subs = [slice_to_plan(batch, p) for p in plans]
    assert all(s["features"].shape == (p.batch_pad, p.bucket_frames, 3)
               for s, p in zip(subs, plans))
    assert unbucket(plans, [s["feat_lens"] for s in subs]) == list(lens)


def test_tokenizer_matches_jax():
    text = "it's a Deep speech test!"
    ours, ref = get_tokenizer("en"), JaxCharTokenizer.english()
    assert ours.encode(text) == ref.encode(text)
    assert ours.decode([0] + ours.encode(text)) == ref.decode(
        ref.encode(text))
    assert CharTokenizer.from_corpus(["ab", "ca"]).chars == ["a", "b", "c"]
    with pytest.raises(ValueError):
        get_tokenizer("zh")


def test_wer_cer_match_jax_without_levenshtein():
    refs = ["the cat sat", "hello world", "", "a b c d"]
    hyps = ["the cat sat down", "hallo world", "x", "d c b a"]
    assert wer(refs, hyps) == jax_wer(refs, hyps)
    assert cer(refs, hyps) == jax_cer(refs, hyps)
    assert edit_distance("kitten", "sitting") == 3
    assert edit_distance([], [1, 2]) == 2
