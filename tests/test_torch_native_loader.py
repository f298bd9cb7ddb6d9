"""The C++ feature loader (``csrc/host/dsp.cc`` through ``native.py``)
against the JAX package's (``native/src/dsp.cc`` through its
``native/bindings.py``, the same source) within 1e-5, and against the
numpy featurizer within 2e-3 (``tests/test_native.py``'s tolerance);
``DataPipeline``'s native batches against its numpy batches (features
2e-3, lengths and labels exact), and its return to numpy for a batch the
C++ loader cannot read."""

import wave

import numpy as np
import pytest
import torch

from deepspeech_tpu import native as jax_native
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.data import DataPipeline as JaxDataPipeline
from deepspeech_tpu.data.manifest import Utterance as JaxUtterance
from deepspeech_tpu_torch import native
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer, DataPipeline, Utterance
from deepspeech_tpu_torch.data.features import featurize_np, load_audio

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

LENGTHS = [319, 320, 1000, 16000, 48001]
OVER = {"data.batch_size": "3", "data.bucket_frames": "60,120"}


@pytest.fixture(scope="module")
def fcfg():
    return get_config("dev_slice").features


def _write_wav(path, audio, rate=16000, width=2):
    nch = audio.shape[1] if audio.ndim > 1 else 1
    with wave.open(path, "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(width)
        w.setframerate(rate)
        if width == 2:
            w.writeframes((audio * 32767).astype(np.int16).tobytes())
        else:
            w.writeframes(((audio * 127) + 128).astype(np.uint8).tobytes())


@pytest.mark.parametrize("n", LENGTHS)
def test_featurize_native_is_the_jax_loaders(n, fcfg):
    audio = np.random.default_rng(n).normal(size=(n,)).astype(
        np.float32) * 0.3
    got = native.featurize_native(audio, fcfg)
    ref = jax_native.featurize_native(audio, jax_get_config(
        "dev_slice").features)
    assert got.shape == ref.shape
    if ref.size:
        assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("n", LENGTHS)
def test_featurize_native_matches_numpy(n, fcfg):
    audio = np.random.default_rng(n).normal(size=(n,)).astype(
        np.float32) * 0.3
    ref = featurize_np(audio, fcfg)
    got = native.featurize_native(audio, fcfg)
    assert got.shape == ref.shape
    if ref.size:
        assert np.abs(got - ref).max() < 2e-3


def test_load_wav_native_matches_python(tmp_path):
    rng = np.random.default_rng(1)
    for i, (nch, width) in enumerate([(1, 2), (2, 2), (1, 1)]):
        audio = (rng.normal(size=(8000 + i * 777, nch)) * 0.2).clip(-1, 1)
        p = str(tmp_path / f"t{i}.wav")
        _write_wav(p, audio, width=width)
        ref = load_audio(p, 16000)
        got = native.load_wav_native(p, 16000)
        assert ref.shape == got.shape
        assert np.abs(ref - got).max() < 1e-4
    p = str(tmp_path / "r8k.wav")
    _write_wav(p, np.zeros((800,), np.float32), rate=8000)
    with pytest.raises(ValueError, match="rate"):
        native.load_wav_native(p, 16000)


def test_load_featurize_batch_end_to_end(fcfg, tmp_path):
    """Three WAVs and a missing file in one call: the missing row is -1
    and zero, the others the numpy features clipped to the bucket."""
    rng = np.random.default_rng(2)
    paths = []
    for i in range(3):
        audio = (rng.normal(size=(12000 + 3000 * i,)) * 0.2).clip(-1, 1)
        paths.append(str(tmp_path / f"b{i}.wav"))
        _write_wav(paths[-1], audio)
    paths.append(str(tmp_path / "missing.wav"))
    feats, frames = native.load_featurize_batch(paths, fcfg, max_frames=120,
                                                n_threads=2)
    assert feats.shape == (4, 120, fcfg.num_features)
    assert frames[3] == -1 and not feats[3].any()
    for i in range(3):
        ref = featurize_np(load_audio(paths[i], 16000), fcfg)
        t = min(ref.shape[0], 120)
        assert frames[i] == t
        assert np.abs(feats[i, :t] - ref[:t]).max() < 2e-3
        assert not feats[i, t:].any()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(5)
    utts = []
    for i in range(6):
        n = 8000 + 1500 * i
        p = str(root / f"u{i}.wav")
        _write_wav(p, (rng.normal(size=(n,)) * 0.2).clip(-1, 1))
        utts.append((p, "hello world"[: 5 + i], n / 16000.0))
    return utts


def _pipes(corpus, **kw):
    cfg = apply_overrides(get_config("dev_slice"), OVER)
    tok = CharTokenizer.english()
    utts = [Utterance(*u) for u in corpus]
    on = DataPipeline(cfg, tok, utterances=utts, cache=False, **kw)
    off = DataPipeline(apply_overrides(cfg, {"data.native_loader": "false"}),
                       tok, utterances=utts, cache=False)
    return on, off


def test_native_pipeline_matches_numpy_pipeline(corpus):
    """With the cache off the loader takes the C++ path; its eval and
    training batches equal the numpy path's (features within 2e-3,
    lengths and labels exact). With the cache on (a small corpus) it
    keeps numpy, so the bit-equality tests of cached manifests hold."""
    on, off = _pipes(corpus)
    assert on._native and not off._native
    cached = DataPipeline(on.cfg, on.tokenizer,
                          utterances=[Utterance(*u) for u in corpus])
    assert not cached._native
    pairs = list(zip(on.eval_epoch(), off.eval_epoch()))
    pairs += [((a, 0), (b, 0)) for a, b in zip(on.epoch(0), off.epoch(0))]
    assert pairs
    for (bn, _), (bp, _) in pairs:
        np.testing.assert_array_equal(bn["feat_lens"], bp["feat_lens"])
        np.testing.assert_array_equal(bn["labels"], bp["labels"])
        np.testing.assert_array_equal(bn["label_lens"], bp["label_lens"])
        assert np.abs(bn["features"] - bp["features"]).max() < 2e-3
    assert on.native_batches == len(pairs) and on.native_fallbacks == 0
    assert off.native_batches == 0


def test_native_pipeline_is_the_jax_loaders(corpus, monkeypatch):
    """The port's native batches against the JAX pipeline's native
    batches on the same corpus: features within 1e-5, the rest exact."""
    import dataclasses

    jcfg = jax_get_config("dev_slice")
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, batch_size=3, bucket_frames=(60, 120)))
    monkeypatch.setattr(JaxDataPipeline, "MAX_CACHED_UTTS", 0)
    jpipe = JaxDataPipeline(jcfg, JaxCharTokenizer.english(),
                            utterances=[JaxUtterance(*u) for u in corpus])
    assert jpipe._native
    on, _ = _pipes(corpus)
    for (bn, _), (bj, _) in zip(on.eval_epoch(), jpipe.eval_epoch()):
        for k in ("feat_lens", "labels", "label_lens"):
            np.testing.assert_array_equal(bn[k], bj[k])
        assert np.abs(bn["features"] - bj["features"]).max() < 1e-5


def test_a_batch_the_loader_cannot_read_goes_through_numpy(corpus,
                                                           monkeypatch):
    """A file the C++ loader reports unreadable (-1) sends its batch
    through numpy, as the JAX pipeline does, counted in
    ``native_fallbacks``; the batch is the numpy path's."""
    on, off = _pipes(corpus)
    real = native.load_featurize_batch

    def one_unreadable(paths, cfg, max_frames, n_threads=0):
        feats, frames = real(paths, cfg, max_frames, n_threads)
        frames[-1] = -1
        return feats, frames

    monkeypatch.setattr(native, "load_featurize_batch", one_unreadable)
    (bn, _), (bp, _) = next(on.eval_epoch()), next(off.eval_epoch())
    for k in bp:
        np.testing.assert_array_equal(bn[k], bp[k])
    assert (on.native_batches, on.native_fallbacks) == (0, 1)
