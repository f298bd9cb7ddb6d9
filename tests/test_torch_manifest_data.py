"""The port's manifest data path (manifest, SortaGrad sampler,
augmentation, quarantine, tokenizer policy, DataPipeline, the tensor
featurizer, device_prefetch on the CPU) against the JAX package's, on
the same WAV files and seeds.

Everything on the host is numpy on both sides, so the batches must be
equal bit for bit; the one tolerance is the tensor ``featurize`` against
the JAX ``featurize`` (1e-4 in float32: the two FFTs sum in different
orders, as the JAX package's own ``featurize_np`` test allows).
"""

import dataclasses
import json
import os
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import augment as jax_augment
from deepspeech_tpu.data import manifest as jax_manifest
from deepspeech_tpu.data import pipeline as jax_pipeline
from deepspeech_tpu.data import sampler as jax_sampler
from deepspeech_tpu.data import tokenizer as jax_tokenizer
from deepspeech_tpu.data.features import featurize as jax_featurize
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import (DataPipeline, SortaGradSampler,
                                       Utterance, augment_audio,
                                       device_prefetch, featurize,
                                       load_manifest, resolve_tokenizer,
                                       save_manifest, scrub_padded_batch,
                                       scrub_samples, spec_augment_features)
from deepspeech_tpu_torch.data.tokenizer import CharTokenizer

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

# Small buckets (0.4, 0.8 and 1.3 s) and batches; the features keep the
# presets' 161 bins.
OVER = {"data.batch_size": "4", "data.bucket_frames": "40,80,130",
        "data.max_label_len": "24", "data.min_duration_s": "0.3",
        "data.max_duration_s": "1.3"}
LETTERS = "abcdefghijklmnopqrstuvwxyz '"


def write_wav(path: str, audio: np.ndarray, rate: int = 16000) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16)
                      .tobytes())


def write_corpus(root: str, n: int, seed: int, lo_s: float = 0.32,
                 hi_s: float = 1.28, name: str = "train") -> str:
    """``n`` 16 kHz 16-bit WAVs of ``lo_s``..``hi_s`` seconds (tones in
    noise) with random English transcripts of about 0.15 characters a
    frame, and their manifest; returns the manifest's path."""
    rng = np.random.default_rng(seed)
    utts = []
    for i in range(n):
        dur = round(float(rng.uniform(lo_s, hi_s)), 3)
        t = np.arange(int(dur * 16000)) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
                 + 0.05 * rng.normal(size=t.shape))
        path = os.path.join(root, f"{name}{i}.wav")
        write_wav(path, audio)
        text = "".join(rng.choice(list(LETTERS),
                                  size=max(int(0.15 * dur * 100) // 2, 1)))
        utts.append(Utterance(path, text.strip() or "a", dur))
    manifest = os.path.join(root, f"{name}.jsonl")
    save_manifest(manifest, utts)
    return manifest


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wavs"))
    return write_corpus(root, 22, seed=3)


def _configs(over=None):
    over = dict(OVER, **(over or {}))
    return (jax_apply_overrides(jax_get_config("ds2_small"), over),
            apply_overrides(get_config("ds2_small"), over))


def _assert_batches_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k


def test_manifest_round_trip_and_errors_match_jax(tmp_path, corpus):
    got = load_manifest(corpus, 0.5, 1.0)
    ref = jax_manifest.load_manifest(corpus, 0.5, 1.0)
    assert [dataclasses.astuple(u) for u in got] == \
        [dataclasses.astuple(u) for u in ref]
    out = str(tmp_path / "zh.jsonl")
    utts = [Utterance("a.wav", "你好 world", 1.5)]
    save_manifest(out, utts)
    with open(out, encoding="utf-8") as f:
        assert json.loads(f.read()) == {"audio": "a.wav",
                                        "text": "你好 world",
                                        "duration": 1.5}
    assert load_manifest(out) == utts
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write('{"audio": "a.wav", "duration": 1.0}\n')
    for fn in (load_manifest, jax_manifest.load_manifest):
        with pytest.raises(ValueError, match="bad.jsonl:1: bad manifest"):
            fn(bad)
        with pytest.raises(ValueError, match="no utterances within"):
            fn(out, max_duration_s=1.0)


@pytest.mark.parametrize("seed,buckets,bs,sortagrad", [
    (1234, (40, 80, 130), 4, True),
    (7, (40, 80, 130), 3, True),
    (99, (60, 130), 2, False),
    (5, (50,), 4, True)])
def test_sampler_plans_match_jax(seed, buckets, bs, sortagrad):
    durs = np.random.default_rng(seed).uniform(0.2, 1.5, size=37)
    args = (durs, 100.0, buckets, bs)
    got = SortaGradSampler(*args, sortagrad=sortagrad, seed=seed)
    ref = jax_sampler.SortaGradSampler(*args, sortagrad=sortagrad, seed=seed)
    for epoch in range(3):
        plans = list(got.epoch(epoch))
        refs = list(ref.epoch(epoch))
        assert len(plans) == len(refs) == got.batches_per_epoch(epoch) \
            == ref.batches_per_epoch(epoch)
        for p, r in zip(plans, refs):
            np.testing.assert_array_equal(p.indices, r.indices)
            assert (p.bucket_frames, p.bucket_id) == (r.bucket_frames,
                                                     r.bucket_id)
    # A pure function of (seed, epoch): asking again gives the same.
    assert [p.indices.tolist() for p in got.epoch(2)] == \
        [p.indices.tolist() for p in plans]


def test_sampler_refusals_match_jax():
    for cls in (SortaGradSampler, jax_sampler.SortaGradSampler):
        # An utterance past the largest bucket is dropped, not refused.
        assert cls([0.5, 2.0], 100.0, (100,), 1).num_utts == 1
        with pytest.raises(ValueError, match="no utterances fit"):
            cls([2.0], 100.0, (100,), 1)


@pytest.mark.parametrize("seed,epoch,idx", [(1234, 0, 0), (1234, 3, 17),
                                            (7, 1, 2)])
def test_augmentation_matches_jax(seed, epoch, idx):
    rng = np.random.default_rng(idx)
    audio = (0.2 * rng.normal(size=4000)).astype(np.float32)
    np.testing.assert_array_equal(
        augment_audio(audio, 16000, seed, epoch, idx),
        jax_augment.augment_audio(audio, 16000, seed, epoch, idx))
    feats = rng.normal(size=(90, 161)).astype(np.float32)
    got = spec_augment_features(feats, seed, epoch, idx)
    np.testing.assert_array_equal(
        got, jax_augment.spec_augment_features(feats, seed, epoch, idx))
    assert not np.array_equal(got, feats)
    # copy=False masks the caller's buffer in place, and only a float32
    # view of it.
    buf = feats.copy()
    assert spec_augment_features(buf, seed, epoch, idx, copy=False) is buf
    np.testing.assert_array_equal(buf, got)
    with pytest.raises(ValueError, match="float32 ndarray view"):
        spec_augment_features(feats.astype(np.float64), seed, epoch, idx,
                              copy=False)


def _corrupt_lists():
    rng = np.random.default_rng(2)
    feats = [rng.normal(size=(n, 8)).astype(np.float32)
             for n in (20, 30, 12, 25)]
    feats[1][3, 2] = np.nan
    labels = [[1, 2, 3], [4, 5], [6] * 9, []]
    return feats, labels


@pytest.mark.parametrize("all_bad", [False, True])
def test_scrub_samples_matches_jax(all_bad):
    feats, labels = _corrupt_lists()
    if all_bad:
        labels[0] = [1] * 12
    kw = dict(bucket_frames=24, max_label_len=10, time_stride=2,
              ids=["a", "b", "c", "d"])
    seen = []
    got = scrub_samples(feats, labels, **kw,
                        on_quarantine=lambda *a: seen.append(a))
    ref = jax_pipeline.scrub_samples(feats, labels, **kw)
    assert got[1] == ref[1] and got[2] == ref[2] == len(seen)
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    assert [s[1] for s in seen][:3] == (
        ["overlong_label", "nonfinite_features", "overlong_label"]
        if all_bad else
        ["nonfinite_features", "overlong_label", "empty_label"])
    assert scrub_samples(feats, labels, **kw, enabled=False)[2] == 0


def test_scrub_padded_batch_matches_jax():
    rng = np.random.default_rng(4)

    def batch():
        b = {"features": rng.normal(size=(4, 10, 3)).astype(np.float32),
             "feat_lens": np.array([10, 9, 8, 7], np.int32),
             "labels": rng.integers(1, 5, size=(4, 4)).astype(np.int32),
             "label_lens": np.array([4, 0, 3, 2], np.int32)}
        b["features"][2, 1, 1] = np.nan
        return b

    a = batch()
    b = {k: v.copy() for k, v in a.items()}
    got, n = scrub_padded_batch(a, ids=["w", "x", "y", "z"])
    ref, n_ref = jax_pipeline.scrub_padded_batch(b, ids=["w", "x", "y", "z"])
    assert n == n_ref == 2
    _assert_batches_equal(got, ref)
    for donorless in (a, b):
        donorless["features"][:] = np.nan
    got, n = scrub_padded_batch(a)
    ref, n_ref = jax_pipeline.scrub_padded_batch(b)
    assert n == n_ref == 4
    _assert_batches_equal(got, ref)


@pytest.mark.parametrize("case", ["en", "zh_vocab", "zh_ckpt_vocab",
                                  "zh_train", "zh_infer", "zh_synthetic"])
def test_resolve_tokenizer_matches_jax(tmp_path, case):
    utts = [Utterance("a.wav", "你好吗", 1.0), Utterance("b.wav", "好的", 1.0)]
    ck = {"jax": str(tmp_path / "jck"), "port": str(tmp_path / "tck")}
    over = {"data.language": "zh"} if case != "en" else {}
    kw = {}
    if case == "zh_vocab":
        vocab = str(tmp_path / "v.txt")
        CharTokenizer(["的", "好", "吗"]).save_vocab(vocab)
        kw["vocab_override"] = vocab
    if case == "zh_ckpt_vocab":
        for d in ck.values():
            os.makedirs(d)
            CharTokenizer(["吗", "好"]).save_vocab(os.path.join(d,
                                                               "vocab.txt"))
    if case in ("zh_train", "zh_infer"):
        kw.update(utterances=utts, for_training=case == "zh_train")
    if case == "zh_synthetic":
        kw["synthetic"] = True
    results = []
    for side, (resolve, get_cfg, set_cfg) in {
            "jax": (jax_tokenizer.resolve_tokenizer, jax_get_config,
                    jax_apply_overrides),
            "port": (resolve_tokenizer, get_config, apply_overrides)}.items():
        cfg = set_cfg(get_cfg("ds2_small"),
                      {**over, "train.checkpoint_dir": ck[side]})
        if case == "zh_infer":
            with pytest.raises(ValueError, match="needs a vocab file"):
                resolve(cfg, **kw)
            continue
        tok, cfg = resolve(cfg, **kw)
        saved = os.path.join(ck[side], "vocab.txt")
        results.append((tok.chars, cfg.model.vocab_size,
                        open(saved, encoding="utf-8").read()
                        if os.path.exists(saved) else None))
    if case != "zh_infer":
        assert results[0] == results[1]
    if case == "zh_train":
        assert results[1][2] == "你\n好\n吗\n的\n"


def test_pipeline_batches_match_jax(corpus):
    """peek, epoch 0 (sorted), epoch 1 with waveform augmentation and
    SpecAugment (shuffled), and eval_epoch: equal key for key, bit for
    bit."""
    aug = {"data.augment": "true", "data.spec_augment": "true"}
    jcfg, tcfg = _configs(aug)
    jpipe = jax_pipeline.DataPipeline(jcfg, jax_tokenizer.CharTokenizer
                                      .english(), corpus)
    tpipe = DataPipeline(tcfg, CharTokenizer.english(), corpus)
    assert tpipe.batches_per_epoch(0) == jpipe.batches_per_epoch(0) == 5
    _assert_batches_equal(tpipe.peek(), jpipe.peek())
    for epoch in (0, 1):
        got, ref = list(tpipe.epoch(epoch)), list(jpipe.epoch(epoch))
        assert len(got) == len(ref) == tpipe.batches_per_epoch(epoch)
        for g, r in zip(got, ref):
            _assert_batches_equal(g, r)
    # A resume's start: the epoch's tail, its skipped plans never loaded.
    seen = []
    real = tpipe._materialize
    tpipe._materialize = lambda plan, epoch=None: (seen.append(plan),
                                                   real(plan, epoch))[1]
    tail = list(tpipe.epoch(1, start=2))
    assert len(tail) == len(seen) == len(got) - 2
    for g, r in zip(tail, got[2:]):
        _assert_batches_equal(g, r)
    del tpipe._materialize
    plain = list(DataPipeline(_configs()[1], CharTokenizer.english(),
                              corpus).epoch(1))
    assert any(not np.array_equal(p["features"], g["features"])
               for p, g in zip(plain, got))
    got, ref = list(tpipe.eval_epoch()), list(jpipe.eval_epoch())
    assert [n for _, n in got] == [n for _, n in ref]
    assert sum(n for _, n in got) == len(tpipe.utts)
    for (g, _), (r, _) in zip(got, ref):
        _assert_batches_equal(g, r)
    assert tpipe.quarantined == 0


def test_featurize_matches_jax_within_1e4():
    cfg = get_config("ds2_small").features
    audio = (0.3 * np.random.default_rng(8).normal(size=9137)
             ).astype(np.float32)
    got = featurize(torch.from_numpy(audio), cfg)
    ref = np.asarray(jax_featurize(jnp.asarray(audio),
                                   jax_get_config("ds2_small").features))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (56, 161)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="one window"):
        featurize(torch.zeros(100), cfg)


def test_pipeline_reraises_worker_errors(tmp_path):
    _, tcfg = _configs()
    utts = [Utterance(str(tmp_path / f"missing{i}.wav"), "ab", 0.5)
            for i in range(8)]
    pipe = DataPipeline(tcfg, CharTokenizer.english(), utterances=utts)
    with pytest.raises(FileNotFoundError):
        next(iter(pipe.epoch(0)))


def test_quarantine_counts_and_logs(tmp_path, corpus):
    """An empty transcript is quarantined: the row takes a donor's, the
    pipeline counts it and its logger gets a corrupt_sample event."""
    _, tcfg = _configs()
    utts = load_manifest(corpus)[:4]
    utts[2] = dataclasses.replace(utts[2], text="")

    class Log:
        events = []

        def log(self, event, **fields):
            self.events.append((event, fields))

    pipe = DataPipeline(tcfg, CharTokenizer.english(), utterances=utts,
                        logger=Log())
    batch = list(pipe.epoch(0))[0]
    assert pipe.quarantined == 1 and (batch["label_lens"] > 0).all()
    (event, fields), = Log.events
    assert event == "corrupt_sample" and fields["trigger"] == "empty_label"
    assert fields["utt"] == utts[2].audio


def test_quarantine_metrics_and_postmortems_match_jax(tmp_path, corpus):
    """On the same corrupt manifest (an empty transcript, a transcript
    too long for its frames) the port's pipeline counts
    ``samples_quarantined`` (bare and per trigger) in the metrics
    registry and writes the ``corrupt_sample`` postmortem records the
    JAX package's writes, field for field."""
    import io

    import deepspeech_tpu.obs as jax_obs
    import deepspeech_tpu.resilience.postmortem as jax_pm
    import deepspeech_tpu_torch.obs as port_obs
    import deepspeech_tpu_torch.resilience.postmortem as port_pm

    jcfg, tcfg = _configs()
    utts = load_manifest(corpus)[:12]
    utts[2] = dataclasses.replace(utts[2], text="")
    utts[7] = dataclasses.replace(utts[7], text="abcdefgh" * 30)
    manifest = str(tmp_path / "corrupt.jsonl")
    save_manifest(manifest, utts)

    def run(obs, pm, make):
        before = dict(obs.registry().counters)
        writer = pm.configure(sink=io.StringIO(),
                              registry=obs.MetricsRegistry())
        try:
            batches = list(make().epoch(0))
            records = [{k: v for k, v in r.items() if k != "ts"}
                       for r in writer.recent()]
        finally:
            pm.configure()
        after = obs.registry().counters
        # The registry is the process's: other tests in this worker
        # may have counted before, so read what this run added.
        counts = {k: after[k] - before.get(k, 0) for k in after
                  if k.startswith("samples_quarantined")
                  and after[k] != before.get(k, 0)}
        return batches, counts, records

    jb, jcounts, jrecords = run(jax_obs, jax_pm, lambda: jax_pipeline
                                .DataPipeline(jcfg, jax_tokenizer
                                              .CharTokenizer.english(),
                                              manifest))
    tb, tcounts, trecords = run(port_obs, port_pm, lambda: DataPipeline(
        tcfg, CharTokenizer.english(), manifest))
    assert tcounts == jcounts
    assert trecords == jrecords
    assert tcounts["samples_quarantined"] == 2
    assert {r["trigger"] for r in trecords} == {"empty_label",
                                                "overlong_label"}
    assert {r["kind"] for r in trecords} == {"corrupt_sample"}
    for g, r in zip(tb, jb):
        _assert_batches_equal(g, r)


def test_device_prefetch_on_cpu_yields_batches_in_order(corpus):
    _, tcfg = _configs()
    host = list(DataPipeline(tcfg, CharTokenizer.english(), corpus)
                .epoch(0))
    for depth in (1, 2, 3):
        got = list(device_prefetch(iter(host), "cpu", depth=depth))
        assert len(got) == len(host)
        for g, h in zip(got, host):
            assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                       for v in g.values())
            _assert_batches_equal({k: v.numpy() for k, v in g.items()}, h)
            g["features"].zero_()  # a copy: the host batch is untouched
            assert h["features"].any()
    with pytest.raises(ValueError, match="depth"):
        next(device_prefetch(iter(host), "cpu", depth=0))
