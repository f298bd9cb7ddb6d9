"""The port's live serving entry point (``serve.py``) and the timestamps
of its ``Inferencer`` against the JAX package's, on the same numpy
weights, with the JAX side on its Pallas GRU kernels in interpret mode:

- ``serve_files``' JSONL (chunk partials, segments, finals; every field
  but the wall-clock ``ms``) equals the JAX ``serve_files``' on WAVs
  written here, with endpointing off and on, and with int8 weights;
- ``serve_files_pooled``' JSONL (``replica_map``, partials, finals)
  equals the JAX ``serve_files_pooled``', with and without
  ``migrate_sessions``, and with int8 weights;
- ``main`` prints those lines from an ``.npz`` on the CPU (with
  ``--replicas=2 --migrate-sessions`` too), refuses ``--replicas`` with
  endpointing, and exits naming the slice for each flag of a later
  slice;
- ``serve_files``' finals equal ``Inferencer(decode.mode="streaming")``'s
  transcripts;
- ``decode.timestamps`` in the greedy and streaming modes stashes the JAX
  ``Inferencer``'s ``times`` and ``word_times``, and ``run`` logs them.
"""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu import serve as jax_serve
from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.infer import Inferencer as JaxInferencer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu_torch import bridge, serve
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer, featurize_np, load_audio
from deepspeech_tpu_torch.infer import Inferencer
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

OVER = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
        "model.conv_channels": "4,4", "model.lookahead_context": "4",
        "model.dtype": "float32", "model.rnn_impl": "pallas",
        "data.batch_size": "4", "data.bucket_frames": "128,320"}


def _write_wav(path, audio, rate=16000):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16)
                      .tobytes())


def _speech(rng, seconds):
    """A burst of tones in noise, standing in for speech."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
            + 0.05 * rng.normal(size=t.shape))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(jax cfg, port cfg, params, stats, wav paths): three WAVs of
    speech bursts parted by 0.6 s of silence, of ragged lengths."""
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(3)
    paths = []
    for i, bursts in enumerate([(0.7, 0.9), (1.1,), (0.4, 0.5, 0.3)]):
        parts = []
        for sec in bursts:
            parts += [_speech(rng, sec), np.zeros(int(0.6 * 16000))]
        path = os.path.join(str(root), f"s{i}.wav")
        _write_wav(path, np.concatenate(parts[:-1]))
        paths.append(path)
    jcfg = jax_apply_overrides(jax_get_config("ds2_streaming"), OVER)
    tcfg = apply_overrides(get_config("ds2_streaming"), OVER)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.zeros((1, 64, 161), jnp.float32),
        jnp.full((1,), 64, jnp.int32), np.random.default_rng(9))
    params = jax.tree.map(np.asarray, params)
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return jcfg, tcfg, params, stats, paths


def _lines(text):
    out = [json.loads(x) for x in text.strip().splitlines()]
    for rec in out:
        rec.pop("ms", None)
    return out


def _both(setup, tmp_path, **kw):
    jcfg, tcfg, params, stats, paths = setup
    want_f, got_f = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    with open(want_f, "w") as fh:
        want = jax_serve.serve_files(jcfg, JaxCharTokenizer.english(),
                                     params, stats, paths, out=fh, **kw)
    with open(got_f, "w") as fh:
        got = serve.serve_files(tcfg, CharTokenizer.english(), params,
                                stats, paths, out=fh, device="cpu", **kw)
    return (want, _lines(want_f.read_text())), (got,
                                                _lines(got_f.read_text()))


@pytest.mark.parametrize("kw", [
    {}, {"endpoint_silence_ms": 300}, {"quantize": "int8"},
    {"quantize": "int8", "endpoint_silence_ms": 300, "endpoint_db": 30.0}],
    ids=["greedy", "endpointing", "int8", "int8-endpointing"])
def test_serve_files_matches_jax(setup, tmp_path, kw):
    (want, want_lines), (got, got_lines) = _both(setup, tmp_path, **kw)
    assert got == want and any(got)
    assert got_lines == want_lines
    assert got_lines[-1] == {"final": got}
    if kw.get("endpoint_silence_ms"):
        assert any("segment" in rec for rec in got_lines)
    chunks = [rec for rec in got_lines if "chunk" in rec]
    assert [rec["chunk"] for rec in chunks] == list(range(len(chunks)))


def test_endpointing_inside_the_lag_refused(setup):
    _, tcfg, params, stats, paths = setup
    with pytest.raises(ValueError, match="decode lag"):
        serve.serve_files(tcfg, CharTokenizer.english(), params, stats,
                          paths, endpoint_silence_ms=100, device="cpu")


def test_serve_finals_equal_streaming_inferencer(setup, tmp_path):
    _, tcfg, params, stats, paths = setup
    with open(tmp_path / "out.jsonl", "w") as fh:
        finals = serve.serve_files(tcfg, CharTokenizer.english(), params,
                                   stats, paths, out=fh, device="cpu")
    cfg = apply_overrides(tcfg, {"decode.mode": "streaming"})
    feats = [featurize_np(load_audio(p, 16000), cfg.features) for p in paths]
    lens = np.asarray([f.shape[0] for f in feats], np.int32)
    batch = np.zeros((3, lens.max(), 161), np.float32)
    for i, f in enumerate(feats):
        batch[i, :len(f)] = f
    inf = Inferencer(cfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    assert inf.decode_batch({"features": batch, "feat_lens": lens}) == finals


def test_main_prints_jax_lines(setup, tmp_path, capsys):
    jcfg, _, params, stats, paths = setup
    npz = str(tmp_path / "w.npz")
    bridge.save_npz(npz, params, stats)
    with open(tmp_path / "jax.jsonl", "w") as fh:
        jax_serve.serve_files(jcfg, JaxCharTokenizer.english(), params,
                              stats, paths, out=fh)
    serve.main([f"--params={npz}", "--device=cpu", *paths]
               + [f"--{k}={v}" for k, v in OVER.items()])
    got = _lines(capsys.readouterr().out)
    assert got == _lines((tmp_path / "jax.jsonl").read_text())


LATER = {"slice 4b": ("--models=a=x", "--tenant-config=t.json",
                      "--swap-checkpoint=x", "--swap-at-chunk=3",
                      "--swap-wer-guardrail=0.1", "--autoscale",
                      "--autoscale-min=2", "--autoscale-max=3",
                      "--autoscale-cooldown=2", "--status-port=0",
                      "--timeline=x"),
         "slice 4c": ("--session-journal=x", "--journal-every=2",
                      "--handoff-listen=0", "--handoff-peer=h:1"),
         "item 17": ("--warm-store=x",),
         "slice 6": ("--lm-rescore", "--decode=beam",
                     "--quant-tier=premium")}


@pytest.mark.parametrize("flag", [f for fs in LATER.values() for f in fs])
def test_main_refuses_later_flags(flag):
    where, = [w for w, fs in LATER.items() if flag in fs]
    with pytest.raises(SystemExit, match=where):
        serve.main([flag, "--params=x.npz", "--device=cpu", "a.wav"])
    with pytest.raises(SystemExit, match=where):
        serve.main([flag, "--replicas=2", "--migrate-sessions",
                    "--params=x.npz", "--device=cpu", "a.wav"])


def test_main_refuses_replicas_with_endpointing():
    with pytest.raises(ValueError, match="does not compose"):
        serve.main(["--params=x.npz", "--replicas=2",
                    "--endpoint-silence-ms=500", "--device=cpu", "x.wav"])


@pytest.mark.parametrize("kw", [
    {}, {"migrate_sessions": True}, {"quantize": "int8"},
    {"replicas": 3, "migrate_sessions": True}],
    ids=["pooled", "migrate", "int8", "three-replicas"])
def test_serve_files_pooled_matches_jax(setup, tmp_path, kw):
    """``--replicas``' JSONL (``replica_map``, every chunk's partials,
    the finals; every field but the wall-clock ``ms``) equals the JAX
    ``serve_files_pooled``'."""
    jcfg, tcfg, params, stats, paths = setup
    kw = {"replicas": 2, **kw}
    want_f, got_f = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    with open(want_f, "w") as fh:
        want = jax_serve.serve_files_pooled(
            jcfg, JaxCharTokenizer.english(), params, stats, paths,
            out=fh, **kw)
    with open(got_f, "w") as fh:
        got = serve.serve_files_pooled(tcfg, CharTokenizer.english(),
                                       params, stats, paths, out=fh,
                                       device="cpu", **kw)
    got_lines = _lines(got_f.read_text())
    assert got == want and any(got)
    assert got_lines == _lines(want_f.read_text())
    assert set(got_lines[0]["replica_map"]) == {"0", "1", "2"}
    assert got_lines[-1] == {"final": got}


def test_main_pooled_prints_jax_lines(setup, tmp_path, capsys):
    """``serve --replicas=2 --migrate-sessions`` on the CPU prints the
    JAX ``serve_files_pooled``' lines."""
    jcfg, _, params, stats, paths = setup
    npz = str(tmp_path / "w.npz")
    bridge.save_npz(npz, params, stats)
    with open(tmp_path / "jax.jsonl", "w") as fh:
        jax_serve.serve_files_pooled(jcfg, JaxCharTokenizer.english(),
                                     params, stats, paths, replicas=2,
                                     migrate_sessions=True, out=fh)
    serve.main([f"--params={npz}", "--device=cpu", "--replicas=2",
                "--migrate-sessions", *paths]
               + [f"--{k}={v}" for k, v in OVER.items()])
    got = _lines(capsys.readouterr().out)
    assert got == _lines((tmp_path / "jax.jsonl").read_text())


def test_main_needs_weights_and_cuda(setup, tmp_path, monkeypatch):
    """Without ``--device=cpu`` the CLI runs on the card, and without
    CUDA it raises rather than run on the CPU unasked."""
    _, _, params, stats, paths = setup
    with pytest.raises(SystemExit, match="checkpoint-dir or --params"):
        serve.main(["--device=cpu", *paths])
    npz = str(tmp_path / "w.npz")
    bridge.save_npz(npz, params, stats)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main([f"--params={npz}", *paths]
                   + [f"--{k}={v}" for k, v in OVER.items()])


def _batch(n_feat=161, seed=4):
    rng = np.random.default_rng(seed)
    lens = np.asarray([300, 211, 97], np.int32)
    feats = np.zeros((3, 300, n_feat), np.float32)
    for i, n in enumerate(lens):
        feats[i, :n] = rng.normal(size=(n, n_feat))
    labels = rng.integers(1, 29, size=(3, 12)).astype(np.int32)
    return {"features": feats, "feat_lens": lens, "labels": labels,
            "label_lens": np.asarray([12, 9, 5], np.int32)}


class _Events:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


@pytest.mark.parametrize("mode", ["greedy", "streaming"])
def test_timestamps_match_jax(setup, mode):
    jcfg, tcfg, params, stats, _ = setup
    over = {"decode.mode": mode, "decode.timestamps": "true"}
    jcfg = jax_apply_overrides(jcfg, over)
    tcfg = apply_overrides(tcfg, over)
    batch = _batch()
    ref = JaxInferencer(jcfg, JaxCharTokenizer.english(), params, stats)
    inf = Inferencer(tcfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    want = ref.decode_batch_bucketed(batch)
    got = inf.decode_batch_bucketed(batch)
    assert got == want and any(got)
    assert inf._last_times == ref._last_times
    assert inf._last_word_times == ref._last_word_times
    assert any(inf._last_times)

    log = _Events()
    inf.run([(batch, 3)], log)
    utts = [f for e, f in log.events if e == "utt"]
    assert [u["hyp"] for u in utts] == inf.decode_batch(batch)
    assert [u["times"] for u in utts] == inf._last_times
    assert [u["word_times"] for u in utts] == inf._last_word_times


def test_timestamps_refused_outside_aligned_modes(setup):
    _, tcfg, params, stats, _ = setup
    cfg = apply_overrides(tcfg, {"decode.mode": "beam",
                                 "decode.timestamps": "true"})
    with pytest.raises(ValueError, match="unique alignment"):
        Inferencer(cfg, CharTokenizer.english(), params, stats,
                   device="cpu")
