"""The port's Inferencer and greedy decoder against the JAX package's:
identical transcripts in float32 from the same bridged weights."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.decode.greedy import \
    collapse_ids_with_times as jax_collapse_ids_with_times
from deepspeech_tpu.decode.greedy import greedy_decode as jax_greedy_decode
from deepspeech_tpu.infer import Inferencer as JaxInferencer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.data.synthetic import synthetic_batch
from deepspeech_tpu_torch import infer
from deepspeech_tpu_torch.decode.greedy import (collapse_ids_with_times,
                                                greedy_decode)
from deepspeech_tpu_torch.infer import Inferencer, main
from deepspeech_tpu_torch.metrics import cer, wer
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

OVER = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
        "model.conv_channels": "4,4", "model.dtype": "float32",
        "model.rnn_impl": "pallas", "data.batch_size": "2",
        "data.bucket_frames": "24,40"}


def _request(cfg):
    """Three utterances of 10, 33 and 37 frames -> two ladder rungs."""
    batch, _ = synthetic_batch(cfg, 3, 40, 4, seed=5)
    batch["feat_lens"] = np.array([10, 33, 37], np.int32)
    for i, n in enumerate(batch["feat_lens"]):
        batch["features"][i, n:] = 0.0
    return batch


def test_bucketed_greedy_transcripts_match_jax():
    jcfg = jax_apply_overrides(jax_get_config("ds2_small"), OVER)
    tcfg = apply_overrides(get_config("ds2_small"), OVER)
    batch = _request(tcfg)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.asarray(batch["features"]),
        jnp.asarray(batch["feat_lens"]), np.random.default_rng(4))
    # Spread the logits so no frame's argmax is a near tie.
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0

    ref = JaxInferencer(jcfg, JaxCharTokenizer.english(), params,
                        stats).decode_batch_bucketed(batch)
    inf = Inferencer(tcfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    got = inf.decode_batch_bucketed(batch)
    assert got == ref
    assert any(got)
    assert inf._last_nbest is None and inf._last_times is None
    assert inf.ladder() == [(1, 24), (2, 24), (1, 40), (2, 40)]


def test_greedy_collapse_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 30, 6)).astype(np.float32)
    logits[:, ::3, 0] += 3.0  # blanks between repeats
    logits[1, 5:9, 2] += 9.0  # a repeat run
    lens = np.array([30, 12, 1, 0], np.int32)
    ref_ids, ref_lens = jax_greedy_decode(jnp.asarray(logits),
                                          jnp.asarray(lens))
    ids, out_lens = greedy_decode(torch.from_numpy(logits),
                                  torch.from_numpy(lens).long())
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


def test_collapse_with_times_matches_jax():
    rng = np.random.default_rng(1)
    best = rng.integers(0, 5, size=(4, 40)).astype(np.int32)
    best[0, :6] = [0, 3, 3, 0, 3, 3]  # a repeat parted by a blank
    best[2, -4:] = 2                  # a run to the last frame
    lens = np.array([40, 17, 40, 0], np.int32)
    want = jax_collapse_ids_with_times(jnp.asarray(best), jnp.asarray(lens))
    got = collapse_ids_with_times(torch.from_numpy(best).long(),
                                  torch.from_numpy(lens).long())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_run_through_device_prefetch_equals_pageable(monkeypatch):
    """``run`` feeds the offline modes through ``device_prefetch``; its
    transcripts and WER/CER equal decoding each host batch as it is."""
    cfg = apply_overrides(get_config("ds2_small"), OVER)
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    batches = [(synthetic_batch(cfg, 2, 40, 6, seed=s)[0], 2 - s % 2)
               for s in range(3)]
    inf = Inferencer(cfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    fed = []
    real = infer.device_prefetch

    def counting(it, device, depth=2):
        for b in real(it, device, depth):
            fed.append(b)
            yield b

    monkeypatch.setattr(infer, "device_prefetch", counting)

    class Log:
        hyps = []

        def log(self, event, **f):
            if event == "utt":
                self.hyps.append(f["hyp"])

    log = Log()
    summary = inf.run(batches, log)
    assert len(fed) == 3 and all(isinstance(b["features"], torch.Tensor)
                                 for b in fed)
    assert [b["features"].shape for b in fed] == [(2, 40, 161)] * 3
    pageable = [t for b, n in batches for t in inf.decode_batch(b)[:n]]
    assert log.hyps == pageable and any(pageable)
    refs = [CharTokenizer.english().decode(row[:n]) for b, k in batches
            for row, n in list(zip(b["labels"], b["label_lens"]))[:k]]
    assert summary == {"wer": wer(refs, pageable), "cer": cer(refs, pageable),
                       "n_utts": 5}


def test_cli_synthetic_with_saved_params(tmp_path, capsys):
    cfg = apply_overrides(get_config("ds2_streaming"),
                          {k: v for k, v in OVER.items()
                           if k != "data.bucket_frames"})
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    path = str(tmp_path / "w.npz")
    bridge.save_npz(path, params, stats)
    args = ["--config=ds2_streaming", "--synthetic=4", f"--params={path}",
            "--device=cpu", "--data.bucket_frames=48"]
    main(args + [f"--{k}={v}" for k, v in OVER.items()
                 if k != "data.bucket_frames"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith('{"event": "done"')
    assert sum('"event": "utt"' in ln for ln in lines) == 4


@pytest.mark.parametrize("over", [{"decode.mode": "beam"},
                                  {"decode.mode": "beam_fused"},
                                  {"decode.lm_path": "lm.arpa"},
                                  {"decode.mode": "sp_greedy"}])
def test_unported_decode_options_raise(over):
    cfg = apply_overrides(get_config("ds2_small"), {**OVER, **over})
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        Inferencer(cfg, CharTokenizer.english(), params, stats, device="cpu")


def test_orbax_restore_raises(tmp_path, monkeypatch):
    """``params=None`` restores ``train.checkpoint_dir``: an empty
    directory raises, and an orbax one without ``tensorstore`` raises
    naming the converter."""
    cfg = apply_overrides(get_config("ds2_small"),
                          {"train.checkpoint_dir": str(tmp_path / "none")})
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Inferencer(cfg, CharTokenizer.english(), device="cpu")
    (tmp_path / "jax" / "7").mkdir(parents=True)
    (tmp_path / "jax" / "7" / "_CHECKPOINT_METADATA").write_text("{}")
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    cfg = apply_overrides(cfg, {"train.checkpoint_dir": str(tmp_path / "jax")})
    with pytest.raises(ImportError, match="orbax.*checkpoint_import"):
        Inferencer(cfg, CharTokenizer.english(), device="cpu")
