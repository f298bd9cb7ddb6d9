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


# The ids are the cases' names from when all four raised.
@pytest.mark.parametrize("over", [{"decode.mode": "sp_greedy"},
                                  {"decode.mode": "sp_beam"},
                                  {"decode.mode": "rnnt_greedy"},
                                  {"decode.mode": "rnnt_beam"}],
                         ids=["over0", "over1", "over2", "over3"])
def test_unported_decode_options_raise(over):
    """The decode modes the port once refused. The sequence-parallel
    ones decode now (tests/test_torch_seqpar.py holds them to JAX's);
    the transducer's raise naming the queue item that brings them."""
    cfg = apply_overrides(get_config("ds2_small"), {**OVER, **over})
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    if over["decode.mode"].startswith("sp_"):
        inf = Inferencer(cfg, CharTokenizer.english(), params, stats,
                         device="cpu")
        texts = inf.decode_batch(_request(cfg))
        assert len(texts) == 3 and all(isinstance(t, str) for t in texts)
        return
    with pytest.raises(NotImplementedError, match="item 15"):
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


# -- beam modes -------------------------------------------------------------

# A word LM over English letters (rescoring and host fusion), and a
# character trigram over a, b, c (device fusion; other letters -> <unk>).
WORD_ARPA = """\
\\data\\
ngram 1=6
ngram 2=3

\\1-grams:
-0.5\t<s>\t-0.30103
-0.9\t</s>
-0.6\tab\t-0.30103
-0.7\tba\t-0.30103
-0.8\tcab\t-0.2
-1.2\t<unk>

\\2-grams:
-0.2\t<s> ab
-0.3\tab ba
-0.4\tba </s>

\\end\\
"""


def _zh_arpa(chars, rng) -> str:
    """A random character trigram ARPA over ``chars``, with <unk>."""
    lines = ["\\1-grams:", "-99.0\t<s>\t-0.4", "-1.5\t</s>",
             "-2.5\t<unk>\t-0.3"]
    lines += [f"{rng.uniform(-4, -1):.4f}\t{c}\t{rng.uniform(-0.6, 0):.4f}"
              for c in chars]
    grams = {2: set(), 3: set()}
    for n in (2, 3):
        while len(grams[n]) < 60:
            grams[n].add(tuple(chars[int(i)] for i in
                               rng.integers(len(chars), size=n)))
    lines += ["", "\\2-grams:"]
    lines += [f"{rng.uniform(-3, -0.5):.4f}\t{' '.join(g)}\t"
              f"{rng.uniform(-0.5, 0):.4f}" for g in sorted(grams[2])]
    lines += ["", "\\3-grams:"]
    lines += [f"{rng.uniform(-2, -0.3):.4f}\t{' '.join(g)}"
              for g in sorted(grams[3])]
    head = ["\\data\\", f"ngram 1={len(chars) + 3}", "ngram 2=60",
            "ngram 3=60", ""]
    return "\n".join(head + lines + ["", "\\end\\", ""])


def _lm_file(tmp_path, kind, tok):
    if kind is None:
        return ""
    if kind == "word":
        text = WORD_ARPA
    elif kind == "char":
        from test_torch_ngram import write_char_arpa
        return write_char_arpa(tmp_path, with_unk=True)
    else:
        text = _zh_arpa(tok.chars[:80], np.random.default_rng(3))
    path = tmp_path / f"{kind}.arpa"
    path.write_text(text)
    return str(path)


BEAM_CASES = [
    ("ds2_beam_lm", "beam", None, {}),
    ("ds2_beam_lm", "beam", None, {"decode.merge_impl": "sort"}),
    ("ds2_beam_lm", "beam", "word", {}),
    ("ds2_beam_lm", "beam_fused_device", "char",
     {"decode.device_lm_impl": "dense"}),
    ("ds2_beam_lm", "beam_fused_device", "char",
     {"decode.device_lm_impl": "hashed"}),
    ("ds2_beam_lm", "beam_fused", "word", {"decode.host_impl": "python"}),
    ("ds2_beam_lm", "beam_fused", "word", {"decode.host_impl": "native"}),
    ("aishell", "beam", None, {}),
    ("aishell", "beam_fused_device", "zh", {}),
    ("aishell", "beam_fused", "zh", {"decode.host_impl": "native"}),
]


@pytest.mark.parametrize("preset,mode,lm,extra", BEAM_CASES)
def test_beam_modes_match_jax(tmp_path, preset, mode, lm, extra):
    """``Inferencer`` in a beam mode against the JAX ``Inferencer`` on a
    small f32 model of the ``ds2_beam_lm`` (V=29) or ``aishell``
    (V=4336) shape: identical transcripts, n-best texts equal and their
    scores within 1e-4."""
    zh = preset == "aishell"
    tok = (CharTokenizer.synthetic_zh(4335) if zh
           else CharTokenizer.english())
    jtok = (JaxCharTokenizer.synthetic_zh(4335) if zh
            else JaxCharTokenizer.english())
    over = {**OVER, "decode.mode": mode, "decode.beam_width": "8",
            "decode.nbest": "4", "decode.lm_alpha": "0.8",
            "decode.lm_path": _lm_file(tmp_path, lm, tok), **extra}
    jcfg = jax_apply_overrides(jax_get_config(preset), over)
    tcfg = apply_overrides(get_config(preset), over)
    assert tcfg.model.vocab_size == tok.vocab_size == (4336 if zh else 29)
    batch = _request(tcfg)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.asarray(batch["features"]),
        jnp.asarray(batch["feat_lens"]), np.random.default_rng(4))
    params["head"]["kernel"] = params["head"]["kernel"] * 4.0
    ref = JaxInferencer(jcfg, jtok, params, stats)
    want = ref.decode_batch_bucketed(batch)
    inf = Inferencer(tcfg, tok, params, stats, device="cpu")
    got = inf.decode_batch_bucketed(batch)
    assert got == want and any(got)
    assert len(inf._last_nbest) == 3
    for g, w in zip(inf._last_nbest, ref._last_nbest):
        assert [t for t, _ in g] == [t for t, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=1e-4, rtol=0)
    if mode == "beam_fused_device":
        table = inf._lm_table()
        kind = type(table).__name__
        assert kind == ("HashedFusionTable" if zh or "hashed" in str(extra)
                        else "Tensor")


def test_beam_fused_native_runs_the_cpp_search(tmp_path, monkeypatch):
    """``host_impl="native"`` runs the C++ batch search (counted) and
    raises when the library is not there; "auto" falls to Python only
    where the library is missing."""
    from deepspeech_tpu_torch import native

    over = {**OVER, "decode.mode": "beam_fused", "decode.beam_width": "8",
            "decode.lm_path": _lm_file(tmp_path, "word", None),
            "decode.host_impl": "native"}
    cfg = apply_overrides(get_config("ds2_beam_lm"), over)
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _request(cfg)
    inf = Inferencer(cfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    calls = native.beam_search_batch_native.calls
    texts = inf.decode_batch(batch)
    assert native.beam_search_batch_native.calls == calls + 1
    assert isinstance(inf._native_lm, native.NativeNGram)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "no g++")
    with pytest.raises(RuntimeError, match="no g++"):
        inf.decode_batch(batch)
    auto = apply_overrides(cfg, {"decode.host_impl": "auto"})
    py = Inferencer(auto, CharTokenizer.english(), params, stats,
                    device="cpu")
    assert py.decode_batch(batch) == texts
    assert native.beam_search_batch_native.calls == calls + 1


def test_beam_nbest_surfaces(tmp_path, capsys):
    """``decode_batch_nbest``, ``run``'s ``nbest`` on each ``utt`` line
    when ``decode.nbest`` > 1, and the CLI with ``--decode.lm_path``."""
    over = {**OVER, "decode.beam_width": "8", "decode.nbest": "3"}
    cfg = apply_overrides(get_config("ds2_beam_lm"), over)
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    inf = Inferencer(cfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    batch = _request(cfg)
    nb = inf.decode_batch_nbest(batch)
    assert [x[0][0] for x in nb] == inf.decode_batch(batch)
    assert all(1 <= len(x) <= 3 for x in nb)
    assert all(a[1] >= b[1] for x in nb for a, b in zip(x, x[1:]))

    class Log:
        utts = []

        def log(self, event, **f):
            if event == "utt":
                self.utts.append(f)

    inf.run([(batch, 3)], Log())
    assert [u["nbest"] for u in Log.utts] == nb
    path = str(tmp_path / "w.npz")
    bridge.save_npz(path, params, stats)
    lm = _lm_file(tmp_path, "word", None)
    main(["--config=ds2_beam_lm", "--synthetic=2", f"--params={path}",
          "--device=cpu", f"--decode.lm_path={lm}"]
         + [f"--{k}={v}" for k, v in over.items()])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith('{"event": "done"')
    assert sum('"nbest"' in ln for ln in lines) == 2
