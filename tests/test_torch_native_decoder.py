"""The port's C++ host decoder (``csrc/host``, bound by ``native.py``)
against the JAX package's ``native`` bindings, exactly, and against the
Python oracles (``NGramLM``, ``prefix_beam_search_host``); and its build
by ``ops/_build.py`` (g++ is there on the CPU machine)."""

import os

import numpy as np
import pytest
import torch

from deepspeech_tpu import native as jax_native
from deepspeech_tpu_torch import native
from deepspeech_tpu_torch.decode.beam_host import prefix_beam_search_host
from deepspeech_tpu_torch.decode.ngram import NGramLM
from deepspeech_tpu_torch.ops import _build

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

# A word LM over a character vocabulary: blank=0, space=1, a..e = 2..6.
ARPA = """\
\\data\\
ngram 1=7
ngram 2=4

\\1-grams:
-0.5\t<s>\t-0.30103
-0.9\t</s>
-0.6\tab\t-0.30103
-0.7\tba\t-0.30103
-0.8\tcab\t-0.2
-1.0\tace\t-0.1
-1.2\t<unk>

\\2-grams:
-0.2\t<s> ab
-0.3\tab ba
-0.4\tba </s>
-0.25\tab cab
\\end\\
"""

CHARS = {1: " ", 2: "a", 3: "b", 4: "c", 5: "d", 6: "e"}


def id_to_char(i):
    return CHARS.get(int(i), "?")


@pytest.fixture(scope="module")
def arpa_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("lm") / "tiny.arpa"
    p.write_text(ARPA)
    return str(p)


@pytest.fixture(scope="module")
def lms(arpa_path):
    assert native.available(), native.build_error()
    return (NGramLM.from_arpa(arpa_path), native.NativeNGram(arpa_path),
            jax_native.NativeNGram(arpa_path))


def log_probs(rng, t, v, scale=1.5):
    x = rng.normal(size=(t, v)).astype(np.float32) * scale
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def test_library_builds_from_the_port_sources():
    path = _build.build_host()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libds2host-")
    assert _build.load_host() is _build.load_host()
    assert native.available() and native.build_error() is None
    srcs = sorted(os.listdir(_build.HOST_SRC_DIR))
    assert srcs == ["beam.cc", "c_api.h", "internal.h", "ngram.cc"]


def test_ngram_engine_matches_jax_and_python(lms):
    py, cc, ref = lms
    assert cc.order == py.order == ref.order
    for s in ["ab ba", "ba ab", "ab cab ace", "zebra ab", "", "ab ab ab"]:
        for eos in (True, False):
            got = cc.score_sentence(s, eos)
            assert got == ref.score_sentence(s, eos)
            assert got == pytest.approx(py.score_sentence(s, eos), abs=1e-6)
    for hist, w, eos in [([], "ab", False), (["ab"], "ba", False),
                         (["ba"], "ab", False), (["ab"], "zebra", False),
                         (["zebra"], "ab", False), (["ab"], "ba", True),
                         (["ab", "", "ba"], "cab", False)]:
        got = cc.score_word(hist, w, eos)
        assert got == ref.score_word(hist, w, eos)
        assert got == pytest.approx(py.score_word(hist, w, eos), abs=1e-6)


def test_lm_load_failure_raises(tmp_path):
    bad = tmp_path / "empty.arpa"
    bad.write_text("no data here\n")
    with pytest.raises(ValueError, match="failed to load"):
        native.NativeNGram(str(bad))


@pytest.mark.parametrize("mode", ["plain", "pruned", "word", "char"])
def test_beam_search_matches_jax_and_oracle(lms, mode):
    py_lm, c_lm, ref_lm = lms
    rng = np.random.default_rng({"plain": 0, "pruned": 1, "word": 2,
                                 "char": 3}[mode])
    for trial in range(4):
        lp = log_probs(rng, int(rng.integers(6, 20)), 7)
        kw = {"beam_width": 8}
        if mode == "pruned":
            kw["prune_log_prob"] = float(np.log(1e-2))
        elif mode != "plain":
            kw.update(lm_alpha=1.3, lm_beta=0.4, id_to_char=id_to_char,
                      space_id=1 if mode == "word" else None)
        lm = {} if mode in ("plain", "pruned") else {"lm": c_lm}
        ref = {} if not lm else {"lm": ref_lm}
        got = native.beam_search_native(lp, **kw, **lm)
        assert got == jax_native.beam_search_native(lp, **kw, **ref)
        py = prefix_beam_search_host(
            lp.astype(np.float64), **kw,
            **({} if not lm else {"lm": py_lm}))
        for (p1, s1), (p2, s2) in zip(py[:5], got[:5]):
            assert p1 == p2, (trial, p1, p2)
            assert s1 == pytest.approx(s2, abs=1e-4)


def test_batch_matches_jax_and_counts_calls(lms):
    _, c_lm, ref_lm = lms
    rng = np.random.default_rng(4)
    b, t, v = 5, 12, 7
    lp = np.stack([log_probs(rng, t, v) for _ in range(b)])
    lens = np.array([t, 9, t, 5, 0], np.int32)
    kw = dict(beam_width=8, lm_alpha=1.0, lm_beta=0.2, space_id=1,
              id_to_char=id_to_char, nbest=3, n_threads=3)
    calls = native.beam_search_batch_native.calls
    got = native.beam_search_batch_native(lp, lens, lm=c_lm, **kw)
    assert native.beam_search_batch_native.calls == calls + 1
    assert got == jax_native.beam_search_batch_native(lp, lens, lm=ref_lm,
                                                      **kw)
    for i in range(b):
        one = native.beam_search_native(lp[i, :lens[i]], lm=c_lm, nbest=3,
                                        **{k: v for k, v in kw.items()
                                           if k not in ("nbest",
                                                        "n_threads")})
        assert got[i] == one
    assert got[4][0][0] == ()


def test_invalid_arguments_raise():
    lp = np.zeros((3, 4), np.float32)
    with pytest.raises(RuntimeError, match="ds2n_beam_search"):
        native.beam_search_native(lp, beam_width=0)
    with pytest.raises(ValueError, match="id_to_char"):
        native.beam_search_native(lp, lm=object())
