"""The port's n-gram LM, fusion tables and n-best rescoring against the
JAX package's: the ARPA reader's scores, the dense and hashed tables'
arrays bit for bit, the hashed table's on-device probes, the
``fusion_table_for`` dispatch and its errors, ``rescore_nbest``, and
``load_lm``'s engine order (kenlm, then the C++ engine, then Python)."""

import sys
from itertools import product

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.decode import hashed_lm as jax_hashed_lm
from deepspeech_tpu.decode import ngram as jax_ngram
from deepspeech_tpu_torch import native
from deepspeech_tpu_torch.decode import hashed_lm, ngram
from deepspeech_tpu_torch.decode.ngram import NGramLM

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

# A word bigram LM (the JAX package's tests/test_beam.py fixture).
ARPA = """\
\\data\\
ngram 1=5
ngram 2=3

\\1-grams:
-0.5\t<s>\t-0.30103
-0.9\t</s>
-0.6\thello\t-0.30103
-0.7\tworld\t-0.30103
-1.2\t<unk>

\\2-grams:
-0.2\t<s> hello
-0.3\thello world
-0.4\tworld </s>

\\end\\
"""

# A character trigram LM over a, b, c (id 4, 'd', is out of it).
CHAR_ARPA = """\
\\data\\
ngram 1={n1}
ngram 2=5
ngram 3=3

\\1-grams:
-0.4\t<s>\t-0.35
-1.0\t</s>
-0.5\ta\t-0.25
-0.8\tb\t-0.2
-1.1\tc{unk_line}

\\2-grams:
-0.25\t<s> a\t-0.1
-0.3\ta b\t-0.15
-0.45\tb a\t-0.2
-0.6\tb c
-0.9\ta a

\\3-grams:
-0.15\t<s> a b
-0.2\ta b a
-0.5\tb a b

\\end\\
"""

CHAR_OF = {1: "a", 2: "b", 3: "c", 4: "d"}


def id_to_char(i):
    return CHAR_OF[int(i)]


def write_char_arpa(tmp_path, with_unk: bool) -> str:
    p = tmp_path / f"char{'_unk' if with_unk else ''}.arpa"
    p.write_text(CHAR_ARPA.format(
        n1=6 if with_unk else 5,
        unk_line="\n-1.3\t<unk>" if with_unk else ""))
    return str(p)


def random_grams(seed: int):
    """A random n-gram model over {a, b, c} (order 1-3, sparse grams,
    random backoffs, with or without <unk>): the JAX package's
    ``_random_char_lm`` generator, as ``(ngrams, order)``."""
    rng = np.random.default_rng(100 + seed)
    chars = ["a", "b", "c"]
    order = int(rng.integers(1, 4))
    has_unk = bool(rng.integers(0, 2))
    ngrams = {1: {}}
    ngrams[1][("<s>",)] = (-99.0, float(rng.uniform(-0.8, 0.0)))
    ngrams[1][("</s>",)] = (float(rng.uniform(-2, -0.5)), 0.0)
    if has_unk:
        ngrams[1][("<unk>",)] = (float(rng.uniform(-3, -1)),
                                 float(rng.uniform(-0.5, 0.0)))
    for ch in chars:
        if rng.random() < 0.9:
            ngrams[1][(ch,)] = (float(rng.uniform(-2, -0.3)),
                                float(rng.uniform(-0.8, 0.0)))
    vocab1 = [w for (w,) in ngrams[1]]
    for n in range(2, order + 1):
        ngrams[n] = {}
        pool = [h for h in product(vocab1, repeat=n - 1)
                if "</s>" not in h[1:] and "<s>" not in h[1:]]
        for h in pool:
            for w in vocab1:
                if w != "<s>" and rng.random() < 0.3:
                    ngrams[n][h + (w,)] = (
                        float(rng.uniform(-2, -0.1)),
                        float(rng.uniform(-0.8, 0.0)) if n < order else 0.0)
    return ngrams, order


def both_lms(seed_or_path):
    """The same LM as the port's and the JAX package's NGramLM."""
    if isinstance(seed_or_path, str):
        return (NGramLM.from_arpa(seed_or_path),
                jax_ngram.NGramLM.from_arpa(seed_or_path))
    grams, order = random_grams(seed_or_path)
    return NGramLM(grams, order), jax_ngram.NGramLM(grams, order)


@pytest.fixture()
def word_arpa(tmp_path):
    p = tmp_path / "tiny.arpa"
    p.write_text(ARPA)
    return str(p)


def test_word_lm_scores_match_jax(word_arpa):
    lm, ref = both_lms(word_arpa)
    assert lm.order == ref.order == 2 and lm.has_unk == ref.has_unk
    for hist, w in [(["<s>"], "hello"), (["hello"], "world"),
                    (["world"], "hello"), (["hello"], "zebra"),
                    (["zebra"], "hello"), ([], "</s>")]:
        assert lm.logp(hist, w) == ref.logp(hist, w)
    for hist, w, eos in [([], "hello", True), (["hello"], "world", False),
                         (["hello", "", "x"], "world", True)]:
        assert lm.score_word(hist, w, eos) == ref.score_word(hist, w, eos)
    for s in ["hello world", "world hello", "", "zebra hello world"]:
        assert lm.score_sentence(s) == ref.score_sentence(s)
        assert lm.score_sentence(s, False) == ref.score_sentence(s, False)
        assert lm.score_eos(s.split()) == ref.score_eos(s.split())


@pytest.mark.parametrize("seed", range(4))
def test_char_lm_scores_match_jax(seed):
    lm, ref = both_lms(seed)
    for n in range(3):
        for hist in product("abcd", repeat=n):
            for w in "abcd":
                assert lm.score_word(list(hist), w) == \
                    ref.score_word(list(hist), w)


@pytest.mark.parametrize("case", ["unk", "no_unk", 0, 1, 2, 3, 4, 5])
def test_dense_table_bit_equal_to_jax(tmp_path, case):
    if isinstance(case, str):
        lm, ref = both_lms(write_char_arpa(tmp_path, case == "unk"))
    else:
        lm, ref = both_lms(case)
    got, k = ngram.dense_fusion_table(lm, id_to_char, 5, 1.3, 0.25)
    want, k_ref = jax_ngram.dense_fusion_table(ref, id_to_char, 5, 1.3,
                                               0.25)
    assert k == k_ref == lm.order - 1
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # And the table is the scorer on every reachable context.
    for n in range(min(lm.order + 1, 3) + 1):
        for prefix in product(range(1, 5), repeat=n):
            row = 0
            for s in prefix:
                row = (row * 5 + s) % (5 ** k) if k else 0
            for w in range(1, 5):
                want_w = 1.3 * lm.score_word(
                    [CHAR_OF[i] for i in prefix], CHAR_OF[w]) + 0.25
                assert abs(float(got[row, w]) - want_w) <= 1e-5


@pytest.mark.parametrize("case", ["unk", "no_unk", 0, 1, 2, 3, 4, 5])
def test_hashed_table_bit_equal_to_jax(tmp_path, case):
    if isinstance(case, str):
        lm, ref = both_lms(write_char_arpa(tmp_path, case == "unk"))
    else:
        lm, ref = both_lms(case)
    got = hashed_lm.hashed_fusion_table(lm, id_to_char, 5, 0.9, 0.4)
    want = jax_hashed_lm.hashed_fusion_table(ref, id_to_char, 5, 0.9, 0.4)
    assert (got.k, got.b_tok, got.vocab_size) == (want.k, want.b_tok,
                                                  want.vocab_size)
    pairs = [(got.tok_of, want.tok_of)]
    for name in ("ng_keys_ctx", "ng_keys_w", "ng_vals", "bo_keys",
                 "bo_vals"):
        a, b = getattr(got, name), getattr(want, name)
        assert len(a) == len(b)
        pairs += list(zip(a, b))
    for a, b in pairs:
        b = np.asarray(b)
        assert np.array_equal(a.numpy(), b) and a.numpy().dtype.kind == \
            b.dtype.kind


@pytest.mark.parametrize("case", ["unk", 0, 3, 5])
def test_hashed_probes_match_jax(tmp_path, case):
    """The port's ``push`` and ``bonus`` on torch tensors equal the JAX
    table's on every reachable context (bit for bit) and the scorer
    (within 1e-5)."""
    if isinstance(case, str):
        lm, ref = both_lms(write_char_arpa(tmp_path, True))
    else:
        lm, ref = both_lms(case)
    got = hashed_lm.hashed_fusion_table(lm, id_to_char, 5, 1.3, 0.25)
    want = jax_hashed_lm.hashed_fusion_table(ref, id_to_char, 5, 1.3, 0.25)
    words = torch.arange(1, 5)
    for n in range(min(lm.order + 1, 3) + 1):
        for prefix in product(range(1, 5), repeat=n):
            ctx = torch.zeros((1,), dtype=torch.long)
            jctx = jnp.zeros((1,), jnp.int32)
            for s in prefix:
                ctx = got.push(ctx, torch.tensor([s]))
                jctx = want.push(jctx, jnp.asarray([s], jnp.int32))
            assert int(ctx[0]) == int(jctx[0])
            b = got.bonus(ctx, words)[0].numpy()
            jb = np.asarray(want.bonus(jctx, jnp.arange(1, 5)))[0]
            assert np.array_equal(b, jb), (prefix, b, jb)
            for w in range(1, 5):
                want_w = 1.3 * lm.score_word(
                    [CHAR_OF[i] for i in prefix], CHAR_OF[w]) + 0.25
                assert abs(float(b[w - 1]) - want_w) <= 1e-5
    # Batched: ctx [B, W] with w [B, P] gives [B, W, P].
    out = got.bonus(torch.zeros((2, 3), dtype=torch.long),
                    torch.tensor([[1, 2], [3, 4]]))
    assert out.shape == (2, 3, 2)


def test_hashed_table_at_mandarin_scale_matches_jax():
    """A character trigram over 600 symbols (the aishell shape at a
    test's size): the tables equal the JAX package's and the probes its
    scorer's on sampled trigram contexts."""
    rng = np.random.default_rng(0)
    v = 601
    chars = [chr(0x4e00 + i) for i in range(v - 1)]
    grams = {1: {("<s>",): (-99.0, -0.4), ("</s>",): (-1.5, 0.0),
                 ("<unk>",): (-2.5, -0.3)}, 2: {}, 3: {}}
    for ch in chars[:v // 2]:
        grams[1][(ch,)] = (float(rng.uniform(-4, -1)),
                           float(rng.uniform(-0.6, 0.0)))
    vocab1 = [w for (w,) in grams[1] if w not in ("<s>", "</s>")]
    for n, count in ((2, 3000), (3, 3000)):
        for _ in range(count):
            g = tuple(vocab1[int(rng.integers(len(vocab1)))]
                      for _ in range(n))
            grams[n][g] = (float(rng.uniform(-3, -0.3)),
                           float(rng.uniform(-0.5, 0.0)) if n < 3 else 0.0)
    lm, ref = NGramLM(grams, 3), jax_ngram.NGramLM(grams, 3)
    to_char = lambda i: chars[int(i) - 1]  # noqa: E731
    got = hashed_lm.hashed_fusion_table(lm, to_char, v, 0.8, 0.5)
    want = jax_hashed_lm.hashed_fusion_table(ref, to_char, v, 0.8, 0.5)
    assert got.k == want.k == 2
    for a, b in zip(got.ng_vals + got.ng_keys_ctx,
                    want.ng_vals + want.ng_keys_ctx):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for _ in range(40):
        c1, c2, w = (int(x) for x in rng.integers(1, v, size=3))
        ctx = got.push(got.push(torch.zeros((1,), dtype=torch.long),
                                torch.tensor([c1])), torch.tensor([c2]))
        b = float(got.bonus(ctx, torch.tensor([w]))[0, 0])
        want_w = 0.8 * lm.score_word([to_char(c1), to_char(c2)],
                                     to_char(w)) + 0.5
        assert abs(b - want_w) <= 1e-4


def test_fusion_table_for_dispatch_and_errors(tmp_path, monkeypatch):
    path = write_char_arpa(tmp_path, True)
    lm = NGramLM.from_arpa(path)
    dense = ngram.fusion_table_for(path, id_to_char, 5, 1.0, 0.5,
                                   impl="dense")
    want, _ = ngram.dense_fusion_table(lm, id_to_char, 5, 1.0, 0.5)
    assert isinstance(dense, torch.Tensor)
    assert np.array_equal(dense.numpy(), want)
    ref = jax_ngram.fusion_table_for(path, id_to_char, 5, 1.0, 0.5,
                                     impl="dense")
    assert np.array_equal(dense.numpy(), np.asarray(ref))
    hashed = ngram.fusion_table_for(lm, id_to_char, 5, 1.0, 0.5,
                                    impl="hashed")
    assert isinstance(hashed, hashed_lm.HashedFusionTable)
    assert isinstance(ngram.fusion_table_for(lm, id_to_char, 5, 1.0, 0.5),
                      torch.Tensor)  # auto: dense holds the context
    # Auto goes hashed where the dense budget cannot hold the context.
    monkeypatch.setattr(ngram, "DENSE_TABLE_MAX_ENTRIES", 100)
    assert isinstance(ngram.fusion_table_for(lm, id_to_char, 5, 1.0, 0.5),
                      hashed_lm.HashedFusionTable)
    with pytest.raises(ValueError, match="device_lm_impl"):
        ngram.fusion_table_for(lm, id_to_char, 5, 1.0, 0.5, impl="sparse")
    with pytest.raises(ValueError, match="over the"):
        ngram.dense_fusion_table(lm, id_to_char, 5, 1.0, 0.5,
                                 context_size=2, max_table_entries=100)
    bad = tmp_path / "lm.bin"
    bad.write_bytes(b"\x00\x01binary kenlm")
    with pytest.raises(ValueError, match="not readable as ARPA"):
        ngram.fusion_table_for(str(bad), id_to_char, 5, 1.0, 0.5)
    moved = hashed.to("cpu")
    assert moved.k == hashed.k and moved.nbytes() == hashed.nbytes()


def test_rescore_nbest_matches_jax(word_arpa):
    lm, ref = both_lms(word_arpa)
    nbest = [("world hello", -1.0), ("hello world", -1.2), ("", -5.0)]
    got = ngram.rescore_nbest(nbest, lm, alpha=2.0, beta=0.3)
    assert got == jax_ngram.rescore_nbest(nbest, ref, alpha=2.0, beta=0.3)
    assert got[0][0] == "hello world"
    spaced = ngram.rescore_nbest([("ab", -1.0)], lm, 1.0, 0.0,
                                 to_lm_text=lambda t: " ".join(t))
    assert spaced == jax_ngram.rescore_nbest(
        [("ab", -1.0)], ref, 1.0, 0.0, to_lm_text=lambda t: " ".join(t))


class _FakeKenlmModel:
    """The kenlm API surface ``_KenLMWrapper`` calls (``Model(path)``,
    ``.order``, ``.score(sentence, bos=, eos=)``), scoring through the
    ARPA reader."""

    def __init__(self, path):
        self._lm = NGramLM.from_arpa(str(path))
        self.order = self._lm.order
        self.score_calls = 0

    def score(self, sentence, bos=True, eos=True):
        assert bos
        self.score_calls += 1
        return self._lm.score_sentence(sentence, include_eos=eos)


def test_kenlm_wrapper_contract(word_arpa):
    lm = NGramLM.from_arpa(word_arpa)
    model = _FakeKenlmModel(word_arpa)
    wrap = ngram._KenLMWrapper(model)
    assert wrap.order == lm.order
    for s in ["hello world", "world hello", "hello hello world"]:
        assert wrap.score_sentence(s) == pytest.approx(
            lm.score_sentence(s), abs=1e-9)
    for hist, w, eos in [([], "hello", False), (["hello"], "world", False),
                         (["world"], "hello", False),
                         (["hello"], "zebra", False), ([], "hello", True)]:
        assert wrap.score_word(hist, w, eos) == pytest.approx(
            lm.score_word(hist, w, eos), abs=1e-9)
    calls = model.score_calls
    wrap.score_word(["hello", "world"], "hello")
    assert model.score_calls - calls <= 2  # prefix scores are memoised


def test_load_lm_engine_order(word_arpa, monkeypatch):
    """kenlm when importable, else the C++ engine, else Python; an ARPA
    the C++ engine cannot read falls to the Python reader's error."""
    fake = type(sys)("kenlm")
    fake.Model = _FakeKenlmModel
    monkeypatch.setitem(sys.modules, "kenlm", fake)
    assert isinstance(ngram.load_lm(word_arpa), ngram._KenLMWrapper)
    monkeypatch.setitem(sys.modules, "kenlm", None)
    assert native.available(), native.build_error()
    got = ngram.load_lm(word_arpa)
    assert isinstance(got, native.NativeNGram)
    assert got.score_sentence("hello world") == pytest.approx(
        NGramLM.from_arpa(word_arpa).score_sentence("hello world"),
        abs=1e-6)
    monkeypatch.setattr(native, "available", lambda: False)
    py = ngram.load_lm(word_arpa)
    assert isinstance(py, NGramLM)
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "kenlm", None)
    bad = word_arpa + ".bad"
    with open(bad, "w") as f:
        f.write("nothing here\n")
    with pytest.raises(ValueError, match="no n-gram sections"):
        ngram.load_lm(bad)
