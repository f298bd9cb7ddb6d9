"""The port's on-device prefix beam search (decode/beam.py) and host
search (decode/beam_host.py) against the JAX package's.

``beam_search`` on the CPU against JAX ``beam_search`` for both merges,
with and without a dense and a hashed LM table, pruned and exact, at
ragged lengths: the prefixes and lengths of all W beams bit-equal, the
scores within 1e-5. Chunked equals offline bit for bit inside the port.
The host search and the brute-force oracle equal the JAX ones exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.decode import beam_host as jax_beam_host
from deepspeech_tpu.decode.beam import beam_search as jax_beam_search
from deepspeech_tpu.decode.hashed_lm import \
    hashed_fusion_table as jax_hashed_fusion_table
from deepspeech_tpu.decode.ngram import NGramLM as JaxNGramLM
from deepspeech_tpu.decode.ngram import \
    dense_fusion_table as jax_dense_fusion_table
from deepspeech_tpu_torch.decode import beam as beam_mod
from deepspeech_tpu_torch.decode import (beam_finalize, beam_init,
                                         beam_search, beam_search_chunk,
                                         exhaustive_ctc_best,
                                         prefix_beam_search_host)
from deepspeech_tpu_torch.decode.hashed_lm import hashed_fusion_table
from deepspeech_tpu_torch.decode.ngram import NGramLM, dense_fusion_table
from test_torch_ngram import id_to_char, write_char_arpa

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

SCORE_TOL = 1e-5


def log_probs(rng, b, t, v, peaky=2.0):
    x = rng.normal(size=(b, t, v)) * peaky
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def tables(tmp_path, kind):
    """(port table, JAX table) of the character trigram fixture, V=5."""
    path = write_char_arpa(tmp_path, with_unk=True)
    lm, ref = NGramLM.from_arpa(path), JaxNGramLM.from_arpa(path)
    if kind == "dense":
        t, _ = dense_fusion_table(lm, id_to_char, 5, 1.2, 0.4)
        r, _ = jax_dense_fusion_table(ref, id_to_char, 5, 1.2, 0.4)
        return torch.from_numpy(t), jnp.asarray(r)
    return (hashed_fusion_table(lm, id_to_char, 5, 1.2, 0.4),
            jax_hashed_fusion_table(ref, id_to_char, 5, 1.2, 0.4))


def near_tie(scores):
    """The smallest gap between two live scores of a row, for a failure
    message: a flip on a true near-tie shows itself."""
    live = np.sort(scores[scores > -1e29])
    return float(np.diff(live).min()) if live.size > 1 else float("inf")


def assert_same_search(got, want):
    gp, gl, gs = (a.numpy() for a in got)
    wp, wl, ws = (np.asarray(a) for a in want)
    gaps = [near_tie(ws[i]) for i in range(ws.shape[0])]
    assert np.array_equal(gl, wl), (gl, wl, "smallest gaps", gaps)
    assert np.array_equal(gp, wp), ("prefixes differ; smallest gaps", gaps)
    live = ws > -1e29
    assert np.array_equal(gs > -1e29, live)
    err = float(np.abs(gs[live] - ws[live]).max())
    assert err <= SCORE_TOL, (err, "smallest gaps", gaps)


# (lm, V, prune_top_k, T, W): exact searches at P = V-1, pruned below.
CASES = [(None, 12, 11, 24, 8), (None, 30, 6, 30, 16), (None, 7, 6, 40, 4),
         ("dense", 5, 4, 20, 8), ("dense", 5, 2, 28, 16),
         ("hashed", 5, 4, 20, 8), ("hashed", 5, 2, 28, 16)]


@pytest.mark.parametrize("merge", ["sort", "match"])
@pytest.mark.parametrize("lm,v,p,t,w", CASES)
def test_beam_search_matches_jax(tmp_path, merge, lm, v, p, t, w):
    rng = np.random.default_rng(CASES.index((lm, v, p, t, w)))
    lp = log_probs(rng, 3, t, v)
    lens = np.array([t, t - 5, t - 11], np.int32)
    table = ref_table = None
    if lm is not None:
        table, ref_table = tables(tmp_path, lm)
    got = beam_search(torch.from_numpy(lp), torch.from_numpy(lens),
                      beam_width=w, prune_top_k=p, max_len=t,
                      lm_table=table, merge_impl=merge)
    want = jax_beam_search(jnp.asarray(lp), jnp.asarray(lens), beam_width=w,
                           prune_top_k=p, max_len=t, lm_table=ref_table,
                           merge_impl=merge)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.float32
    assert_same_search(got, want)


@pytest.mark.parametrize("merge", ["sort", "match"])
def test_beam_search_max_len_and_zero_length(merge):
    """A label cap shorter than T and an utterance of no frames."""
    rng = np.random.default_rng(3)
    lp = log_probs(rng, 3, 18, 9, peaky=3.0)
    lens = np.array([18, 0, 7], np.int32)
    got = beam_search(torch.from_numpy(lp), lens, beam_width=6,
                      prune_top_k=8, max_len=4, merge_impl=merge)
    want = jax_beam_search(jnp.asarray(lp), jnp.asarray(lens),
                           beam_width=6, prune_top_k=8, max_len=4,
                           merge_impl=merge)
    assert_same_search(got, want)
    assert int(got[1][1, 0]) == 0 and float(got[2][1, 0]) == 0.0


@pytest.mark.parametrize("lm", [None, "dense", "hashed"])
@pytest.mark.parametrize("merge", ["sort", "match"])
def test_chunked_equals_offline_bit_for_bit(tmp_path, merge, lm):
    """Chunks of uneven sizes, with invalid frames between valid ones,
    give the bits of one offline search (the invalid frames dropped)."""
    rng = np.random.default_rng(5)
    b, t, v, w = 3, 26, 5, 8
    lp = log_probs(rng, b, t, v)
    lens = np.array([t, t - 4, t - 9])
    table = tables(tmp_path, lm)[0] if lm else None
    off = beam_search(torch.from_numpy(lp), torch.from_numpy(lens),
                      beam_width=w, prune_top_k=v - 1, max_len=t,
                      lm_table=table, merge_impl=merge)
    # The same frames streamed with a padding frame after every third.
    state = beam_init(b, w, t)
    rows, valid = [], []
    for i in range(t):
        rows.append(lp[:, i])
        valid.append(i < lens)
        if i % 3 == 2:
            rows.append(rng.normal(size=(b, v)).astype(np.float32))
            valid.append(np.zeros(b, bool))
    lp_s = torch.from_numpy(np.stack(rows, 1))
    valid_s = torch.from_numpy(np.stack(valid, 1))
    for lo, hi in ((0, 5), (5, 6), (6, 19), (19, lp_s.shape[1])):
        state = beam_search_chunk(state, lp_s[:, lo:hi], valid_s[:, lo:hi],
                                  prune_top_k=v - 1, lm_table=table,
                                  merge_impl=merge)
    for got, want in zip(beam_finalize(state), off):
        assert torch.equal(got, want)


@pytest.mark.parametrize("lm", [None, "dense"])
def test_merges_agree(tmp_path, lm):
    rng = np.random.default_rng(9)
    lp = torch.from_numpy(log_probs(rng, 2, 22, 5))
    table = tables(tmp_path, lm)[0] if lm else None
    sort, match = (beam_search(lp, [22, 15], beam_width=8, prune_top_k=4,
                               lm_table=table, merge_impl=m)
                   for m in ("sort", "match"))
    assert torch.equal(sort[0], match[0]) and torch.equal(sort[1], match[1])
    assert float((sort[2] - match[2]).abs().max()) <= SCORE_TOL


@pytest.mark.parametrize("seed,t,v,w", [(0, 12, 5, 8), (1, 15, 6, 16),
                                        (2, 9, 4, 4)])
def test_exact_search_matches_host_oracle(seed, t, v, w):
    rng = np.random.default_rng(seed)
    lp = log_probs(rng, 1, t, v)
    host = prefix_beam_search_host(lp[0].astype(np.float64), beam_width=w)
    p, ln, s = beam_search(torch.from_numpy(lp), [t], beam_width=w,
                           prune_top_k=v - 1)
    assert tuple(p[0, 0, :ln[0, 0]].tolist()) == host[0][0]
    assert float(s[0, 0]) == pytest.approx(host[0][1], abs=1e-3)


def test_step_gives_the_same_bits_twice():
    rng = np.random.default_rng(2)
    lp = torch.from_numpy(log_probs(rng, 2, 6, 9))
    state = beam_search_chunk(beam_init(2, 8, 6), lp, torch.ones(2, 6,
                                                                 dtype=bool))
    top_lp, top_v = beam_mod._top(lp[:, 0], 8)
    a, b = (beam_mod._step(state, lp[:, 0], torch.ones(2, dtype=bool),
                           top_lp, top_v, blank_id=0, merge="sort")
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_merge_resolution_and_lm_vocab_check(tmp_path):
    assert beam_mod._resolve_merge("auto", 32) == "match"
    assert beam_mod._resolve_merge("auto", 33) == "sort"
    assert beam_mod._resolve_merge("sort", 8) == "sort"
    with pytest.raises(ValueError, match="merge_impl"):
        beam_mod._resolve_merge("scan", 8)
    table = tables(tmp_path, "dense")[0]
    with pytest.raises(ValueError, match="lm_table vocab"):
        beam_search(torch.zeros(1, 3, 7), [3], beam_width=4,
                    lm_table=table)


def test_state_rows_round_trip():
    """``state_rows`` / ``set_rows`` / ``reset_rows``: the snapshot and
    endpointing helpers."""
    rng = np.random.default_rng(4)
    lp = torch.from_numpy(log_probs(rng, 3, 10, 6))
    state = beam_search_chunk(beam_init(3, 4, 10), lp,
                              torch.ones(3, 10, dtype=bool))
    rows = beam_mod.state_rows(state, 1)
    assert all(isinstance(r, np.ndarray) for r in rows)
    other = beam_init(3, 4, 10)
    beam_mod.set_rows(other, 2, rows)
    assert all(torch.equal(a[2], b[1]) for a, b in zip(other, state))
    reset = beam_mod.reset_rows(state, torch.tensor([True, False, True]))
    fresh = beam_init(3, 4, 10)
    assert all(torch.equal(a[0], f[0]) and torch.equal(a[1], s[1])
               for a, f, s in zip(reset, fresh, state))


# -- the host search --------------------------------------------------------

class _WordLM:
    """A word LM that prefers "h w" (the JAX package's fusion fixture)."""

    order = 2

    def score_word(self, history, word, eos=False):
        text = "".join([w for w in history if w] + [word])
        return -0.1 if text == "hw"[:len(text)] else -3.0


@pytest.mark.parametrize("kind", ["plain", "pruned", "word_lm", "char_lm"])
def test_host_search_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(7)
    lp = log_probs(rng, 1, 14, 5)[0].astype(np.float64)
    kw = {"beam_width": 8}
    ref_kw = dict(kw)
    if kind == "pruned":
        kw["prune_log_prob"] = ref_kw["prune_log_prob"] = np.log(0.05)
    elif kind == "word_lm":
        chars = {1: " ", 2: "h", 3: "w", 4: "x"}
        kw.update(lm=_WordLM(), lm_alpha=3.0, lm_beta=0.5, space_id=1,
                  id_to_char=lambda i: chars[int(i)])
        ref_kw = kw
    elif kind == "char_lm":
        path = write_char_arpa(tmp_path, with_unk=False)
        kw.update(lm=NGramLM.from_arpa(path), lm_alpha=1.1, lm_beta=0.2,
                  id_to_char=id_to_char)
        ref_kw = dict(kw, lm=JaxNGramLM.from_arpa(path))
    got = prefix_beam_search_host(lp, **kw)
    assert got == jax_beam_host.prefix_beam_search_host(lp, **ref_kw)
    assert len(got) <= 8


def test_exhaustive_best_matches_jax():
    rng = np.random.default_rng(0)
    lp = log_probs(rng, 1, 5, 4)[0].astype(np.float64)
    assert exhaustive_ctc_best(lp, max_len=5) == \
        jax_beam_host.exhaustive_ctc_best(lp, max_len=5)
    with pytest.raises(ValueError, match="id_to_char"):
        prefix_beam_search_host(lp, lm=_WordLM())
