"""The port's ``StreamingBeamDecoder`` (streaming.py) against the JAX
package's on the same chunked logits (``init``, ``advance``, ``result``,
``stable_prefix``, ``reset_streams``), with and without a dense and a
hashed LM table; and inside the port, paired with the chunked
``StreamingTranscriber`` of a small ``ds2_streaming`` model: the chunks
folded through it give the bits of one offline ``beam_search`` over the
log-softmax of the concatenated logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.streaming import \
    StreamingBeamDecoder as JaxStreamingBeamDecoder
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.decode import beam_search
from deepspeech_tpu_torch.streaming import (StreamingBeamDecoder,
                                            StreamingTranscriber)
from test_torch_beam import assert_same_search, tables
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)


def _chunks(rng, b, v, sizes):
    """Raw logits and validity of a few chunks, with some frames of
    each stream invalid (warm-up and a stream that ends early)."""
    out = []
    t0 = 0
    for n in sizes:
        logits = (rng.normal(size=(b, n, v)) * 2.5).astype(np.float32)
        valid = np.ones((b, n), bool)
        idx = t0 + np.arange(n)
        valid[0] &= idx >= 3                 # stream 0 starts at frame 3
        valid[-1] &= idx < sum(sizes) - 7    # the last ends 7 early
        out.append((logits, valid))
        t0 += n
    return out


@pytest.mark.parametrize("lm", [None, "dense", "hashed"])
def test_decoder_matches_jax(tmp_path, lm):
    rng = np.random.default_rng(21)
    b, v, w = 3, 5, 8
    table = ref_table = None
    if lm:
        table, ref_table = tables(tmp_path, lm)
    bd = StreamingBeamDecoder(beam_width=w, max_len=24, prune_top_k=v - 1,
                              lm_table=table, device="cpu")
    ref = JaxStreamingBeamDecoder(beam_width=w, max_len=24,
                                  prune_top_k=v - 1, lm_table=ref_table)
    state, ref_state = bd.init(b), ref.init(b)
    for i, (logits, valid) in enumerate(_chunks(rng, b, v, (9, 6, 11))):
        state = bd.advance(state, logits, valid)
        ref_state = ref.advance(ref_state, logits, valid)
        assert_same_search(bd.result(state), ref.result(ref_state))
        for got, want in zip(bd.stable_prefix(state, margin=4.0),
                             ref.stable_prefix(ref_state, margin=4.0)):
            assert np.array_equal(got, np.asarray(want))
        if i == 1:  # restart stream 1's beam mid-stream
            mask = np.array([False, True, False])
            state = bd.reset_streams(state, mask)
            ref_state = ref.reset_streams(ref_state, mask)
    ids, lens = bd.stable_prefix(state)
    assert ids.dtype == np.int32 and lens.shape == (b,)


def test_stable_prefix_is_the_plausible_beams_common_prefix():
    rng = np.random.default_rng(21)
    b, t, v, w = 2, 12, 5, 8
    bd = StreamingBeamDecoder(beam_width=w, max_len=t, prune_top_k=v - 1,
                              device="cpu")
    state = bd.advance(bd.init(b), rng.normal(size=(b, t, v)) * 2.5,
                       np.ones((b, t), bool))
    ids, lens = bd.stable_prefix(state, margin=10.0)
    prefixes, plens, scores = (a.numpy() for a in bd.result(state))
    for i in range(b):
        n = int(lens[i])
        for k in range(w):
            if scores[i, k] >= scores[i, 0] - 10.0:
                assert int(plens[i, k]) >= n
                assert np.array_equal(prefixes[i, k, :n], ids[i, :n])
    conf = np.full((1, 8, v), -8.0)
    conf[0, :4, 2] = 8.0
    conf[0, 4:, 0] = 8.0
    state = bd.advance(bd.init(1), conf, np.ones((1, 8), bool))
    ids, lens = bd.stable_prefix(state)
    assert int(lens[0]) == 1 and int(ids[0, 0]) == 2


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_chunked_transcriber_equals_offline_beam(quantize):
    """Chunks of the port's streaming engine folded through the decoder
    equal one offline ``beam_search`` over the log-softmax of the
    engine's concatenated logits (its valid rows), bit for bit."""
    over = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
            "model.conv_channels": "4,4", "model.lookahead_context": "4",
            "model.dtype": "float32", "model.rnn_impl": "pallas"}
    jcfg = jax_apply_overrides(jax_get_config("ds2_streaming"), over)
    cfg = apply_overrides(get_config("ds2_streaming"), over)
    b, t = 2, 199
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(b, t, 161)).astype(np.float32)
    lens = np.array([t, 150])
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.asarray(feats), jnp.asarray(lens),
        np.random.default_rng(7))
    params = jax.tree.map(np.asarray, params)
    params["head"]["kernel"] = params["head"]["kernel"] * 4.0
    st = StreamingTranscriber(cfg, params, stats, CharTokenizer.english(),
                              chunk_frames=64, quantize=quantize,
                              device="cpu")
    bd = StreamingBeamDecoder(beam_width=8, max_len=64, prune_top_k=8,
                              device="cpu")
    state = dataclasses.replace(st.init_state(b),
                                raw_len=torch.from_numpy(lens))
    bstate = bd.init(b)
    rows, valids = [], []
    for i in range(t // 64):
        state, lo, va = st.process_chunk(state, feats[:, i * 64:(i + 1) * 64])
        bstate = bd.advance(bstate, lo, va)
        rows.append(lo)
        valids.append(va)
    state, lo, va = st.finish(state, lens, tail=feats[:, (t // 64) * 64:])
    bstate = bd.advance(bstate, lo, va)
    rows.append(lo)
    valids.append(va)
    lo, va = torch.cat(rows, 1), torch.cat(valids, 1)
    n = va.sum(1)
    packed = torch.zeros((b, int(n.max()), lo.shape[-1]))
    for i in range(b):
        packed[i, :n[i]] = lo[i][va[i]]
    off = beam_search(torch.log_softmax(packed, -1), n, beam_width=8,
                      prune_top_k=8, max_len=64)
    for got, want in zip(bd.result(bstate), off):
        assert torch.equal(got, want)
    assert int(bd.result(bstate)[1][:, 0].min()) > 0
