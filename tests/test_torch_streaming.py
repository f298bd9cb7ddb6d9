"""The port's chunked streaming engine (``streaming.py``) against the JAX
package's, on the same numpy weights and features, with the JAX side on
its Pallas GRU kernels in interpret mode (``model.rnn_impl="pallas"``:
``gru_scan_pallas_stream`` with a carried h0, and ``gru_scan_pallas_q``
with h0 for int8), at the JAX tests' sizes (tests/test_streaming.py:
H=32, 2 layers, conv (4, 4), lookahead 4 and 0, B=2, T=199).

Tolerances: f32 logits within the JAX tests' 2e-4 of the JAX engine and
of the JAX offline forward; int8 within 1e-4 of the JAX int8 engine; the
carried state within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.models.conv import ConvFrontend as JaxConvFrontend
from deepspeech_tpu.ops.rnn_pallas import gru_scan_pallas_stream
from deepspeech_tpu.streaming import \
    StreamingTranscriber as JaxStreamingTranscriber
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.decode.greedy import greedy_decode, ids_to_texts
from deepspeech_tpu_torch.models.ds2 import DeepSpeech2
from deepspeech_tpu_torch.ops.gru import gru_fwd
from deepspeech_tpu_torch.serving.session import StreamingSessionManager
from deepspeech_tpu_torch.streaming import (CONV_LAG, HIST,
                                            StreamingTranscriber)
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

TOL = 2e-4
SMALL = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
         "model.conv_channels": "4,4", "model.dtype": "float32",
         "model.rnn_impl": "pallas"}


def _cfgs(lookahead=4, **over):
    over = {**SMALL, "model.lookahead_context": str(lookahead), **over}
    return (jax_apply_overrides(jax_get_config("ds2_streaming"), over),
            apply_overrides(get_config("ds2_streaming"), over))


def _setup(lookahead=4, b=2, t=199, seed=0, **over):
    """(jax cfg, port cfg, params, batch_stats, feats, lens) from numpy:
    random weights with BN running means moved off 0 (seam errors show
    only then), features N(0, 1), the first stream full length."""
    jcfg, tcfg = _cfgs(lookahead, **over)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, t, 161)).astype(np.float32)
    lens = np.asarray([t] + list(rng.integers(t // 2, t, size=b - 1)),
                      np.int64)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.asarray(feats),
        jnp.asarray(lens), rng)
    params = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, stats, feats, lens


def _jax_offline(jcfg, params, stats, feats, lens):
    logits, out_lens = jax_create_model(jcfg.model).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(feats),
        jnp.asarray(lens), train=False)
    return np.asarray(logits), np.asarray(out_lens)


def test_conv_valid_start_matches_jax():
    """``ConvFrontend`` with ``valid_start`` masks the frames before each
    stream's start as the JAX frontend does; without it the output is
    what it was."""
    jcfg, tcfg, params, stats, feats, lens = _setup(t=96)
    start = np.asarray([0, 32], np.int64)
    want, want_lens = JaxConvFrontend(jcfg.model).apply(
        {"params": params["conv"], "batch_stats": stats["conv"]},
        jnp.asarray(feats), jnp.asarray(lens), False,
        valid_start=jnp.asarray(start))
    model = DeepSpeech2(tcfg.model)
    model.load_state_dict(bridge.from_flax(params, stats))
    model.eval()
    with torch.no_grad():
        got, got_lens = model.conv(torch.tensor(feats), torch.tensor(lens),
                                   valid_start=torch.tensor(start))
        plain, _ = model.conv(torch.tensor(feats), torch.tensor(lens))
        zero, _ = model.conv(torch.tensor(feats), torch.tensor(lens),
                             valid_start=torch.zeros(2, dtype=torch.long))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not got[1, :16].any()  # 32 raw frames = 16 after stride 2
    assert torch.equal(zero, plain)


@pytest.mark.parametrize("lookahead", [4, 0])
def test_process_chunk_matches_jax(lookahead):
    """Chunk by chunk, then ``finish`` with a tail: logits, validity and
    every ``StreamState`` field equal the JAX engine's."""
    jcfg, tcfg, params, stats, feats, lens = _setup(lookahead)
    tok = CharTokenizer.english()
    ref = JaxStreamingTranscriber(jcfg, params, stats,
                                  JaxCharTokenizer.english())
    assert ref._use_pallas
    st = StreamingTranscriber(tcfg, params, stats, tok, device="cpu")
    js, ts = ref.init_state(2), st.init_state(2)
    k = 64

    def same(jstate, tstate, jlo, jva, tlo, tva):
        np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(tva.numpy(), np.asarray(jva))
        np.testing.assert_array_equal(tstate.raw_hist.numpy(),
                                      np.asarray(jstate.raw_hist))
        for hj, ht in zip(jstate.h, tstate.h):
            np.testing.assert_allclose(ht.numpy(), np.asarray(hj),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tstate.la_buf.numpy(),
                                   np.asarray(jstate.la_buf), rtol=1e-5,
                                   atol=1e-5)
        assert tstate.emitted == int(jstate.emitted)
        np.testing.assert_array_equal(tstate.raw_len.numpy(),
                                      np.asarray(jstate.raw_len))
        np.testing.assert_array_equal(tstate.raw_start.numpy(),
                                      np.asarray(jstate.raw_start))

    for i in range(199 // k):
        js, jlo, jva = ref.process_chunk(js, feats[:, i * k:(i + 1) * k])
        ts, tlo, tva = st.process_chunk(ts, feats[:, i * k:(i + 1) * k])
        same(js, ts, jlo, jva, tlo, tva)
    js, jlo, jva = ref.finish(js, lens, tail=feats[:, 192:])
    ts, tlo, tva = st.finish(ts, lens, tail=feats[:, 192:])
    same(js, ts, jlo, jva, tlo, tva)
    assert ts.emitted == -CONV_LAG + 32 * (3 + 1 + st.flush_chunks())


@pytest.mark.parametrize("lookahead", [4, 0])
def test_transcribe_matches_jax_and_offline(lookahead):
    jcfg, tcfg, params, stats, feats, lens = _setup(lookahead)
    off, off_lens = _jax_offline(jcfg, params, stats, feats, lens)
    ref = JaxStreamingTranscriber(jcfg, params, stats,
                                  JaxCharTokenizer.english())
    want, want_lens = ref.transcribe(feats, lens)
    st = StreamingTranscriber(tcfg, params, stats, CharTokenizer.english(),
                              device="cpu")
    got, got_lens = st.transcribe(feats, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    np.testing.assert_array_equal(got_lens, off_lens)
    for i in range(2):
        n = int(off_lens[i])
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got[i, :n], off[i, :n], rtol=TOL,
                                   atol=TOL)


def test_int8_streaming_matches_jax():
    """``quantize="int8"``: the recurrent matrices stay int8 into
    ``gru_fwd_q`` with h0 on both sides (resident at H=32), within 1e-4
    of the JAX int8 engine."""
    jcfg, tcfg, params, stats, feats, lens = _setup()
    ref = JaxStreamingTranscriber(jcfg, params, stats,
                                  JaxCharTokenizer.english(),
                                  quantize="int8")
    assert ref._keep_q is not None
    st = StreamingTranscriber(tcfg, params, stats, CharTokenizer.english(),
                              quantize="int8", device="cpu")
    assert st._keep_q is not None and st.model.rnn.rnn0.quantized
    want, want_lens = ref.transcribe(feats, lens)
    got, got_lens = st.transcribe(feats, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    for i in range(2):
        n = int(got_lens[i])
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_carry_across_chunks_equals_one_call(dtype):
    """``hfin`` of chunk k as ``h0`` of chunk k+1 gives the bits of one
    long call (the plain version of K6, D=1), and the chain matches the
    JAX streaming kernel chained the same way."""
    rng = np.random.default_rng(11)
    t, b, h = 48, 3, 16
    xp = torch.tensor(rng.normal(size=(t, b, 3 * h)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(1, h, 3 * h)) / np.sqrt(h),
                     dtype=torch.float32)
    bias = torch.tensor(rng.normal(size=(1, 3 * h)) * 0.1,
                        dtype=torch.float32)
    lens = np.asarray([48, 30, 17])
    mask = torch.tensor((np.arange(t)[:, None] < lens[None]), dtype=torch.float32)
    full, hfull = gru_fwd(xp.to(dtype), mask, w.to(dtype), bias)
    hc, outs = torch.zeros(1, b, h), []
    for s in range(0, t, 16):
        ys, hc = gru_fwd(xp[s:s + 16].to(dtype).contiguous(),
                         mask[s:s + 16].contiguous(), w.to(dtype), bias, hc)
        outs.append(ys)
    assert torch.equal(torch.cat(outs, 1), full)
    assert torch.equal(hc, hfull)
    if dtype == torch.float32:
        jh, jouts = jnp.zeros((b, h), jnp.float32), []
        for s in range(0, t, 16):
            ys, jh = gru_scan_pallas_stream(
                jnp.asarray(xp[s:s + 16].transpose(0, 1).numpy()),
                jnp.asarray(mask[s:s + 16].t().numpy()),
                jnp.asarray(w[0].numpy()), jnp.asarray(bias[0].numpy()),
                jh, interpret=True)
            jouts.append(np.asarray(ys))
        np.testing.assert_allclose(
            full[0].transpose(0, 1).numpy(), np.concatenate(jouts, 1),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(hfull[0].numpy(), np.asarray(jh),
                                   rtol=1e-5, atol=1e-5)


def test_streaming_is_causal():
    """Future audio does not change logits already emitted."""
    _, tcfg, params, stats, feats, _ = _setup(b=1, t=192)
    st = StreamingTranscriber(tcfg, params, stats, device="cpu")
    feats2 = feats.copy()
    feats2[:, 128:] = 100.0  # wildly different future
    outs = []
    for f in (feats, feats2):
        state = st.init_state(1)
        state, lo1, _ = st.process_chunk(state, f[:, :64])
        state, lo2, _ = st.process_chunk(state, f[:, 64:128])
        outs.append((lo1, lo2))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_incremental_decode_matches_full():
    _, tcfg, params, stats, feats, lens = _setup(b=1, t=150, seed=3)
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    tok = CharTokenizer.english()
    st = StreamingTranscriber(tcfg, params, stats, tok, device="cpu")
    state = st.init_state(1)
    prev = np.zeros((1,), np.int64)
    text = ""
    for i in range(2):
        state, lo, va = st.process_chunk(state, feats[:, i * 64:(i + 1) * 64])
        prev, new = st.decode_incremental(prev, lo, va)
        text += new[0]
    state, lo, va = st.finish(state, lens, tail=feats[:, 128:150])
    prev, new = st.decode_incremental(prev, lo, va)
    text += new[0]
    with torch.no_grad():
        logits, out_lens = st.model(torch.tensor(feats), torch.tensor(lens))
    full = ids_to_texts(*greedy_decode(logits, out_lens), tok)[0]
    assert text == full and text


@pytest.mark.parametrize("model_over,match", [
    ({"bidirectional": True}, "unidirectional"),
    ({"rnn_type": "lstm"}, "GRU stacks"),
    ({"conv_layers": ((41, 41, 2, 2), (21, 21, 1, 2))}, "receptive field")])
def test_unstreamable_models_refused(model_over, match):
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, **model_over))
    with pytest.raises(ValueError, match=match):
        StreamingTranscriber(tcfg, {}, {}, device="cpu")


@pytest.mark.parametrize("chunk_frames", [63, 30])
def test_bad_chunk_frames_refused(chunk_frames):
    _, tcfg, params, stats, _, _ = _setup(t=64)
    with pytest.raises(ValueError, match="chunk_frames"):
        StreamingTranscriber(tcfg, params, stats, chunk_frames=chunk_frames,
                             device="cpu")


def test_wrong_chunk_length_refused():
    _, tcfg, params, stats, feats, _ = _setup(t=64)
    st = StreamingTranscriber(tcfg, params, stats, device="cpu")
    with pytest.raises(ValueError, match="64 frames"):
        st.process_chunk(st.init_state(2), feats[:, :32])
    assert st.init_state(2).raw_hist.shape == (2, HIST, 161)


@pytest.mark.parametrize("entry", ["transcriber", "manager"])
def test_entry_points_need_cuda_unless_cpu(monkeypatch, entry):
    """Without CUDA the streaming entry points raise rather than run on
    the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, params, stats, _, _ = _setup(t=64)
    cls = {"transcriber": StreamingTranscriber,
           "manager": StreamingSessionManager}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(tcfg, params, stats, CharTokenizer.english())
