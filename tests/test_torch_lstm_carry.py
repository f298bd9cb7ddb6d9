"""The carried LSTM state of ``ops/lstm.py``'s forward (K12's and K14's
``hc0 = (h0, c0)`` and final ``(h, c)``) on the CPU, where the wrappers
run their plain version: against the JAX package's ``lstm_scan(...,
hc0=..., return_final=True)``, the carry the JAX sequence-parallel relay
hands across shards (seqpar.py:192-244); chunked calls that relay ``(h,
c)`` against one offline call, bit for bit; and the argument rules.

The JAX oracle takes a carry on forward scans only: a reverse direction
is held to it on the time-flipped inputs, as the JAX relay flips them.
Tolerances: 1e-5 with f32 dots; 3e-2 with bf16 dots (tests/test_torch_
lstm.py's: the two sides round h_prev to bf16 at the same place but sum
in other orders). chip_smoke.py's seqpar phase holds the CUDA kernels to
the same plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.models.rnn import lstm_scan as jax_lstm_scan
from deepspeech_tpu_torch.ops import lstm

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

TOL = {None: 1e-5, "bfloat16": 3e-2}
WRAPPERS = ["lstm_fwd", "lstm_fwd_stream"]


def _case(seed, t=11, b=3, h=24):
    """xproj [B,T,4H], a ragged mask [B,T] (the first row full), W
    [H,4H], b [4H] and a random (h0, c0) [B,H], numpy f32."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(b, t, 4 * h)).astype(np.float32)
    w = (rng.normal(size=(h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    bias = (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32)
    lens = rng.integers(2, t + 1, size=b)
    lens[0] = t
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    h0, c0 = (rng.normal(size=(b, h)).astype(np.float32) * 0.5
              for _ in range(2))
    return xproj, mask, w, bias, h0, c0


def _port(xproj, mask, w, bias, dot):
    """The wrappers' arguments (time-major, D=1) in the dot dtype."""
    dd = torch.bfloat16 if dot else torch.float32
    if dot:  # both sides see the same bf16 inputs
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    return (torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dd),
            torch.from_numpy(mask).t().contiguous(),
            torch.from_numpy(w)[None].to(dd).contiguous(),
            torch.from_numpy(bias)[None].contiguous()), xproj


def _carry(*xs):
    return tuple(torch.from_numpy(x)[None].contiguous() for x in xs)


@pytest.mark.parametrize("dot", [None, "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_carry_in_and_out_match_the_jax_oracle(wrapper, reverse, dot):
    xproj, mask, w, bias, h0, c0 = _case(1)
    args, xq = _port(xproj, mask, w, bias, dot)
    ys, (hf, cf) = getattr(lstm, wrapper)(
        *args, (reverse,), hc0=_carry(h0, c0), return_final=True)
    flip = (lambda a: a[:, ::-1]) if reverse else (lambda a: a)
    ref, (rh, rc) = jax_lstm_scan(
        jnp.asarray(flip(xq).copy()), jnp.asarray(flip(mask).copy()),
        jnp.asarray(w), jnp.asarray(bias),
        dot_dtype=None if dot is None else jnp.bfloat16,
        hc0=(jnp.asarray(h0), jnp.asarray(c0)), return_final=True)
    tol = TOL[dot]
    np.testing.assert_allclose(ys[0].transpose(0, 1).numpy(),
                               flip(np.asarray(ref)), atol=tol, rtol=tol)
    np.testing.assert_allclose(hf[0].numpy(), np.asarray(rh), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(cf[0].numpy(), np.asarray(rc), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_chunks_relaying_the_carry_equal_one_call(wrapper, reverse):
    """Three chunks of one direction, each from the (h, c) the chunk
    before it (in the direction's order) handed over, give one offline
    call's outputs and final state bit for bit, with and without the
    tape; with no carry in, the call is the offline one."""
    xproj, mask, w, bias, _, _ = _case(2, t=13)
    args, _ = _port(xproj, mask, w, bias, "bfloat16")
    xp, m, wd, b = args
    fn = getattr(lstm, wrapper)
    for tape in (False, True):
        whole = fn(xp, m, wd, b, (reverse,), tape, return_final=True)
        cuts = [(0, 4), (4, 9), (9, 13)]
        order = cuts[::-1] if reverse else cuts
        carry, pieces = None, {}
        for lo, hi in order:
            out = fn(xp[lo:hi].contiguous(), m[lo:hi].contiguous(), wd, b,
                     (reverse,), tape, hc0=carry, return_final=True)
            pieces[lo], carry = out[:-1], out[-1]
        for i in range(len(whole) - 1):
            got = torch.cat([pieces[lo][i] for lo, _ in cuts], dim=1)
            assert torch.equal(got, whole[i])
        assert all(torch.equal(a, b) for a, b in zip(carry, whole[-1]))
    plain = lstm.lstm_fwd_plain(xp, m, wd, b, (reverse,))
    assert torch.equal(fn(xp, m, wd, b, (reverse,)), plain)


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_zero_carry_equals_none_and_an_empty_chunk_hands_it_on(wrapper):
    xproj, mask, w, bias, h0, c0 = _case(3)
    args, _ = _port(xproj, mask, w, bias, None)
    fn = getattr(lstm, wrapper)
    none = fn(*args, (False, ), tape=True, return_final=True)
    zero = fn(*args, (False,), tape=True,
              hc0=_carry(np.zeros_like(h0), np.zeros_like(c0)),
              return_final=True)
    for a, b in zip((none[0], none[1], *none[2]), (zero[0], zero[1],
                                                   *zero[2])):
        assert torch.equal(a, b)
    xp, m, wd, b = args
    ys, (hf, cf) = fn(xp[:0], m[:0], wd, b, (True,), hc0=_carry(h0, c0),
                      return_final=True)
    assert ys.shape == (1, 0, 3, 24)
    assert torch.equal(hf[0], torch.from_numpy(h0))
    assert torch.equal(cf[0], torch.from_numpy(c0))


@pytest.mark.parametrize("bad,match", [
    (lambda h, c: (h,), "pair"),
    (lambda h, c: (h, None), "pair"),
    (lambda h, c: (h[:, :2], c), "h0 must be f32"),
    (lambda h, c: (h, c.double()), "c0 must be f32"),
    (lambda h, c: (h, c.transpose(1, 2).contiguous().transpose(1, 2)),
     "contiguous"),
], ids=["one", "none", "shape", "dtype", "layout"])
def test_bad_carries_raise(bad, match):
    xproj, mask, w, bias, h0, c0 = _case(4)
    args, _ = _port(xproj, mask, w, bias, None)
    with pytest.raises(ValueError, match=match):
        lstm.lstm_fwd(*args, (False,), hc0=bad(*_carry(h0, c0)))


def test_lstm_function_still_refuses_a_carry():
    """The autograd function now takes the carry (sequence-parallel
    training, item 14b-ii): its forward from ``(h0, c0)`` gives
    ``lstm_fwd``'s ``ys`` and final ``c`` with that carry, bit for bit;
    it still refuses half a carry."""
    xproj, mask, w, bias, h0, c0 = _case(5)
    args, _ = _port(xproj, mask, w, bias, None)
    hc0 = _carry(h0, c0)
    ys, c = lstm.LSTMFunction.apply(*args, *hc0, (False,))
    ref, (_, cf) = lstm.lstm_fwd(*args, (False,), hc0=hc0, return_final=True)
    assert torch.equal(ys, ref) and torch.equal(c, cf)
    with pytest.raises(ValueError, match="both"):
        lstm.LSTMFunction.apply(*args, hc0[0], None, (False,))
