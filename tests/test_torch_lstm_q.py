"""The int8 LSTM forward of the port (``ops/lstm.py`` ``lstm_fwd_q``, its
plain version and the two kernels' wrappers) against the JAX package's
``lstm_scan_pallas_q`` run in interpret mode, resident
(``_lstm_kernel_q``, K16) and forced blocked (``_lstm_kernel_blocked_q``,
K17), and against the oracle ``lstm_scan`` on the dequantized weights.

H=16 is one padded block of the JAX blocked kernel, H=176 two. The
tolerances: 1e-5 with f32 dots, 2e-2 with bf16 dots
(tests/test_ops_quant_blocked.py's); against the dequantized oracle,
whose product rounds ``Q * scale`` where the kernels scale the finished
sums, 1e-4 in f32. The JAX package's two regimes are not held to each
other bit for bit: its own bit-identity test fails in interpret mode on
the CPU.

On the CPU the wrappers run the plain version; chip_smoke.py holds the
CUDA kernels (csrc/lstm_fwd_q.cu, csrc/lstm_fwd_q_stream.cu) to it on
the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.models.rnn import lstm_scan as jax_lstm_scan
from deepspeech_tpu.ops.lstm_pallas import lstm_scan_pallas_q
from deepspeech_tpu_torch.ops import gru, lstm

B, T = 3, 9
TOL = {None: 1e-5, "bfloat16": 2e-2}


def _inputs(seed, h, d, bf16):
    """xproj [B,T,4H] (bf16 values when bf16), a ragged mask [B,T], int8
    W [D,H,4H] with per-column scales [D,4H] in utils/quantize.py's
    layout, and biases [D,4H], from numpy."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(B, T, 4 * h)).astype(np.float32)
    if bf16:
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    w = rng.normal(size=(d, h, 4 * h)) / np.sqrt(h)
    scale = (np.abs(w).max(axis=1) / 127.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[:, None]), -127, 127).astype(np.int8)
    bias = (rng.normal(size=(d, 4 * h)) * 0.1).astype(np.float32)
    lens = np.array([T, T - 3, 2])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return xproj, mask, q, scale, bias


def _port_args(xproj, mask, q, scale, bias, bf16):
    dd = torch.bfloat16 if bf16 else torch.float32
    return (torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dd),
            torch.from_numpy(mask).t().contiguous(), torch.from_numpy(q),
            torch.from_numpy(scale), torch.from_numpy(bias))


def _jax(xproj, mask, q, scale, bias, rev, dot, **kw):
    return np.asarray(lstm_scan_pallas_q(
        jnp.asarray(xproj), jnp.asarray(mask), jnp.asarray(q),
        jnp.asarray(scale), jnp.asarray(bias), rev, True, dot, **kw))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("h", [16, 176])
@pytest.mark.parametrize("dot", [None, "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_pallas_q(reverse, dot, h, blocked):
    """One direction against the resident (K16) or forced blocked (K17)
    JAX kernel."""
    bf16 = dot is not None
    xproj, mask, q, scale, bias = _inputs(50 + h, h, 1, bf16)
    ref = _jax(xproj, mask, q[0], scale[0], bias[0], reverse, dot,
               blocked=blocked)
    ys = lstm.lstm_fwd_q_plain(*_port_args(xproj, mask, q, scale, bias,
                                           bf16), (reverse,))
    np.testing.assert_allclose(ys[0].transpose(0, 1).numpy(), ref,
                               atol=TOL[dot], rtol=TOL[dot])


@pytest.mark.parametrize("dot", [None, "bfloat16"])
def test_two_directions_equal_the_sum_of_two_jax_calls(dot):
    """D=2 in one call, summed, against the JAX model's composition of a
    forward and a reverse q call (models/rnn.py:205-225)."""
    bf16 = dot is not None
    xproj, mask, q, scale, bias = _inputs(61, 176, 2, bf16)
    ref = sum(_jax(xproj, mask, q[i], scale[i], bias[i], rev, dot)
              for i, rev in enumerate((False, True)))
    ys = lstm.lstm_fwd_q(*_port_args(xproj, mask, q, scale, bias, bf16),
                         (False, True))
    np.testing.assert_allclose(ys.sum(0).transpose(0, 1).numpy(), ref,
                               atol=2 * TOL[dot], rtol=TOL[dot])


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_the_dequantized_oracle(reverse):
    """``lstm_scan(xp, mask, Q * scale, b)``, the JAX oracle on the
    dequantized matrix (lstm_pallas.py:353-354)."""
    xproj, mask, q, scale, bias = _inputs(62, 176, 1, False)
    ref = jax_lstm_scan(jnp.asarray(xproj), jnp.asarray(mask),
                        jnp.asarray(q[0].astype(np.float32) * scale[0]),
                        jnp.asarray(bias[0]), reverse)
    ys = lstm.lstm_fwd_q_plain(*_port_args(xproj, mask, q, scale, bias,
                                           False), (reverse,))
    np.testing.assert_allclose(ys[0].transpose(0, 1).numpy(),
                               np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("blocked", [None, False, True])
def test_wrappers_run_the_plain_version_on_cpu(blocked):
    """On CPU tensors ``lstm_fwd_q`` (any ``blocked``) and
    ``lstm_fwd_q_stream`` are the plain version, bit for bit, and count
    no launch."""
    args = _port_args(*_inputs(63, 40, 2, True), True)
    counts = (lstm.lstm_fwd_q.launches, lstm.lstm_fwd_q_stream.launches)
    ref = lstm.lstm_fwd_q_plain(*args, (False, True))
    for got in (lstm.lstm_fwd_q(*args, (False, True), blocked=blocked),
                lstm.lstm_fwd_q_stream(*args, (False, True))):
        assert torch.equal(got, ref)
    assert (lstm.lstm_fwd_q.launches,
            lstm.lstm_fwd_q_stream.launches) == counts


def test_wrappers_reject_bad_arguments():
    args = _port_args(*_inputs(64, 16, 1, False), False)
    for fn in (lstm.lstm_fwd_q, lstm.lstm_fwd_q_stream):
        with pytest.raises(ValueError, match="int8"):
            fn(args[0], args[1], args[2].float(), *args[3:])
        with pytest.raises(ValueError, match="scale"):
            fn(*args[:3], args[3][:, :-1].contiguous(), args[4])
        with pytest.raises(ValueError, match="bf16 or f32"):
            fn(args[0].half(), *args[1:])


def test_forced_resident_that_does_not_fit_raises():
    """``blocked=False`` where the int8 slices do not fit raises, as the
    JAX kernel does past its 1-byte budget (lstm_pallas.py:368-371): at
    ds2_full's D=2, H=1760 the 220 blocks take one SM each on an H100,
    so the port streams there (K17) as the TPU does."""
    h = 1760
    assert not gru.resident_fits("lstm_fwd_q", 2, h, 1, torch.float32)
    args = (torch.zeros(1, 1, 4 * h), torch.ones(1, 1),
            torch.zeros(2, h, 4 * h, dtype=torch.int8),
            torch.ones(2, 4 * h), torch.zeros(2, 4 * h))
    with pytest.raises(ValueError, match="forced resident"):
        lstm.lstm_fwd_q(*args, (False, True), blocked=False)
    ys = lstm.lstm_fwd_q(*args, (False, True))
    assert ys.shape == (2, 1, 1, h)
