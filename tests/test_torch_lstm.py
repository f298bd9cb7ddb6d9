"""The LSTM forward of the port (``ops/lstm.py``'s ``lstm_fwd``, its plain
version and tape, and ``models/rnn.py``'s oracle ``lstm_scan``) against
the JAX package's ``lstm_scan`` and ``lstm_scan_pallas`` run in
interpret mode, resident (``_lstm_kernel``, K12) and forced blocked
(``_lstm_kernel_blocked``, K14: ``rnn_pallas._VMEM_WEIGHT_BUDGET``
monkeypatched to 0); and the residency rule of the LSTM kernels.

H=16 is one padded block of the JAX blocked kernel, H=176 two with a
padded tail (4H=704 -> 512 + 192). Tolerances: 1e-5 with f32 dots; 3e-2
with bf16 dots (tests/test_pallas.py's for the fused cells: the two
sides round h_prev to bf16 at the same place but sum in other orders,
and a flipped rounding moves the next step).

On the CPU the wrappers run the plain version; chip_smoke.py holds the
CUDA kernels (csrc/lstm_fwd.cu, csrc/lstm_fwd_stream.cu) to it on the
card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.models.rnn import lstm_scan as jax_lstm_scan
from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu.ops.lstm_pallas import _lstm_pallas_raw, lstm_scan_pallas
from deepspeech_tpu_torch.models.rnn import lstm_scan
from deepspeech_tpu_torch.ops import gru, lstm

B, T = 3, 9
TOL = {None: 1e-5, "bfloat16": 3e-2}


def _inputs(seed, h, d, bf16=False):
    """xproj [B,T,4H] (bf16 values when bf16), a ragged mask [B,T],
    W [D,H,4H] and biases [D,4H], from numpy."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(B, T, 4 * h)).astype(np.float32)
    if bf16:
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    w = (rng.normal(size=(d, h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    bias = (rng.normal(size=(d, 4 * h)) * 0.1).astype(np.float32)
    lens = np.array([T, T - 3, 2])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return xproj, mask, w, bias


def _port_args(xproj, mask, w, bias, dot):
    dd = torch.bfloat16 if dot else torch.float32
    return (torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dd),
            torch.from_numpy(mask).t().contiguous(),
            torch.from_numpy(w).to(dd), torch.from_numpy(bias))


def _pallas(xproj, mask, w, bias, rev, dot):
    return np.asarray(lstm_scan_pallas(
        jnp.asarray(xproj), jnp.asarray(mask), jnp.asarray(w),
        jnp.asarray(bias), rev, True, dot))


# ---------------------------------------------------------------------------
# The oracle.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dot", [None, "bfloat16"])
def test_lstm_scan_matches_the_jax_oracle(reverse, dot):
    xproj, mask, w, bias = _inputs(1, 24, 1)
    ref = jax_lstm_scan(jnp.asarray(xproj), jnp.asarray(mask),
                        jnp.asarray(w[0]), jnp.asarray(bias[0]), reverse,
                        None if dot is None else jnp.bfloat16)
    got = lstm_scan(torch.from_numpy(xproj), torch.from_numpy(mask),
                    torch.from_numpy(w[0]), torch.from_numpy(bias[0]),
                    reverse, None if dot is None else torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=TOL[dot], rtol=TOL[dot])


def test_lstm_scan_carries_match_the_jax_oracle():
    """``hc0`` in and ``(h, c)`` out (models/rnn.py:134-181), and the
    guard against a carry on a reverse scan."""
    xproj, mask, w, bias = _inputs(2, 24, 1)
    rng = np.random.default_rng(3)
    h0, c0 = (rng.normal(size=(B, 24)).astype(np.float32) * 0.5
              for _ in range(2))
    ref, (ref_h, ref_c) = jax_lstm_scan(
        jnp.asarray(xproj), jnp.asarray(mask), jnp.asarray(w[0]),
        jnp.asarray(bias[0]), hc0=(jnp.asarray(h0), jnp.asarray(c0)),
        return_final=True)
    got, (h, c) = lstm_scan(
        torch.from_numpy(xproj), torch.from_numpy(mask),
        torch.from_numpy(w[0]), torch.from_numpy(bias[0]),
        hc0=(torch.from_numpy(h0), torch.from_numpy(c0)), return_final=True)
    for g, r in ((got, ref), (h, ref_h), (c, ref_c)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="forward scans"):
        lstm_scan(torch.from_numpy(xproj), torch.from_numpy(mask),
                  torch.from_numpy(w[0]), torch.from_numpy(bias[0]),
                  reverse=True, return_final=True)


# ---------------------------------------------------------------------------
# The plain version against the Pallas kernels.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("h", [16, 176])
@pytest.mark.parametrize("dot", [None, "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_pallas(monkeypatch, reverse, dot, h, blocked):
    """One direction against the resident (K12) or blocked (K14) JAX
    kernel."""
    if blocked:
        monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    assert rnn_pallas._use_blocked(h, jnp.float32, n_gates=4) is blocked
    xproj, mask, w, bias = _inputs(10 + h, h, 1, dot is not None)
    ref = _pallas(xproj, mask, w[0], bias[0], reverse, dot)
    ys = lstm.lstm_fwd_plain(*_port_args(xproj, mask, w, bias, dot),
                             (reverse,))
    np.testing.assert_allclose(ys[0].transpose(0, 1).numpy(), ref,
                               atol=TOL[dot], rtol=TOL[dot])


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dot", [None, "bfloat16"])
def test_two_directions_equal_the_sum_of_two_jax_calls(monkeypatch, dot,
                                                       blocked):
    """D=2 in one call, summed, against the JAX model's composition of a
    forward and a reverse call (models/rnn.py:288-290)."""
    if blocked:
        monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    xproj, mask, w, bias = _inputs(31, 176, 2, dot is not None)
    ref = sum(_pallas(xproj, mask, w[i], bias[i], rev, dot)
              for i, rev in enumerate((False, True)))
    ys = lstm.lstm_fwd(*_port_args(xproj, mask, w, bias, dot), (False, True))
    np.testing.assert_allclose(ys.sum(0).transpose(0, 1).numpy(), ref,
                               atol=2 * TOL[dot], rtol=TOL[dot])


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_tape_matches_the_pallas_cell_state(monkeypatch, reverse, blocked):
    """The tape ``cs`` against ``_lstm_pallas_raw(..., want_cs=True)``'s
    (masked frames hold c), and the outputs beside it unchanged."""
    if blocked:
        monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    xproj, mask, w, bias = _inputs(40, 176, 1)
    ref_ys, ref_cs, _, _ = _lstm_pallas_raw(
        jnp.asarray(xproj), jnp.asarray(mask), jnp.asarray(w[0]),
        jnp.asarray(bias[0]), reverse, True, None, want_cs=True)
    args = _port_args(xproj, mask, w, bias, None)
    ys, cs = lstm.lstm_fwd(*args, (reverse,), tape=True)
    np.testing.assert_allclose(cs[0].numpy(), np.asarray(ref_cs),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ys[0].numpy(), np.asarray(ref_ys),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(ys, lstm.lstm_fwd(*args, (reverse,)))
    # Masked frames hold both carries. Utterance 2 ends after row 1: a
    # forward scan holds its row-1 state to the end, a reverse one keeps
    # its zero state until it reaches row 1.
    for x in (ys, cs):
        held = torch.zeros(176) if reverse else x[0, 1, 2]
        assert torch.equal(x[0, 2:, 2], held.expand(T - 2, 176))


@pytest.mark.parametrize("tape", [False, True])
def test_wrappers_run_the_plain_version_on_cpu(tape):
    """On CPU tensors ``lstm_fwd`` and ``lstm_fwd_stream`` are the plain
    version, bit for bit, and count no launch."""
    xproj, mask, w, bias = _inputs(41, 40, 2, True)
    args = _port_args(xproj, mask, w, bias, "bfloat16")
    counts = (lstm.lstm_fwd.launches, lstm.lstm_fwd_stream.launches)
    ref = lstm.lstm_fwd_plain(*args, (False, True), tape)
    for got in (lstm.lstm_fwd(*args, (False, True), tape),
                lstm.lstm_fwd_stream(*args, (False, True), tape)):
        got, want = (got, ref) if tape else ((got,), (ref,))
        assert all(torch.equal(g, r) for g, r in zip(got, want))
    assert (lstm.lstm_fwd.launches, lstm.lstm_fwd_stream.launches) == counts


def test_wrappers_reject_other_devices_and_bad_arguments():
    """A tensor on another device never reaches the plain version, and
    the argument rules hold for every wrapper."""
    xproj, mask, w, bias = _inputs(42, 16, 1)
    args = _port_args(xproj, mask, w, bias, None)
    for fn in (lstm.lstm_fwd, lstm.lstm_fwd_stream):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(*[a.to("meta") for a in args])
        with pytest.raises(ValueError, match="4H"):
            fn(args[0][..., :-4].contiguous(), *args[1:])
        with pytest.raises(ValueError, match="reverse"):
            fn(*args, (False, True))
        with pytest.raises(ValueError, match="bf16 or f32"):
            fn(args[0].half(), args[1], args[2].half(), args[3])
        with pytest.raises(ValueError, match="b must be"):
            fn(*args[:3], args[3][:, :-1].contiguous())
    q = torch.zeros(w.shape, dtype=torch.int8)
    scale = torch.ones(1, 4 * 16)
    for fn in (lstm.lstm_fwd_q, lstm.lstm_fwd_q_stream):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(*[a.to("meta") for a in (args[0], args[1], q, scale,
                                        args[3])])
    with pytest.raises(ValueError, match="int8"):
        lstm.lstm_fwd_q(args[0], args[1], args[2], scale, args[3])


# ---------------------------------------------------------------------------
# The residency rule of the LSTM kernels.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,d,h,resident", [
    ("lstm_fwd", 2, 800, True),        # ds2_small: 220 KB, 100 blocks
    ("lstm_fwd", 1, 800, True),        # ds2_streaming
    ("lstm_fwd", 2, 1760, False),      # ds2_full: a 460 KB slice
    ("lstm_fwd", 2, 832, True),        # h_pad 832: the last H at 220 KB
    ("lstm_fwd", 1, 833, False),       # h_pad 896: 236 KB
    ("lstm_fwd_q", 2, 800, True),      # ds2_small int8: 80 KB
    ("lstm_fwd_q", 2, 1760, False),    # ds2_full int8: 220 of 132 slots
    ("lstm_fwd_q", 2, 1344, True),     # 113 KB, two an SM: 168 of 264
    ("lstm_fwd_q", 2, 1345, False),    # 117 KB, one an SM: 170 of 132
    ("lstm_fwd_q", 1, 1760, True),     # 110 blocks
])
def test_residency_rule_of_the_lstm_kernels(dtype, kind, d, h, resident):
    assert gru.resident_fits(kind, d, h, 32, dtype) is resident


def test_lstm_rule_layouts_and_the_gru_answers_unchanged():
    """The rule repeats each kernel's shared memory byte for byte: four
    gate columns a unit and the cell state of its rows; the GRU kinds
    answer as before."""
    assert gru.resident_smem_bytes("lstm_fwd", 800, 32) == \
        4 * (64 * (832 + 4) + 32 * 68 + 32 * 16) == 224768
    assert gru.resident_smem_bytes("lstm_fwd_q", 1760, 32) == \
        64 * (1792 + 16) + 4 * ((64 + 32) * 68 + 32 * 16) == 143872
    assert gru.resident_smem_bytes("lstm_fwd", 800, 64) == \
        gru.resident_smem_bytes("lstm_fwd", 800, 32) + 4 * 32 * 16
    # The cell state grows with the batch until the slice no longer fits.
    assert not gru.resident_fits("lstm_fwd", 2, 800, 256, torch.float32)
    assert gru.resident_smem_bytes("fwd", 800, 32) == \
        4 * (48 * (832 + 4) + 32 * 68)
    assert gru.resident_smem_bytes("fwd_q", 1760, 32) == 108544
    assert gru.resident_fits("fwd", 2, 800, 32, torch.bfloat16)
    assert gru.resident_fits("fwd_q", 2, 1760, 32, torch.bfloat16)
    assert not gru.resident_fits("fwd", 2, 1760, 32, torch.bfloat16)
    assert not gru.resident_fits("lstm_fwd", 2, 800, 32, torch.bfloat16,
                                 sms=66)
    with pytest.raises(ValueError, match="kind"):
        gru.resident_smem_bytes("lstm_bwd_q", 800, 32)
