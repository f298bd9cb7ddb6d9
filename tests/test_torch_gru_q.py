"""The int8 GRU forward of the port (``ops/gru.py`` ``gru_fwd_q``, its
plain version and the two kernels' wrappers) against the JAX package's
``gru_scan_pallas_q`` run in interpret mode, resident (``_gru_kernel_q``,
K10) and forced blocked (``_gru_kernel_blocked_q``, K11), and the
residency rule that picks the kernel on the card.

H=16 is one padded block of the JAX blocked kernel, H=176 two with a
padded tail (3H=528 -> 512 + 16). Tolerances: 1e-5 with f32 dots, 2e-2
with bf16 dots (tests/test_ops_quant_blocked.py's). The JAX package's
two regimes are not held to each other bit for bit: its own
bit-identity tests fail in interpret mode on the CPU.

On the CPU the wrappers run the plain version; chip_smoke.py holds the
CUDA kernels (csrc/gru_fwd_q.cu, csrc/gru_fwd_q_stream.cu) to it on
the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu.ops.rnn_pallas import gru_scan_pallas_q
from deepspeech_tpu_torch.ops import gru

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

B, T = 3, 9
TOL = {None: 1e-5, "bfloat16": 2e-2}


def _inputs(seed, h, d, bf16):
    """xproj [B,T,3H] (bf16 values when bf16), a ragged mask [B,T], int8
    W [D,H,3H] with per-column scales [D,3H] in utils/quantize.py's
    layout, biases [D,3H] and h0 [D,B,H], from numpy."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(B, T, 3 * h)).astype(np.float32)
    if bf16:
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    w = rng.normal(size=(d, h, 3 * h)) / np.sqrt(h)
    scale = (np.abs(w).max(axis=1) / 127.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[:, None]), -127, 127).astype(np.int8)
    bias = (rng.normal(size=(d, 3 * h)) * 0.1).astype(np.float32)
    lens = np.array([T, T - 3, 2])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    h0 = (rng.normal(size=(d, B, h)) * 0.5).astype(np.float32)
    return xproj, mask, q, scale, bias, h0


def _port_args(xproj, mask, q, scale, bias, bf16):
    dd = torch.bfloat16 if bf16 else torch.float32
    return (torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dd),
            torch.from_numpy(mask).t().contiguous(), torch.from_numpy(q),
            torch.from_numpy(scale), torch.from_numpy(bias))


def _jax(xproj, mask, q, scale, bias, rev, dot, **kw):
    return gru_scan_pallas_q(jnp.asarray(xproj), jnp.asarray(mask),
                             jnp.asarray(q), jnp.asarray(scale),
                             jnp.asarray(bias), rev, True, dot, **kw)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("h", [16, 176])
@pytest.mark.parametrize("dot", [None, "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_pallas_q(reverse, dot, h, blocked):
    """One direction against the resident (K10) or forced blocked (K11)
    JAX kernel."""
    bf16 = dot is not None
    xproj, mask, q, scale, bias, _ = _inputs(20 + h, h, 1, bf16)
    ref = _jax(xproj, mask, q[0], scale[0], bias[0], reverse, dot,
               blocked=blocked)
    ys, hfin = gru.gru_fwd_q_plain(*_port_args(xproj, mask, q, scale, bias,
                                               bf16), None, (reverse,))
    np.testing.assert_allclose(ys[0].transpose(0, 1).numpy(), np.asarray(ref),
                               atol=TOL[dot], rtol=TOL[dot])
    # The carry after the last step is the last row the scan wrote.
    last = 0 if reverse else T - 1
    np.testing.assert_array_equal(hfin[0].numpy(), ys[0, last].numpy())


@pytest.mark.parametrize("dot", [None, "bfloat16"])
def test_two_directions_equal_the_sum_of_two_jax_calls(dot):
    """D=2 in one call, summed, against the JAX model's composition of a
    forward and a reverse q call (models/rnn.py:287)."""
    bf16 = dot is not None
    xproj, mask, q, scale, bias, _ = _inputs(31, 176, 2, bf16)
    ref = sum(np.asarray(_jax(xproj, mask, q[i], scale[i], bias[i], rev,
                              dot))
              for i, rev in enumerate((False, True)))
    ys, _ = gru.gru_fwd_q_plain(*_port_args(xproj, mask, q, scale, bias,
                                            bf16), None, (False, True))
    np.testing.assert_allclose(ys.sum(0).transpose(0, 1).numpy(), ref,
                               atol=2 * TOL[dot], rtol=TOL[dot])


@pytest.mark.parametrize("dot", [None, "bfloat16"])
def test_h0_and_final_carry_match_the_resident_h0_call(dot):
    """The carried-state form (rnn_pallas.py:691-706): ``h0`` in, the
    outputs and the final carry out."""
    bf16 = dot is not None
    xproj, mask, q, scale, bias, h0 = _inputs(32, 176, 1, bf16)
    ref_ys, ref_h = _jax(xproj, mask, q[0], scale[0], bias[0], False, dot,
                         h0=jnp.asarray(h0[0]))
    ys, hfin = gru.gru_fwd_q_plain(
        *_port_args(xproj, mask, q, scale, bias, bf16),
        torch.from_numpy(h0), (False,))
    np.testing.assert_allclose(ys[0].transpose(0, 1).numpy(),
                               np.asarray(ref_ys), atol=TOL[dot],
                               rtol=TOL[dot])
    np.testing.assert_allclose(hfin[0].numpy(), np.asarray(ref_h),
                               atol=TOL[dot], rtol=TOL[dot])


def test_budget_zero_dispatch_matches_plain(monkeypatch):
    """With the TPU budget forced to 0 the JAX q entry point streams by
    itself (no ``blocked``); the port's answer is the same function."""
    monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    assert rnn_pallas._use_blocked(176, jnp.float32, weight_bytes=1)
    xproj, mask, q, scale, bias, _ = _inputs(33, 176, 1, False)
    ref = _jax(xproj, mask, q[0], scale[0], bias[0], True, None)
    ys, _ = gru.gru_fwd_q(*_port_args(xproj, mask, q, scale, bias, False),
                          None, (True,))
    np.testing.assert_allclose(ys[0].transpose(0, 1).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("blocked", [None, False, True])
@pytest.mark.parametrize("h0", [False, True])
def test_wrappers_run_the_plain_version_on_cpu(blocked, h0):
    """On CPU tensors ``gru_fwd_q`` (any ``blocked``) and
    ``gru_fwd_q_stream`` are the plain version, bit for bit, and count
    no launch."""
    xproj, mask, q, scale, bias, hh = _inputs(34, 40, 2, True)
    args = _port_args(xproj, mask, q, scale, bias, True)
    hh = torch.from_numpy(hh) if h0 else None
    counts = (gru.gru_fwd_q.launches, gru.gru_fwd_q_stream.launches)
    ref = gru.gru_fwd_q_plain(*args, hh, (False, True))
    for got in (gru.gru_fwd_q(*args, hh, (False, True), blocked=blocked),
                gru.gru_fwd_q_stream(*args, hh, (False, True))):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (gru.gru_fwd_q.launches, gru.gru_fwd_q_stream.launches) == counts


def test_wrappers_reject_other_devices_and_bad_arguments():
    xproj, mask, q, scale, bias, _ = _inputs(35, 16, 1, False)
    args = _port_args(xproj, mask, q, scale, bias, False)
    meta = [a.to("meta") for a in args]
    for fn in (gru.gru_fwd_q, gru.gru_fwd_q_stream):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(*meta)
        with pytest.raises(ValueError, match="int8"):
            fn(args[0], args[1], args[2].float(), *args[3:])
        with pytest.raises(ValueError, match="scale"):
            fn(*args[:3], args[3][:, :-1].contiguous(), args[4])
        with pytest.raises(ValueError, match="bf16 or f32"):
            fn(args[0].half(), *args[1:])


def test_forced_resident_that_does_not_fit_raises():
    """``blocked=False`` where the int8 slices do not fit raises, as the
    JAX kernel does past its 1-byte budget (rnn_pallas.py:648-651): at
    D=2, H=2000 the 250 blocks take one SM each on an H100."""
    h = 2000
    assert not gru.resident_fits("fwd_q", 2, h, 1, torch.float32)
    args = (torch.zeros(1, 1, 3 * h), torch.ones(1, 1),
            torch.zeros(2, h, 3 * h, dtype=torch.int8),
            torch.ones(2, 3 * h), torch.zeros(2, 3 * h))
    with pytest.raises(ValueError, match="forced resident"):
        gru.gru_fwd_q(*args, None, (False, True), blocked=False)
    ys, _ = gru.gru_fwd_q(*args, None, (False, True))
    assert ys.shape == (2, 1, 1, h)


# ---------------------------------------------------------------------------
# The residency rule of the resident int8 kernel.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,h,resident", [
    (2, 1760, True),                      # ds2_full: 220 blocks, 2 an SM
    (1, 800, True), (2, 800, True),       # ds2_streaming, ds2_small
    (2, 1920, True), (2, 1936, False),    # 240 of 264 slots; 1 an SM
    (1, 2112, True), (1, 2128, False),    # 132 vs 133 blocks, 1 an SM
])
def test_residency_rule_of_the_int8_kernel(dtype, d, h, resident):
    assert gru.resident_fits("fwd_q", d, h, 32, dtype) is resident


def test_int8_rule_against_the_f32_slices():
    """At ds2_full's size the f32 slices miss and the int8 ones fit:
    87 KB of int8 slice and 21 KB of staging a block, two blocks an SM;
    the int8 rule reads the card as the other rules do."""
    assert gru.resident_smem_bytes("fwd_q", 1760, 32) == \
        48 * (1792 + 16) + 4 * (48 + 32) * 68 == 108544
    assert gru.resident_smem_bytes("fwd_q", 1760, 1) == \
        gru.resident_smem_bytes("fwd_q", 1760, 64)
    assert not gru.resident_fits("fwd", 2, 1760, 32, torch.bfloat16)
    assert gru.resident_fits("fwd_q", 2, 1760, 32, torch.bfloat16)
    assert not gru.resident_fits("fwd_q", 2, 1760, 32, torch.bfloat16,
                                 sms=66)
    assert not gru.resident_fits("fwd_q", 2, 1760, 32, torch.bfloat16,
                                 smem_per_sm=200 * 1024)
