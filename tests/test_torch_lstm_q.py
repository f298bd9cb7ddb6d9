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
the card. What of K17's tensor-core loop can be checked here is checked
here: its widening of s8 to bf16, bit for bit, and its order of
summation, mirrored in torch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.models.rnn import lstm_scan as jax_lstm_scan
from deepspeech_tpu.ops.lstm_pallas import lstm_scan_pallas_q
from deepspeech_tpu_torch import k17_variants
from deepspeech_tpu_torch.ops import gru, lstm

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

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


def _widen_like_the_kernel(q: np.ndarray) -> np.ndarray:
    """csrc/lstm_fwd_q_stream.cu's bit route in numpy: the transpose
    stores each byte biased, ``u = q ^ 0x80`` (q + 128, unsigned);
    ``widen4`` puts u into the low byte of the f32 ``2^23 + u``,
    subtracts ``2^23 + 128``, and keeps the upper half of the f32 as the
    bf16 bits."""
    u = (q.view(np.uint8) ^ np.uint8(0x80)).astype(np.uint32)
    f = (u | np.uint32(0x4B000000)).view(np.float32)
    f = f - np.float32(8388736.0)
    return (f.view(np.uint32) >> 16).astype(np.uint16)


def test_widening_is_exact_for_every_byte():
    """All 256 int8 bytes, widened by the kernel's bit route, give the
    bf16 that torch converts them to (-128 included), and the
    product's zero fill widens to +0."""
    q = np.arange(-128, 128, dtype=np.int8)
    want = torch.tensor(q).to(torch.bfloat16).view(torch.int16).numpy()
    got = _widen_like_the_kernel(q)
    np.testing.assert_array_equal(got.view(np.int16), want)
    assert _widen_like_the_kernel(np.zeros(1, np.int8))[0] == 0


def _q_pos(k: int, mkc: int) -> int:
    """csrc/lstm_fwd_q_stream.cu ``q_pos``: where the transpose puts
    depth k in a row of Q^T."""
    return k // mkc * mkc + 16 * (k % 32 // 8) + 8 * (k % mkc // 32) + k % 8


def _loop_order_gates(q, scale, bias, dtype):
    """The gates of csrc/lstm_fwd_q_stream.cu's tensor-core loop in its
    data layout and order of summation: Q^T as the transpose kernel
    writes it (rows padded to whole MKC-deep chunks, k permuted by
    ``q_pos``), each chunk's h taken as the lanes' pieces take it (lane
    l: k = 8l.. and 32 + 8l.. of the chunk, against positions 16l.. of
    Q^T), warp kw summing chunks kw, kw + NW_K, ... in turn, the warps'
    partial sums added in warp order, the scale on the finished sum.
    The constants are the source's own."""
    text = k17_variants._source_text()
    mkc = k17_variants.built_value(text, "MKC")
    nw_k = (k17_variants.built_value(text, "M_WARPS")
            // k17_variants.built_value(text, "NW_N"))
    d, h = q.shape[0], q.shape[1]
    n_chunks = -(-h // mkc)
    hp = n_chunks * mkc
    qt = torch.zeros(d, 4 * h, hp)
    qt[:, :, [_q_pos(k, mkc) for k in range(h)]] = q.float().transpose(1, 2)
    # Position p of a chunk: lane p // 16, byte e = p % 16 of its piece.
    lane_k = [c * mkc + 8 * (p % mkc // 16) + (p % 16 if p % 16 < 8 else
                                               24 + p % 16)
              for c in range(n_chunks) for p in range(mkc)]

    def gates(di, hc):
        hr = torch.zeros(hc.shape[0], hp)
        hr[:, :h] = hc.to(dtype).float()
        hr = hr[:, lane_k]
        total = torch.zeros(hc.shape[0], 4 * h)
        for kw in range(nw_k):
            part = torch.zeros(hc.shape[0], 4 * h)
            for c in range(kw, n_chunks, nw_k):
                k = slice(c * mkc, (c + 1) * mkc)
                part = part + hr[:, k] @ qt[di][:, k].t()
            total = total + part
        return total * scale[di] + bias[di]
    return gates


@pytest.mark.parametrize("h", [48, 176])
def test_loop_order_matches_plain_and_the_blocked_pallas_kernel(h):
    """The tensor-core loop's layout and order of summation, mirrored in
    f32 at D=2, T=9, B=5: within 1e-6 of ``lstm_fwd_q_plain`` and, a
    direction at a time, within 1e-5 of the JAX blocked kernel (K17) in
    interpret mode. H=48 is one padded chunk, H=176 three, over three
    warps."""
    rng = np.random.default_rng(70 + h)
    t, bsz, d = 9, 5, 2
    xproj = rng.normal(size=(bsz, t, 4 * h)).astype(np.float32)
    w = rng.normal(size=(d, h, 4 * h)) / np.sqrt(h)
    scale = (np.abs(w).max(axis=1) / 127.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[:, None]), -127, 127).astype(np.int8)
    bias = (rng.normal(size=(d, 4 * h)) * 0.1).astype(np.float32)
    lens = np.array([t, t - 3, 2, t - 1, 5])
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    args = _port_args(xproj, mask, q, scale, bias, False)
    reverse = (False, True)
    ys, _, _, _ = lstm.lstm_plain_loop(
        args[0], args[1], reverse, h,
        _loop_order_gates(args[2], args[3], args[4], torch.float32))
    ref = lstm.lstm_fwd_q_plain(*args, reverse)
    np.testing.assert_allclose(ys.numpy(), ref.numpy(), atol=1e-6,
                               rtol=1e-6)
    for di, rev in enumerate(reverse):
        pal = _jax(xproj, mask, q[di], scale[di], bias[di], rev, None,
                   blocked=True)
        np.testing.assert_allclose(ys[di].transpose(0, 1).numpy(), pal,
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,h,mma", [
    (torch.bfloat16, 1760, True),   # ds2_full: rows padded to 1792
    (torch.bfloat16, 104, True),    # a multiple of 8, not of 32 or 64
    (torch.bfloat16, 128, True),    # rows unpadded
    (torch.bfloat16, 108, False),   # a multiple of 4, not of 8
    (torch.bfloat16, 100, False),
    (torch.float32, 1760, False),   # f32 dots: the CUDA-core kernel
])
def test_q_stream_rule_and_scratch(dtype, h, mma):
    """``lstm_fwd_q_stream`` picks its C path before the launch, as
    ``lstm_fwd_q_stream_launch`` does: the dot dtype is ``xp``'s (Q is
    always int8), and bf16 with H % 8 == 0 runs the tensor-core loop,
    whose scratch holds the cell state (f32), two rounded h rows (bf16)
    and Q^T (int8, rows padded to a multiple of 64); any other call the
    CUDA-core kernel, whose scratch is the cell state alone."""
    d, t, bsz = 2, 3, 5
    xp = torch.zeros(t, bsz, 4 * h, dtype=dtype)
    wq = torch.zeros(d, h, 4 * h, dtype=torch.int8)
    assert lstm._fwd_q_stream_mma(xp, wq) is mma
    scratch = lstm._fwd_q_stream_scratch(xp, wq)
    assert scratch.dtype == torch.float32
    hp = (h + 63) // 64 * 64
    extra = 2 * (2 * d * bsz * h) + d * 4 * h * hp if mma else 0
    assert scratch.numel() * 4 == 4 * d * bsz * h + extra


@pytest.mark.parametrize("variant", sorted(k17_variants.VARIANTS))
def test_k17_variants_match_the_source(variant):
    """Each constant a ``k17_variants`` variant sets is held exactly
    once by ``csrc/lstm_fwd_q_stream.cu``, and the ``no_widening``
    substitution finds the widening it replaces, so the script builds
    the loops it names."""
    text = k17_variants._source_text()
    for name in k17_variants.VARIANTS[variant]:
        k17_variants.built_value(text, name)
    for old, new in k17_variants.substitutions(
            text, k17_variants.VARIANTS[variant]):
        assert text.count(old) == 1 and new != old
    assert text.count(k17_variants._WIDEN) == 1
