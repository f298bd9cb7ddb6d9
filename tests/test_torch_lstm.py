"""The LSTM forward of the port (``ops/lstm.py``'s ``lstm_fwd``, its plain
version and tape, and ``models/rnn.py``'s oracle ``lstm_scan``) against
the JAX package's ``lstm_scan`` and ``lstm_scan_pallas`` run in
interpret mode, resident (``_lstm_kernel``, K12) and forced blocked
(``_lstm_kernel_blocked``, K14: ``rnn_pallas._VMEM_WEIGHT_BUDGET``
monkeypatched to 0); and the residency rule of the LSTM kernels.

H=16 is one padded block of the JAX blocked kernel, H=176 two with a
padded tail (4H=704 -> 512 + 192). The shapes chip_smoke.py holds the
streamed kernel (K14) to at CPU widths: D=2, T=37 with B=45 (above one
32-row pass) and B=8 (a partly filled m16 tile), H=40 (a multiple of 8
but not of the 32-unit groups: the tensor-core loop in bf16) and H=20
(not a multiple of 8: the CUDA-core kernel). Tolerances: 1e-5 with f32
dots; 3e-2 with bf16 dots (tests/test_pallas.py's for the fused cells:
the two sides round h_prev to bf16 at the same place but sum in other
orders, and a flipped rounding moves the next step).

On the CPU the wrappers run the plain version; chip_smoke.py holds the
CUDA kernels (csrc/lstm_fwd.cu, csrc/lstm_fwd_stream.cu) to it on the
card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.models.rnn import lstm_scan as jax_lstm_scan
from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu.ops.lstm_pallas import _lstm_pallas_raw, lstm_scan_pallas
from deepspeech_tpu_torch import k14_variants
from deepspeech_tpu_torch.models.rnn import lstm_scan
from deepspeech_tpu_torch.ops import _build, gru, lstm

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

B, T = 3, 9
TOL = {None: 1e-5, "bfloat16": 3e-2}


# chip_smoke.py's K14 check shapes at CPU widths: (T, B, H, D).
_K14_SHAPES = [pytest.param((37, 45, 40, 2), id="t37-b45-h40-d2"),
               pytest.param((37, 8, 40, 2), id="t37-b8-h40-d2"),
               pytest.param((37, 45, 20, 2), id="t37-b45-h20-d2")]


def _inputs(seed, h, d, bf16=False, t=T, b=B):
    """xproj [B,T,4H] (bf16 values when bf16), a ragged mask [B,T] (the
    first row full; at the default sizes lengths T, T-3 and 2), W
    [D,H,4H] and biases [D,4H], from numpy."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(b, t, 4 * h)).astype(np.float32)
    if bf16:
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    w = (rng.normal(size=(d, h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    bias = (rng.normal(size=(d, 4 * h)) * 0.1).astype(np.float32)
    if (t, b) == (T, B):
        lens = np.array([T, T - 3, 2])
    else:
        lens = rng.integers(t // 3, t + 1, size=b)
        lens[0] = t
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
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

def _directions(shape, reverse):
    """``(t, b, h, reverse flags)`` of a case: an int H is one direction
    at the default sizes; a ``(T, B, H, D)`` shape runs D=2 as
    ``(reverse, not reverse)``."""
    if isinstance(shape, int):
        return T, B, shape, (reverse,)
    t, b, h, d = shape
    return t, b, h, (reverse, not reverse)[:d]


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("h", [16, 176, *_K14_SHAPES])
@pytest.mark.parametrize("dot", [None, "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_pallas(monkeypatch, reverse, dot, h, blocked):
    """Each direction against the resident (K12) or blocked (K14) JAX
    kernel, at one direction of B=3, T=9 or at K14's check shapes."""
    if blocked:
        monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    t, b, h, rev = _directions(h, reverse)
    assert rnn_pallas._use_blocked(h, jnp.float32, n_gates=4) is blocked
    xproj, mask, w, bias = _inputs(10 + h, h, len(rev), dot is not None,
                                   t, b)
    ys = lstm.lstm_fwd_plain(*_port_args(xproj, mask, w, bias, dot), rev)
    for di, r in enumerate(rev):
        ref = _pallas(xproj, mask, w[di], bias[di], r, dot)
        np.testing.assert_allclose(ys[di].transpose(0, 1).numpy(), ref,
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


@pytest.mark.parametrize("reverse,blocked,shape,dot", [
    # One direction at B=3, T=9, H=176, f32 dots.
    *[pytest.param(r, bl, 176, None, id=f"{r}-{bl}")
      for r in (False, True) for bl in (False, True)],
    # K14's check shapes, D=2, bf16 and f32 dots.
    *[pytest.param(False, bl, sh.values[0], dot,
                   id=f"{bl}-{sh.id}-{dot or 'f32'}")
      for sh in _K14_SHAPES for bl in (False, True)
      for dot in (None, "bfloat16")]])
def test_tape_matches_the_pallas_cell_state(monkeypatch, reverse, blocked,
                                            shape, dot):
    """The tape ``cs`` against ``_lstm_pallas_raw(..., want_cs=True)``'s
    for each direction (masked frames hold c), and the outputs beside it
    unchanged."""
    if blocked:
        monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    t, b, h, rev = _directions(shape, reverse)
    xproj, mask, w, bias = _inputs(40, h, len(rev), dot is not None, t, b)
    args = _port_args(xproj, mask, w, bias, dot)
    ys, cs = lstm.lstm_fwd(*args, rev, tape=True)
    for di, r in enumerate(rev):
        ref_ys, ref_cs, _, _ = _lstm_pallas_raw(
            jnp.asarray(xproj), jnp.asarray(mask), jnp.asarray(w[di]),
            jnp.asarray(bias[di]), r, True, dot, want_cs=True)
        np.testing.assert_allclose(cs[di].numpy(), np.asarray(ref_cs),
                                   atol=TOL[dot], rtol=TOL[dot])
        np.testing.assert_allclose(ys[di].numpy(), np.asarray(ref_ys),
                                   atol=TOL[dot], rtol=TOL[dot])
    assert torch.equal(ys, lstm.lstm_fwd(*args, rev))
    # Masked frames hold both carries: past its length an utterance
    # keeps, in a forward direction, its state at its last frame, and in
    # a reverse one the zero state it starts from.
    lens = mask.sum(1).astype(int)
    for x in (ys, cs):
        for di, r in enumerate(rev):
            for bi, n in enumerate(lens):
                held = torch.zeros(h) if r else x[di, n - 1, bi]
                assert torch.equal(x[di, n:, bi], held.expand(t - n, h))


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


@pytest.mark.parametrize("dtype,h,mma", [
    (torch.bfloat16, 64, True),     # groups of 32 units
    (torch.bfloat16, 104, True),    # a multiple of 8, not of 32
    (torch.bfloat16, 100, False),   # not a multiple of 8
    (torch.float32, 64, False),     # f32: the CUDA-core kernel
])
def test_stream_scratch_follows_the_kernel_the_call_runs(dtype, h, mma):
    """``lstm_fwd_stream`` picks its C path before the launch, as
    ``lstm_fwd_stream_launch`` does: bf16 with H % 8 == 0 runs the
    tensor-core loop, whose scratch holds the cell state (f32), two
    rounded h rows and W^T (bf16); any other call the CUDA-core kernel,
    whose scratch is the cell state alone."""
    d, t, bsz = 2, 3, 5
    xp = torch.zeros(t, bsz, 4 * h, dtype=dtype)
    w = torch.zeros(d, h, 4 * h, dtype=dtype)
    assert lstm._fwd_mma(w) is mma
    scratch = lstm._fwd_stream_scratch(xp, w)
    assert scratch.dtype == torch.float32
    c_bytes = 4 * d * bsz * h
    extra = 2 * (2 * d * bsz * h) + 2 * (d * 4 * h * h) if mma else 0
    assert scratch.numel() * 4 == c_bytes + extra
    # The int8 streamed kernel's CUDA-core path (f32 dots) keeps its
    # [D,B,H] cell state alone; tests/test_torch_lstm_q.py checks its rule.
    wq = torch.zeros(d, h, 4 * h, dtype=torch.int8)
    assert lstm._fwd_q_stream_scratch(xp.float(), wq).numel() == d * bsz * h


@pytest.mark.parametrize("variant", [n for n, subs in
                                     k14_variants.VARIANTS.items() if subs])
def test_k14_variants_match_the_source(variant):
    """Each variant that ``deepspeech_tpu_torch.k14_variants`` builds
    replaces a constant that ``csrc/lstm_fwd_stream.cu`` holds exactly
    once, so the script times the loop it names."""
    with open(os.path.join(_build.CSRC_DIR, "lstm_fwd_stream.cu")) as f:
        src = f.read()
    for old, new in k14_variants.VARIANTS[variant]:
        assert src.count(old) == 1
        assert new != old


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
    # f32: the CUDA-core block; bf16 (H % 8 == 0): the tensor-core loop's,
    # tests/test_torch_lstm_fwd_mma.py.
    ("lstm_fwd", 2, 800, True),        # ds2_small: 220 KB; bf16 172 KB
    ("lstm_fwd", 1, 800, True),        # ds2_streaming; bf16 114 KB
    ("lstm_fwd", 2, 1760, False),      # ds2_full: 460 KB; bf16 220 groups
    ("lstm_fwd", 2, 832, True),        # h_pad 832: the last f32 H, 220 KB
    ("lstm_fwd", 1, 833, False),       # h_pad 896: 236 KB, in both
    # int8: f32 dots, the CUDA-core block of int8 slices; bf16 dots (H %
    # 8 == 0): K12's tensor-core rule on bf16(Q^T), tests/
    # test_torch_lstm_fwd_q_mma.py. "f32": resident with f32 dots alone.
    ("lstm_fwd_q", 2, 800, True),      # ds2_small int8: 80 KB; bf16 172
    ("lstm_fwd_q", 2, 1760, False),    # ds2_full int8: 220 of 132 slots
    ("lstm_fwd_q", 2, 1344, "f32"),    # 113 KB, two an SM: 168 of 264;
                                       # bf16: past K12's 1056
    ("lstm_fwd_q", 2, 1345, False),    # 117 KB, one an SM: 170 of 132
    ("lstm_fwd_q", 1, 1760, "f32"),    # 110 blocks; bf16: past 1216
    ("lstm_fwd_q", 2, 1056, True),     # bf16: K12's D=2 edge
    ("lstm_fwd_q", 2, 1064, "f32"),    # bf16: 134 groups of 16
    ("lstm_fwd_q", 1, 1216, True),     # bf16: K12's D=1 edge, 224 KB
    ("lstm_fwd_q", 1, 1224, "f32"),    # bf16: 228 KB a block
])
def test_residency_rule_of_the_lstm_kernels(dtype, kind, d, h, resident):
    if resident == "f32":
        resident = dtype == torch.float32
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
