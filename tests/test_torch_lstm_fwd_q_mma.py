"""The tensor-core path of the int8 LSTM forward (``csrc/lstm_fwd_q.cu``,
K16 at D=2 and D=1: ``csrc/lstm_fwd_mma.cuh``'s widening transpose,
``bf16(Q^T)``, then K12's loop with all of it resident and the scale on
the finished sums), mirrored in torch in its order of summation, against
``lstm_fwd_q_plain`` and the JAX package's resident ``_lstm_kernel_q``
(K16) in interpret mode; the widening; the rule that picks K16's C path
and sizes its scratch; ``k12_variants.plan`` with K16's constants against
the residency rule; and ``k16_variants``' substitutions and ablations.

The loop cannot run here (no card, no nvcc): chip_smoke.py holds the
kernel to ``lstm_fwd_q_plain`` on the card. What the mirror checks is
that the order the header describes computes the contract's function
with Q in place of W: at each step the H-deep sum ``round(h_prev) @ Q``
cut into 32-deep chunks, chunk c taken by the depth split c % 8 (one
warp over the group's 4*MU columns: MU=16 at D=2, 8 at D=1), each chunk
two k16 steps whose depths are the lanes' 16-byte pieces, each split
summing its chunks in turn, the splits' partial sums added in order,
then the scale, then the bias. Tolerances: 1e-6 against the plain
version with f32 dots (f32 sums in another order), 3e-2 with bf16 dots
(the repo's bf16 tolerance: a last-bit difference of a sum can flip a
rounding of h), 1e-5 against the JAX kernel with f32 dots (the JAX
Pallas tests' own).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops.lstm_pallas import lstm_scan_pallas_q
from deepspeech_tpu_torch import k12_variants, k16_variants
from deepspeech_tpu_torch.config import get_config
from deepspeech_tpu_torch.k17_variants import built_value
from deepspeech_tpu_torch.ops import _build, gru, lstm

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

T, B = 9, 5
SOURCES = ("lstm_fwd", "lstm_fwd_stream", "lstm_fwd_q")


def _args(seed, h, d, dtype, reverse=(False, True)):
    """``lstm_fwd_q``'s arguments from numpy: xp [T,B,4H] in ``dtype``, a
    ragged mask, int8 Q [D,H,4H] with per-column scales [D,4H] in
    utils/quantize.py's layout, biases."""
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy(
        rng.normal(size=(T, B, 4 * h)).astype(np.float32)).to(dtype)
    w = rng.normal(size=(d, h, 4 * h)) / np.sqrt(h)
    scale = (np.abs(w).max(axis=1) / 127.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[:, None]), -127, 127).astype(np.int8)
    bias = torch.from_numpy((rng.normal(size=(d, 4 * h)) * 0.1)
                            .astype(np.float32))
    lens = np.array([T, T - 3, 1, T - 1, 5])
    mask = torch.from_numpy(
        (np.arange(T)[:, None] < lens[None]).astype(np.float32))
    return (xp, mask, torch.from_numpy(q), torch.from_numpy(scale), bias,
            tuple(reverse[:d]))


def _mirror(xp, mask, q, scale, b, reverse):
    """``lstm_fwd_q`` with the header's loop's gates in its order of
    summation (see the module docstring) on W^T = bf16(Q^T), the chunk
    depth and the warps read from the header; the scale on the finished
    sums, then the bias."""
    head = k12_variants.header_text()
    kc, nw_k = built_value(head, "MKC"), built_value(head, "M_WARPS")
    h = q.shape[1]
    wt = q.transpose(1, 2).to(torch.bfloat16)      # the transpose's Wt
    w32 = wt.float().transpose(1, 2)
    steps = [[8 * lane + 4 * s + e for lane in range(4) for e in range(4)]
             for s in range(2)]

    def gates(di, hc):
        hr = hc.to(xp.dtype).float()
        parts = torch.zeros(nw_k, hc.shape[0], 4 * h)
        for c in range(-(-h // kc)):
            for step in steps:
                p = [c * kc + x for x in step if c * kc + x < h]
                parts[c % nw_k] = parts[c % nw_k] + hr[:, p] @ w32[di][p]
        total = torch.zeros(hc.shape[0], 4 * h)
        for kk in range(nw_k):
            total = total + parts[kk]
        return total * scale[di] + b[di]
    ys, _, _, _ = lstm.lstm_plain_loop(xp, mask, reverse, h, gates)
    return ys


# ---------------------------------------------------------------------------
# The loop's order of summation, and the widening.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("d", [2, 1], ids=["d2-mu16", "d1-mu8"])
@pytest.mark.parametrize("h", [40, 296])
def test_loop_order_matches_plain(h, d, dtype, tol):
    """The mirror against ``lstm_fwd_q_plain``: both round h_prev to the
    dot dtype at the same place, multiply by the same int8 values and
    scale the finished sums; they sum in f32 in other orders. H=40 is
    one whole and one partial chunk; H=296 ten chunks, depth splits 0
    and 1 holding two. Groups of 16 (D=2) and 8 (D=1) take the same
    order: one warp holds all of a group's columns."""
    args = _args(100 + h + d, h, d, dtype)
    got = _mirror(*args)
    ref = lstm.lstm_fwd_q_plain(*args)
    assert got.shape == ref.shape
    err = float((got - ref).abs().max())
    assert err <= tol, err
    assert float(ref.abs().max()) > 0.3


@pytest.mark.parametrize("h", [40, 296])
def test_loop_order_matches_the_k16_pallas_kernel(h):
    """Both directions of the mirror (D=2, the second reversed) against
    ``lstm_scan_pallas_q(..., blocked=False)`` (``_lstm_kernel_q``, K16)
    in interpret mode, one call a direction as the JAX model makes them,
    f32 dots."""
    xp, mask, q, scale, bias, reverse = _args(300 + h, h, 2, torch.float32)
    ys = _mirror(xp, mask, q, scale, bias, reverse)
    xproj = jnp.asarray(xp.transpose(0, 1).contiguous().numpy())
    mask_bt = jnp.asarray(mask.t().contiguous().numpy())
    for di, rev in enumerate(reverse):
        ref = lstm_scan_pallas_q(xproj, mask_bt, jnp.asarray(q[di].numpy()),
                                 jnp.asarray(scale[di].numpy()),
                                 jnp.asarray(bias[di].numpy()), rev, True,
                                 None, blocked=False)
        np.testing.assert_allclose(ys[di].transpose(0, 1).numpy(),
                                   np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_the_widening_is_exact_for_every_byte():
    """``bf16_bits(int8_t)`` rounds ``float(q)`` to bf16 to nearest: every
    byte from -128 to 127 has at most 8 significant bits and comes out
    exactly, so Wt holds Q itself and a bf16 product with it is the
    plain version's product with Q."""
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    assert torch.equal(q.float().to(torch.bfloat16).float(),
                       torch.arange(-128.0, 128.0))
    assert torch.equal(q.to(torch.bfloat16).float(), q.float())
    head = k12_variants.header_text()
    assert ("unsigned short bf16_bits(int8_t x) {\n"
            "  return __bfloat16_as_ushort(__float2bfloat16_rn(float(x)));"
            ) in head


# ---------------------------------------------------------------------------
# The C path rule, the scratch, and the launch's plan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,h,mma", [
    (torch.bfloat16, 800, True),     # ds2_small-lstm, ds2_streaming-lstm
    (torch.bfloat16, 104, True),     # a multiple of 8, not of the chunks
    (torch.bfloat16, 804, False),    # H % 8 != 0: the CUDA-core kernel
    (torch.bfloat16, 100, False),
    (torch.float32, 800, False),     # f32 dots: the CUDA-core kernel
])
def test_path_rule_and_scratch(dtype, h, mma):
    """``_fwd_q_mma`` repeats ``lstm_fwd_q_launch``'s rule on the dot
    dtype ``xp.dtype`` (Q is always int8): bf16, H % 8 == 0; the
    tensor-core path's scratch is ``lstm_fwd``'s: c [D,B,H] f32, the two
    rounded h rows [2,D,B,H] and bf16(Q^T) [D,4H,H], both bf16, each
    starting 16-byte aligned; the CUDA-core kernel takes none."""
    d, t, bsz = 2, 3, 5
    xp = torch.zeros(t, bsz, 4 * h, dtype=dtype)
    wq = torch.zeros(d, h, 4 * h, dtype=torch.int8)
    assert gru.lstm_fwd_mma(dtype, h) is mma
    assert lstm._fwd_q_mma(xp, wq) is mma
    scratch = lstm._fwd_q_scratch(xp, wq)
    assert scratch.dtype == torch.float32
    c, rows, wt = 4 * d * bsz * h, 2 * (2 * d * bsz * h), 2 * (d * 4 * h * h)
    assert scratch.numel() * 4 == (c + rows + wt if mma else 0)
    if mma:
        assert c % 16 == 0 and (c + rows) % 16 == 0
        w = torch.zeros(d, h, 4 * h, dtype=dtype)
        assert scratch.numel() == lstm._fwd_scratch(xp, w).numel()


def _built():
    return {n: built_value(k16_variants.source_text(), n)
            for n in k16_variants.CONSTANTS}


def test_k16_takes_k12s_constants():
    """K16's group widths and ring depths are K12's, so one rule, one
    layout and one plan serve both."""
    k12 = {n: built_value(k12_variants.source_text(), n)
           for n in k12_variants.CONSTANTS}
    assert _built() == k12 == {"MU_NARROW": 8, "MS_NARROW": 4,
                               "MU_WIDE": 16, "MS_WIDE": 4}


@pytest.mark.parametrize("d,h,units,smem", [
    (2, 800, 16, 176128),    # ds2_small-lstm int8: 100 groups of 16
    (1, 800, 8, 116736),     # ds2_streaming-lstm int8: 100 groups of 8
    (2, 808, 16, 180224),    # 51 groups of 16 a direction, the last half
    (2, 1056, 16, 208896),   # the D=2 edge: 132 groups of 16
    (1, 1216, 16, 229376),   # the D=1 edge: 224 KB of the 227 a block
])
def test_launch_plan(d, h, units, smem):
    """``k12_variants.plan`` with K16's constants: the width and the
    block's shared memory (the rings, which the partial sums alias, then
    every 32-deep chunk of the group's rows of bf16(Q^T)), and that it
    launches on an H100; the rule's layout for ``"lstm_fwd_q"`` in bf16
    repeats both numbers."""
    assert k12_variants.plan(_built(), d, h) == (units, smem, True)
    assert gru.lstm_fwd_mma_width(d, h) == units
    assert gru.resident_smem_bytes("lstm_fwd_q", h, 32, torch.bfloat16,
                                   units) == smem


def test_plan_agrees_with_the_residency_rule_at_every_size():
    """For every (D, H), H a multiple of 8 up to ds2_full's 1760, the
    residency rule admits bf16 int8 exactly where K16's launch plan
    launches, at the same width and bytes, and gives ``"lstm_fwd"``'s
    answer: the rule, the C launch and the variants script cannot part
    ways. It admits H up to 1056 at D=2 and 1216 at D=1, whatever B."""
    values = _built()
    admitted = {1: [], 2: []}
    for d in (1, 2):
        for h in range(8, 1768, 8):
            units, smem, launches = k12_variants.plan(values, d, h)
            for b in (1, 32, 4096):
                fits = gru.resident_fits("lstm_fwd_q", d, h, b,
                                         torch.bfloat16)
                assert fits is launches, (d, h, b)
                assert fits is gru.resident_fits("lstm_fwd", d, h, b,
                                                 torch.bfloat16)
            assert smem == gru.resident_smem_bytes(
                "lstm_fwd_q", h, 32, torch.bfloat16, units)
            if launches:
                admitted[d].append(h)
    assert admitted[2] == list(range(8, 1064, 8))
    assert admitted[1] == list(range(8, 1224, 8))


def test_ds2_full_lstm_int8_still_streams():
    """ds2_full's H=1760 (D=2) stays on the streamed kernel K17 with bf16
    and with f32 dots; ds2_small's and ds2_streaming's H=800 int8 LSTMs
    are resident in both, at either D."""
    h = get_config("ds2_full").model.rnn_hidden
    assert h == 1760
    for dtype in (torch.bfloat16, torch.float32):
        assert not gru.resident_fits("lstm_fwd_q", 2, h, 32, dtype)
        for preset in ("ds2_small", "ds2_streaming"):
            h_small = get_config(preset).model.rnn_hidden
            for d in (1, 2):
                assert gru.resident_fits("lstm_fwd_q", d, h_small, 32,
                                         dtype)


@pytest.mark.parametrize("dtype,d,h,b,resident", [
    (torch.bfloat16, 2, 800, 256, True),     # whatever B on the mma path
    (torch.float32, 2, 800, 256, True),      # 80 KB + 16 KB of c
    (torch.bfloat16, 2, 1344, 32, False),    # the moved range: K17
    (torch.float32, 2, 1344, 32, True),      # the f32 edge, as before
    (torch.bfloat16, 1, 1280, 32, False),    # the moved range: K17
    (torch.float32, 1, 1280, 32, True),
    (torch.bfloat16, 2, 804, 45, True),      # H % 8 != 0: the int8 slice
    (torch.bfloat16, 1, 2108, 32, True),     # H % 8 != 0: 132 blocks
])
def test_forward_residency_follows_the_c_path(dtype, d, h, b, resident):
    """``lstm_fwd_q`` decides between K16 and K17 on the layout of the
    kernel its C call will run: with bf16 dots and H % 8 == 0 the
    tensor-core loop's block (bf16(Q^T) rows, c in the scratch, nothing
    that grows with B); with f32 dots and off that rule the CUDA-core
    kernel's int8 slice and its cell state, whose answer is the one
    before the tensor-core path."""
    assert gru.resident_fits("lstm_fwd_q", d, h, b, dtype) is resident


# ---------------------------------------------------------------------------
# The variants script, the ablations and the build.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(k16_variants.VARIANTS))
def test_k16_variants_match_the_source(variant):
    """Each constant a ``k16_variants`` variant sets is held exactly once
    by ``csrc/lstm_fwd_q.cu``, each substitution finds its text, and
    every variant launches at ds2_small-lstm's and ds2_streaming-lstm's
    shapes on an H100."""
    text = k16_variants.source_text()
    values = k16_variants.VARIANTS[variant]
    for old, new in k16_variants.substitutions(text, values):
        assert text.count(old) == 1 and new != old
    for d in (1, 2):
        assert k12_variants.plan({**_built(), **values}, d, 800)[2]


@pytest.mark.parametrize("name", list(k16_variants.ABLATIONS))
def test_k16_ablations_match_the_header(name):
    """Each ``k16_variants`` ablation finds the header text it replaces
    exactly once, and ``csrc/lstm_fwd_q.cu`` the ``#include`` it pastes
    the header into, so the script times the loop it names; the scale's
    ablation is among those that must miss the tolerance."""
    [(old, new)] = k12_variants.ablation(k16_variants.ABLATIONS[name])
    assert k16_variants.source_text().count(old) == 1
    assert new != k12_variants.header_text()
    assert set(k16_variants.MUST_FAIL) <= set(k16_variants.ABLATIONS)
    assert "no_scale" in k16_variants.MUST_FAIL


def test_three_sources_share_the_header_and_its_hash(tmp_path, monkeypatch):
    """K12, K14 and K16 include ``lstm_fwd_mma.cuh`` once each; K16
    instances the loop with all of W^T held and the scale on (``SCALED``
    true), K12 and K14 with it off (the default), and K16's launch passes
    its scale where theirs pass NULL; an edit of the header rebuilds all
    three: each library's name hashes the headers its source includes."""
    include = '#include "lstm_fwd_mma.cuh"\n'
    texts = {}
    for name in SOURCES:
        with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
            texts[name] = f.read()
        assert texts[name].count(include) == 1
    assert "lstm_fwd_mma::loop<MU, MS, lstm_fwd_mma::W_ALL, NW_N, true>(" \
        in texts["lstm_fwd_q"]
    assert "lstm_fwd_mma::loop<MU, MS, lstm_fwd_mma::W_ALL>(" in \
        texts["lstm_fwd"]
    assert "lstm_fwd_mma::loop<MU, MS, W_RES, NW_N>(" in \
        texts["lstm_fwd_stream"]
    assert "true, xp, mask, wq, scale, bias, ys, nullptr, scratch" in \
        texts["lstm_fwd_q"]
    for name in ("lstm_fwd", "lstm_fwd_stream"):
        assert "w, nullptr, bias, ys, cs" in texts[name]
    for name, text in texts.items():
        (tmp_path / f"{name}.cu").write_text(text)
    (tmp_path / "lstm_fwd_mma.cuh").write_text(k12_variants.header_text())
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = {n: _build._target(n) for n in texts}
    (tmp_path / "lstm_fwd_mma.cuh").write_text(
        k12_variants.header_text().replace("// ---- 1.", "// ---- one."))
    after = {n: _build._target(n) for n in texts}
    assert all(before[n] != after[n] for n in texts)
