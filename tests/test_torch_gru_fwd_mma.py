"""The tensor-core path of the GRU forward (``csrc/gru_fwd_mma.cuh``,
which ``csrc/gru_fwd.cu`` (K4 at D=2, K6 at D=1, all of W^T held in
shared memory) and ``csrc/gru_fwd_stream.cu`` (K8, W^T partly streamed)
run in bf16), mirrored in torch in its order of summation, against
``gru_fwd_plain`` and the JAX package's resident ``_bigru_kernel`` (K4)
and ``_gru_kernel`` (K6, with ``h0`` and the final carry) in interpret
mode; the rule that picks K4/K6's C path and sizes its scratch;
``k4_variants.plan`` against the residency rule; and the variants' and
ablations' substitutions.

The loop cannot run here (no card, no nvcc): chip_smoke.py holds the
kernels to ``gru_fwd_plain`` on the card. What the mirror checks is that
the order the header describes computes the contract's function: at
each step the H-deep sum ``round(h_prev) @ W`` cut into 32-deep chunks,
chunk c taken by the depth split c % NW_K (8 for groups under 32 units,
whose one warp holds all the group's columns; 4 for K8's 32), each chunk
two k16 steps whose depths are the lanes' 16-byte pieces (k = 8l..8l+3,
then 8l+4..8l+7), each depth split summing its chunks in turn, the
splits' partial sums added in order, then the bias (b_n too, before r
multiplies it). Tolerances: 1e-6 against the plain version with f32 dots
(f32 sums in another order), 3e-2 with bf16 dots (the repo's bf16
tolerance: a last-bit difference of the carry can flip a rounding of h),
1e-5 against the JAX kernels with f32 dots (the JAX Pallas tests' own).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops.rnn_pallas import (bigru_scan_pallas,
                                           gru_scan_pallas_stream)
from deepspeech_tpu_torch import k4_variants, k8_variants
from deepspeech_tpu_torch.k17_variants import built_value
from deepspeech_tpu_torch.ops import _build, gru

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

T, B = 9, 5


def _args(seed, h, d, dtype, with_h0, reverse=(False, True)):
    """``gru_fwd``'s arguments from numpy: xp [T,B,3H] and W [D,H,3H] in
    ``dtype``, a ragged mask, biases, h0 when asked."""
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy(
        rng.normal(size=(T, B, 3 * h)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(
        (rng.normal(size=(d, h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    ).to(dtype)
    bias = torch.from_numpy((rng.normal(size=(d, 3 * h)) * 0.1)
                            .astype(np.float32))
    h0 = (torch.from_numpy((rng.normal(size=(d, B, h)) * 0.5)
                           .astype(np.float32)) if with_h0 else None)
    lens = np.array([T, T - 3, 1, T - 1, 5])
    mask = torch.from_numpy(
        (np.arange(T)[:, None] < lens[None]).astype(np.float32))
    return xp, mask, w, bias, h0, tuple(reverse[:d])


def _mirror(xp, mask, w, b, h0, reverse, units):
    """``gru_fwd`` with the header's loop's gates in its order of
    summation (see the module docstring) for groups of ``units``; the
    chunk depth and the warps read from the header."""
    head = k4_variants.header_text()
    warps, kc = built_value(head, "M_WARPS"), built_value(head, "MKC")
    nw_k = warps // (1 if units < 32 else 2)
    d, h = w.shape[0], w.shape[1]
    w32 = w.float()
    steps = [[8 * lane + 4 * s + e for lane in range(4) for e in range(4)]
             for s in range(2)]

    def gates(di, hc):
        hr = hc.to(w.dtype).float()
        parts = torch.zeros(nw_k, hc.shape[0], 3 * h)
        for c in range(-(-h // kc)):
            for step in steps:
                p = [c * kc + x for x in step if c * kc + x < h]
                parts[c % nw_k] = parts[c % nw_k] + hr[:, p] @ w32[di][p]
        total = torch.zeros(hc.shape[0], 3 * h)
        for kk in range(nw_k):
            total = total + parts[kk]
        return total + b[di]
    return gru._fwd_plain_loop(xp, mask, h0, reverse, d, h, gates)


# ---------------------------------------------------------------------------
# The loop's order of summation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("d,h", [(2, 40), (1, 40), (2, 296), (1, 296)])
def test_loop_order_matches_plain(d, h, with_h0, dtype, tol):
    """The mirror at the launch's width against ``gru_fwd_plain``, ys and
    hfin: both round h_prev to the dot dtype at the same place and sum
    in f32 in other orders. H=40 is one whole and one partial chunk;
    H=296 ten chunks, depth splits 0 and 1 holding two."""
    args = _args(100 + h + d + 7 * with_h0, h, d, dtype, with_h0)
    units = gru.gru_fwd_mma_width(d, h)
    got = _mirror(*args, units)
    ref = gru.gru_fwd_plain(*args)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        err = float((g - r).abs().max())
        assert err <= tol, err
    assert float(ref[0].abs().max()) > 0.5


@pytest.mark.parametrize("h", [40, 296])
def test_loop_order_matches_the_k4_pallas_kernel(h):
    """Both directions of the mirror (D=2, the second reversed) summed,
    against ``bigru_scan_pallas`` (``_bigru_kernel``, K4) in interpret
    mode, f32 dots."""
    xp, mask, w, bias, _, reverse = _args(300 + h, h, 2, torch.float32,
                                          False)
    ys, _ = _mirror(xp, mask, w, bias, None, reverse,
                    gru.gru_fwd_mma_width(2, h))
    xproj = jnp.asarray(xp.transpose(0, 1).contiguous().numpy())
    mask_bt = jnp.asarray(mask.t().contiguous().numpy())
    ref = bigru_scan_pallas(xproj, mask_bt, jnp.asarray(w[0].numpy()),
                            jnp.asarray(bias[0].numpy()),
                            jnp.asarray(w[1].numpy()),
                            jnp.asarray(bias[1].numpy()), True, None)
    np.testing.assert_allclose((ys[0] + ys[1]).transpose(0, 1).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h", [40, 296])
def test_loop_order_matches_the_k6_pallas_kernel(h):
    """One direction of the mirror with a carried h0 against
    ``gru_scan_pallas_stream`` (``_gru_kernel``, K6) in interpret mode:
    ys and the final carry hfin, f32 dots."""
    xp, mask, w, bias, h0, reverse = _args(400 + h, h, 1, torch.float32,
                                           True)
    ys, hfin = _mirror(xp, mask, w, bias, h0, reverse,
                       gru.gru_fwd_mma_width(1, h))
    ref_ys, ref_h = gru_scan_pallas_stream(
        jnp.asarray(xp.transpose(0, 1).contiguous().numpy()),
        jnp.asarray(mask.t().contiguous().numpy()),
        jnp.asarray(w[0].numpy()), jnp.asarray(bias[0].numpy()),
        jnp.asarray(h0[0].numpy()), True, None)
    np.testing.assert_allclose(ys[0].transpose(0, 1).numpy(),
                               np.asarray(ref_ys), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hfin[0].numpy(), np.asarray(ref_h),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The C path rule, the scratch, and the launch's plan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,h,mma", [
    (torch.bfloat16, 800, True),     # ds2_small, ds2_streaming
    (torch.bfloat16, 104, True),     # a multiple of 8, not of the chunks
    (torch.bfloat16, 804, False),    # H % 8 != 0: the CUDA-core kernel
    (torch.bfloat16, 100, False),
    (torch.float32, 800, False),     # f32: the CUDA-core kernel
])
def test_path_rule_and_scratch(dtype, h, mma):
    """``_fwd_mma`` repeats ``gru_fwd_launch``'s rule (bf16, H % 8 == 0),
    which ``gru_fwd_stream_launch`` shares; the tensor-core path's
    scratch holds the two rounded h rows [2,D,B,H] and W^T [D,3H,H],
    both bf16, W^T starting 16-byte aligned; the CUDA-core kernel takes
    none."""
    d, t, bsz = 2, 3, 5
    xp = torch.zeros(t, bsz, 3 * h, dtype=dtype)
    w = torch.zeros(d, h, 3 * h, dtype=dtype)
    assert gru.gru_fwd_mma(dtype, h) is mma
    assert gru._fwd_mma(w) is mma
    scratch = gru._fwd_scratch(xp, w)
    assert scratch.dtype == torch.float32
    rows, wt = 2 * (2 * d * bsz * h), 2 * (d * 3 * h * h)
    assert scratch.numel() * 4 == (rows + wt if mma else 0)
    if mma:
        assert rows % 16 == 0


@pytest.mark.parametrize("d,h,units,smem", [
    (2, 800, 16, 142336),    # ds2_small: 100 groups of 16
    (1, 800, 8, 103936),     # ds2_streaming: 100 groups of 8
    (2, 528, 8, 91648),      # 132 groups of 8 on 132 SMs
    (2, 536, 16, 117760),    # 134 would not: 34 groups of 16 a direction
    (2, 1056, 16, 166912),   # the D=2 edge: 132 groups of 16
    (1, 1056, 8, 116224),    # the widest D=1 H in groups of 8
    (1, 1728, 16, 231424),   # the D=1 edge: 226 KB of the 227 a block
])
def test_launch_plan(d, h, units, smem):
    """``k4_variants.plan`` with the source's constants, the launch's
    choice: the width, the block's shared memory (the rings, 64 KB at 4
    stages, which the partial sums alias, then every 32-deep chunk of
    the group's W^T rows), and that it launches on an H100;
    ``ops/gru.py`` repeats both numbers."""
    values = {n: built_value(k4_variants.source_text(), n)
              for n in k4_variants.CONSTANTS}
    assert k4_variants.plan(values, d, h) == (units, smem, True)
    assert gru.gru_fwd_mma_width(d, h) == units
    assert gru.gru_fwd_mma_smem_bytes(units, h) == smem


def test_plan_agrees_with_the_residency_rule_at_every_size():
    """For every (D, H), H a multiple of 8 up to ds2_full's 1760, the
    residency rule admits bf16 exactly where the launch's plan launches,
    at the same width and bytes: the rule, the C launch and the variants
    script cannot part ways. ds2_full's H=1760 at D=2 stays on K8."""
    values = {n: built_value(k4_variants.source_text(), n)
              for n in k4_variants.CONSTANTS}
    admitted = 0
    for d in (1, 2):
        for h in range(8, 1768, 8):
            units, smem, launches = k4_variants.plan(values, d, h)
            fits = gru.resident_fits("fwd", d, h, 32, torch.bfloat16)
            assert fits is launches, (d, h)
            assert units == gru.gru_fwd_mma_width(d, h)
            assert smem == gru.resident_smem_bytes(
                "fwd", h, 32, torch.bfloat16, units)
            admitted += fits
    assert admitted == 1056 // 8 + 1728 // 8
    assert not gru.resident_fits("fwd", 2, 1760, 32, torch.bfloat16)


@pytest.mark.parametrize("dtype,d,h,b,resident", [
    (torch.bfloat16, 1, 800, 4096, True),    # whatever B on the mma path
    (torch.bfloat16, 1, 1160, 32, True),     # past the f32 slice's 1152
    (torch.float32, 1, 1152, 32, True),      # the f32 edge, as before
    (torch.float32, 1, 1160, 32, False),
    (torch.bfloat16, 1, 1150, 32, True),     # H % 8 != 0: the f32 slice
    (torch.bfloat16, 1, 1154, 32, False),
    (torch.bfloat16, 1, 1736, 32, False),    # 229 KB: K8
    (torch.bfloat16, 2, 1064, 32, False),    # 134 groups of 16
])
def test_forward_residency_follows_the_c_path(dtype, d, h, b, resident):
    """``gru_fwd`` decides between K4/K6 and K8 on the layout of the
    kernel its C call will run: in bf16 with H % 8 == 0 the tensor-core
    loop's block (W^T rows in bf16, nothing that grows with B); in f32
    and in bf16 off that rule the CUDA-core kernel's [H, 48] f32 slice,
    whose answer is the one before the tensor-core path."""
    assert gru.resident_fits("fwd", d, h, b, dtype) is resident


# ---------------------------------------------------------------------------
# The variants script, the ablations and the build.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(k4_variants.VARIANTS))
def test_k4_variants_match_the_source(variant):
    """Each constant a ``k4_variants`` variant sets is held exactly once
    by ``csrc/gru_fwd.cu``, each substitution finds its text, and every
    variant launches at ds2_small's and ds2_streaming's shapes on an
    H100."""
    text = k4_variants.source_text()
    built = {n: built_value(text, n) for n in k4_variants.CONSTANTS}
    values = k4_variants.VARIANTS[variant]
    for old, new in k4_variants.substitutions(text, values):
        assert text.count(old) == 1 and new != old
    for d in (1, 2):
        assert k4_variants.plan({**built, **values}, d, 800)[2]


@pytest.mark.parametrize("name", list(k4_variants.ABLATIONS))
def test_k4_ablations_match_the_header(name):
    """Each ``k4_variants`` ablation finds the header text it replaces
    exactly once, and ``csrc/gru_fwd.cu`` the ``#include`` it pastes the
    header into, so the script times the loop it names."""
    [(old, new)] = k4_variants.ablation(k4_variants.ABLATIONS[name])
    assert k4_variants.source_text().count(old) == 1
    assert new != k4_variants.header_text()
    assert set(k4_variants.MUST_FAIL) <= set(k4_variants.ABLATIONS)


def test_both_sources_share_the_header_and_its_hash(tmp_path, monkeypatch):
    """K4/K6 and K8 include ``gru_fwd_mma.cuh`` once each, K8 instances
    its loop with its own constants (the 32-unit groups, 3 ring stages,
    2 column splits and 4 resident chunks ``k8_variants`` substitutes)
    and K4/K6 with all of W^T held, and an edit of the header rebuilds
    both: each library's name hashes the headers its source includes."""
    include = '#include "gru_fwd_mma.cuh"\n'
    texts = {}
    for name in ("gru_fwd", "gru_fwd_stream"):
        with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
            texts[name] = f.read()
        assert texts[name].count(include) == 1
    k8 = texts["gru_fwd_stream"]
    assert [built_value(k8, n) for n in ("MU", "MS", "NW_N", "W_RES")] == \
        [32, 3, 2, 4]
    assert "gru_fwd_mma::loop<MU, MS, W_RES, NW_N>(" in k8
    assert "gru_fwd_mma::loop<MU, MS, gru_fwd_mma::W_ALL>(" in \
        texts["gru_fwd"]
    for subs in k8_variants.VARIANTS.values():
        for old, _ in subs:
            assert k8.count(old) == 1
    for name, text in texts.items():
        (tmp_path / f"{name}.cu").write_text(text)
    (tmp_path / "gru_fwd_mma.cuh").write_text(k4_variants.header_text())
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = {n: _build._target(n) for n in texts}
    (tmp_path / "gru_fwd_mma.cuh").write_text(
        k4_variants.header_text().replace("// ---- 1.", "// ---- one."))
    after = {n: _build._target(n) for n in texts}
    assert all(before[n] != after[n] for n in texts)
