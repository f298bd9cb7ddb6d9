"""The streamed GRU regime of the port (ops/gru.py): the residency rule
that picks the resident or the streamed kernel, and ``GRUFunction`` in
the sizes that take the streamed kernels against the JAX package's
blocked Pallas kernels (``_gru_kernel_blocked``, ``_gru_bwd_kernel_blocked``)
run in interpret mode, as tests/test_pallas.py runs them: the residency
budget is forced to 0 inside the test only, so H=176 (3H=528, two
512-column blocks) takes the blocked path. Also the decomposition the
streamed backward kernel (``csrc/gru_bwd_stream.cu``, K9) runs in bf16,
every row's gates first as one product and then the serial loop, against
``gru_bwd_plain`` and the blocked Pallas VJP; that kernel's path rule and
scratch; and ``k9_variants``'s substitutions. For the streamed forward
(``csrc/gru_fwd_stream.cu``, K8): its path rule and scratch, its
tensor-core loop's order of summation mirrored in torch against
``gru_fwd_plain`` and the blocked Pallas kernel, and ``k8_variants``'s
substitutions.

On the CPU the wrappers run their plain versions; chip_smoke.py holds
the CUDA kernels to those plain versions on the card. Tolerances: 1e-4
in float32 (the JAX Pallas gradient tests' own), 3e-2 of the largest
reference value with bf16 dots (the JAX bf16 test's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu.ops.rnn_pallas import gru_scan_pallas
from deepspeech_tpu_torch import k8_variants, k9_variants, k17_variants
from deepspeech_tpu_torch.config import get_config
from deepspeech_tpu_torch.ops import _build, gru
from test_torch_gru_bwd import _close

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

H, B, T = 176, 3, 9


@pytest.fixture
def force_blocked(monkeypatch):
    monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    assert rnn_pallas._use_blocked(H, jnp.float32)
    assert rnn_pallas._block_layout(3 * H) == (2, 512)


# ---------------------------------------------------------------------------
# The residency rule.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,h,resident", [
    (1, 800, True), (2, 800, True),        # ds2_streaming, ds2_small
    (2, 1760, False), (1, 1760, False),    # ds2_full, one direction
    (2, 1056, True), (2, 1072, False),     # 132 vs 134 blocks on 132 SMs
])
def test_residency_rule_at_the_sizes_that_matter(kind, dtype, d, h,
                                                 resident):
    assert gru.resident_fits(kind, d, h, 32, dtype) is resident


@pytest.mark.parametrize("d,h,b,bf16,f32", [
    (1, 800, 2048, True, False),   # bf16 holds W's rows whatever B
    (2, 800, 512, True, False),
    (1, 1200, 32, True, False),    # 75 groups of 16; f32's slice misses
    (2, 1056, 512, True, False),   # the D=2 edge: 132 groups of 16
    (1, 1704, 32, True, False),    # the D=1 edge: 224 KB a block
    (1, 1712, 32, False, False),   # 232 KB: over the 227 a block may have
    (2, 1064, 8, False, False),    # 134 groups of 16 on 132 SMs
])
def test_backward_residency_in_bf16_is_the_tensor_core_loops(d, h, b, bf16,
                                                             f32):
    """The GRU backward's rule in bf16 with H % 8 == 0 is the tensor-core
    loop's (``gru_bwd_mma_width``, ``gru_bwd_mma_smem_bytes``): one block
    an SM for each group, W's rows in bf16, nothing that grows with B; in
    f32 the CUDA-core kernel's, whose f32 slice and carried dh fit less
    H and less B."""
    assert gru.resident_fits("bwd", d, h, b, torch.bfloat16) is bf16
    assert gru.resident_fits("bwd", d, h, b, torch.float32) is f32


@pytest.mark.parametrize("preset,resident", [
    ("ds2_small", True), ("ds2_streaming", True), ("ds2_full", False)])
def test_presets_take_their_kernels(preset, resident):
    """At the main paths' batch (32) each preset's layers run the kernel
    that holds them: ds2_small and ds2_streaming stay on the resident
    kernels, ds2_full streams, forward and backward."""
    m = get_config(preset).model
    d = 2 if m.bidirectional else 1
    for kind in ("fwd", "bwd"):
        assert gru.resident_fits(kind, d, m.rnn_hidden, 32,
                                 torch.bfloat16) is resident


def test_residency_rule_reads_the_card():
    """The card's limits are parameters: a card with half the SMs cannot
    hold ds2_small's 100 blocks; one with less shared memory per block
    cannot hold the f32 kernel's 169 KB slice (f32 stages W as f32), nor,
    below 139 KB, the bf16 tensor-core loop's block of W^T rows; the
    backward's carried dh grows with the batch until the slice no longer
    fits."""
    args = ("fwd", 2, 800, 32, torch.bfloat16)
    assert gru.resident_fits(*args)
    assert not gru.resident_fits(*args, sms=66)
    assert not gru.resident_fits("fwd", 2, 800, 32, torch.float32,
                                 smem_per_block=160 * 1024)
    assert gru.resident_fits(*args, smem_per_block=160 * 1024)
    assert not gru.resident_fits(*args, smem_per_block=128 * 1024)
    smem = gru.resident_smem_bytes("fwd", 800, 32)
    assert smem == 4 * (48 * (832 + 4) + 32 * 68)
    assert gru.resident_smem_bytes("bwd", 800, 64) > \
        gru.resident_smem_bytes("bwd", 800, 32) > smem
    assert not gru.resident_fits("bwd", 1, 800, 2048, torch.float32)
    with pytest.raises(ValueError):
        gru.resident_fits("fwd", 1, 800, 32, torch.float16)
    with pytest.raises(ValueError):
        gru.resident_smem_bytes("both", 800, 32)


# ---------------------------------------------------------------------------
# GRUFunction against the blocked Pallas kernels.
# ---------------------------------------------------------------------------

def _inputs(seed, d, bf16):
    """xproj [B,T,3H] (bf16 values when bf16), ragged mask [B,T],
    weights and biases per direction, dy [B,T,H], from numpy."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(B, T, 3 * H)).astype(np.float32)
    if bf16:
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    ws = [(rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32)
          for _ in range(d)]
    bs = [(rng.normal(size=(3 * H,)) * 0.1).astype(np.float32)
          for _ in range(d)]
    lens = np.array([T, T - 3, 2])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    dy = rng.normal(size=(B, T, H)).astype(np.float32)
    return xproj, mask, ws, bs, dy


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("reverse", [(False,), (True,), (False, True)])
def test_gru_function_matches_blocked_pallas(force_blocked, reverse, bf16):
    """The summed outputs of D directions and the gradients of
    sum(dy * out) with respect to xproj, each W and each b, against one
    blocked ``gru_scan_pallas`` per direction (the JAX model's
    composition when a BiGRU misses the budget, models/rnn.py:287)."""
    d = len(reverse)
    xproj, mask, ws, bs, dy = _inputs(10 + d, d, bf16)
    dot = "bfloat16" if bf16 else None
    m = jnp.asarray(mask)

    def jax_out(xp, ws_, bs_):
        return sum(gru_scan_pallas(xp, m, w, b, rev, True, dot)
                   for w, b, rev in zip(ws_, bs_, reverse))

    primals = (jnp.asarray(xproj), [jnp.asarray(w) for w in ws],
               [jnp.asarray(b) for b in bs])
    ref, vjp = jax.vjp(jax_out, *primals)
    dxp_ref, dws_ref, dbs_ref = vjp(jnp.asarray(dy))

    dd = torch.bfloat16 if bf16 else torch.float32
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dd)
    xp.requires_grad_()
    w = torch.stack([torch.from_numpy(x) for x in ws]).requires_grad_()
    b = torch.stack([torch.from_numpy(x) for x in bs]).requires_grad_()
    ys = gru.GRUFunction.apply(xp, torch.from_numpy(mask).t().contiguous(),
                               w, b, None, reverse)
    out = ys.sum(0).transpose(0, 1)
    _close(out.detach().numpy(), ref, bf16, "ys")
    (out * torch.from_numpy(dy)).sum().backward()
    _close(xp.grad.float().transpose(0, 1).numpy(), dxp_ref, bf16, "dxproj")
    for di in range(d):
        _close(w.grad[di].numpy(), dws_ref[di], bf16, f"dw[{di}]")
        _close(b.grad[di].numpy(), dbs_ref[di], bf16, f"db[{di}]")


@pytest.mark.parametrize("h0", [False, True])
def test_stream_wrappers_run_the_plain_versions_on_cpu(h0):
    """On CPU tensors ``gru_fwd_stream`` and ``gru_bwd_stream`` are their
    plain versions, bit for bit, and count no launch."""
    xproj, mask, ws, bs, dy = _inputs(3, 2, False)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    m = torch.from_numpy(mask).t().contiguous()
    w = torch.stack([torch.from_numpy(x) for x in ws])
    b = torch.stack([torch.from_numpy(x) for x in bs])
    hh = torch.full((2, B, H), 0.25) if h0 else None
    launches = (gru.gru_fwd_stream.launches, gru.gru_bwd_stream.launches)
    ys, hfin = gru.gru_fwd_stream(xp, m, w, b, hh, (False, True))
    ys_p, hfin_p = gru.gru_fwd_plain(xp, m, w, b, hh, (False, True))
    assert torch.equal(ys, ys_p) and torch.equal(hfin, hfin_p)
    dys = torch.from_numpy(dy).transpose(0, 1).contiguous()
    dys = torch.stack([dys, 0.5 * dys])
    got = gru.gru_bwd_stream(xp, m, w, b, ys, dys, (False, True))
    ref = gru.gru_bwd_plain(xp, m, w, b, ys, dys, (False, True))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (gru.gru_fwd_stream.launches,
            gru.gru_bwd_stream.launches) == launches


@pytest.mark.parametrize("fn", ["gru_fwd_stream", "gru_bwd_stream"])
def test_stream_wrappers_reject_other_devices_and_bad_shapes(fn):
    xproj, mask, ws, bs, _ = _inputs(4, 1, False)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    m = torch.from_numpy(mask).t().contiguous()
    w, b = torch.from_numpy(ws[0])[None], torch.from_numpy(bs[0])[None]
    extra = (None,) if fn == "gru_fwd_stream" else (
        torch.zeros(1, T, B, H), torch.zeros(1, T, B, H))
    meta = [x.to("meta") if x is not None else None
            for x in (xp, m, w, b, *extra)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        getattr(gru, fn)(*meta, (False,))
    with pytest.raises(ValueError):
        getattr(gru, fn)(xp[:, :, :-1].contiguous(), m, w, b, *extra,
                         (False,))



# ---------------------------------------------------------------------------
# K9's tensor-core decomposition (csrc/gru_bwd_stream.cu, bf16 path): every
# row's gates first as one product, then the serial loop on them.
# ---------------------------------------------------------------------------

def _k9_decomposed(xp, mask, w, b, ys, dy, reverse):
    """The bf16 path of ``csrc/gru_bwd_stream.cu`` in plain PyTorch, at
    any dtype: the gate pre-pass ``pre = round(h_prev) @ W + b`` for all
    T*B rows of a direction at once (h_prev from ``gru._h_prev``), then
    the serial loop on ``pre``: ``dh = its elementwise part +
    round(dg_prev) @ W^T``, ``dz`` from the f32 h_prev, the rounded row
    carrying ``(da_r, da_z, dg_n)`` (the n column's ``dg_n = da_n * r``,
    not ``da_n``)."""
    d, t, bsz, h = ys.shape
    w32 = w.float()
    hp = gru._h_prev(ys, reverse)
    pre = (torch.bmm(hp.to(w.dtype).float().reshape(d, t * bsz, h), w32)
           .reshape(d, t, bsz, 3 * h) + b[:, None, None])
    dxp = torch.empty((d, t, bsz, 3 * h))
    dgates = torch.empty_like(dxp)
    for di in range(d):
        de = torch.zeros((bsz, h))
        dgr = None
        for i in range(t):
            row = i if reverse[di] else t - 1 - i
            carry = de if dgr is None else de + dgr @ w32[di].t()
            g, x = pre[di, row], xp[row].float()
            g_n = g[:, 2 * h:]
            r = torch.sigmoid(x[:, :h] + g[:, :h])
            z = torch.sigmoid(x[:, h:2 * h] + g[:, h:2 * h])
            n = torch.tanh(x[:, 2 * h:] + r * g_n)
            m = mask[row][:, None]
            dhc = carry + dy[di, row]
            dh_mid = m * dhc
            da_n = dh_mid * (1.0 - z) * (1.0 - n * n)
            da_z = dh_mid * (hp[di, row] - n) * z * (1.0 - z)
            da_r = da_n * g_n * r * (1.0 - r)
            dg = torch.cat([da_r, da_z, da_n * r], 1)
            dxp[di, row] = torch.cat([da_r, da_z, da_n], 1)
            dgates[di, row] = dg
            dgr = dg.to(w.dtype).float()
            de = dh_mid * z + (1.0 - m) * dhc
    return dxp, dgates


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("reverse", [(False,), (True,), (False, True),
                                     (True, False)])
@pytest.mark.parametrize("h", [16, 24])
def test_k9_decomposition_matches_plain_and_blocked_pallas(
        monkeypatch, h, reverse, bf16):
    """K9's decomposition on the blocked JAX forward's own outputs
    against ``gru_bwd_plain`` (f32: 1e-6; bf16: the same roundings at
    the same places, so 1e-6 too unless a last-bit difference of the
    f32 gate sums flips a bf16 rounding, which moves dgates by 2**-8
    of itself: 1e-2 of the largest value) and against the blocked Pallas
    VJP, ``_gru_bwd_kernel_blocked`` in interpret mode (dxp, and dW and
    db formed from dgates as ``_gru_bwd`` forms them; f32 1e-4, bf16 the
    module's 3e-2)."""
    monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    dot = "bfloat16" if bf16 else None
    assert rnn_pallas._use_blocked(h, rnn_pallas._dot_jnp_dtype(dot))
    d = len(reverse)
    rng = np.random.default_rng(100 + h + 7 * d + 3 * reverse[0])
    xproj = rng.normal(size=(B, T, 3 * h)).astype(np.float32)
    if bf16:
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    ws = (rng.normal(size=(d, h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    bs = (rng.normal(size=(d, 3 * h)) * 0.1).astype(np.float32)
    lens = np.array([T, T - 3, 1])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    dys = rng.normal(size=(d, B, T, h)).astype(np.float32)
    ys, ref = [], []
    for di, rev in enumerate(reverse):
        _, res = rnn_pallas._gru_fwd(
            jnp.asarray(xproj), jnp.asarray(mask), jnp.asarray(ws[di]),
            jnp.asarray(bs[di]), rev, True, dot)
        ys.append(np.array(res[4]))
        ref.append(rnn_pallas._gru_bwd(rev, True, dot, res,
                                       jnp.asarray(dys[di])))
    dd = torch.bfloat16 if bf16 else torch.float32
    args = (torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dd),
            torch.from_numpy(mask).t().contiguous(),
            torch.from_numpy(ws).to(dd), torch.from_numpy(bs),
            torch.from_numpy(np.stack(ys)),
            torch.from_numpy(dys).transpose(1, 2).contiguous(), reverse)
    dxp, dgates = _k9_decomposed(*args)
    dxp_p, dgates_p = gru.gru_bwd_plain(*args)
    tol = 1e-2 * max(1.0, float(dgates_p.abs().max())) if bf16 else 1e-6
    torch.testing.assert_close(dxp, dxp_p, atol=tol, rtol=0)
    torch.testing.assert_close(dgates, dgates_p, atol=tol, rtol=0)
    hp = gru._h_prev(args[4], reverse).reshape(d, T * B, h).double()
    for di in range(d):
        dxp_ref, _, dw_ref, db_ref = ref[di]
        _close(dxp[di].transpose(0, 1).numpy(), dxp_ref, bf16, "dxp")
        dw = hp[di].t() @ dgates[di].reshape(T * B, 3 * h).double()
        _close(dw.float().numpy(), dw_ref, bf16, "dW from dgates")
        _close(dgates[di].sum((0, 1)).numpy(), db_ref, bf16,
               "db from dgates")


def _strided(dtype, shape, offset: int = 0):
    """A tensor of ``shape`` over a few elements of storage (every
    stride 0), its data ``offset`` elements past a 16-byte boundary."""
    return torch.zeros(16, dtype=dtype).as_strided(
        shape, (0,) * len(shape), offset)


@pytest.mark.parametrize("dtype,h,mma", [
    (torch.bfloat16, 1760, True),   # ds2_full: 55 groups a direction
    (torch.bfloat16, 800, True),    # ds2_small's width, streamed
    (torch.bfloat16, 2176, True),   # 136 groups at D=2: more than SMs
    (torch.bfloat16, 100, False),   # 3H = 300: no 16-byte pieces
    (torch.float32, 1760, False),   # f32: the two-phase kernel
])
def test_k9_path_rule_and_scratch(dtype, h, mma):
    """``gru_bwd_stream`` picks its C path before the launch, as
    ``gru_bwd_stream_launch`` does: bf16 with H % 8 == 0 and w and ys
    16-byte aligned runs the pre-pass GEMM and the tensor-core loop; any
    other call the two-phase kernel. The scratch is ``8*D*B*H`` floats
    either way: the two-phase kernel's dh, its elementwise part and two
    rows of 3H in the dot dtype; the loop's elementwise part and, from
    float ``D*B*H`` (16-byte aligned), two bf16 rows, ``4*D*B*H`` in all:
    the layout of K5's and K7's ``gru_bwd_mma_scratch_floats``."""
    d, t, bsz = 2, 3, 5
    w = _strided(dtype, (d, h, 3 * h))
    ys = _strided(torch.float32, (d, t, bsz, h))
    assert gru._bwd_mma(w, ys) is mma
    if mma:  # a misaligned w or ys takes the two-phase kernel
        assert not gru._bwd_mma(_strided(dtype, (d, h, 3 * h), 1), ys)
        assert not gru._bwd_mma(
            w, _strided(torch.float32, (d, t, bsz, h), 1))
    floats = gru._bwd_stream_scratch_floats(d, bsz, h)
    assert floats == 8 * d * bsz * h
    two_phase = 4 * 2 * d * bsz * h + 2 * d * bsz * 3 * h * (
        2 if dtype == torch.bfloat16 else 4)
    rows_at = 4 * d * bsz * h
    loop = rows_at + 2 * (2 * d * bsz * 3 * h)
    assert loop == 4 * 4 * d * bsz * h
    assert two_phase <= 4 * floats and loop <= 4 * floats
    assert rows_at % 16 == 0 or h % 8 != 0


@pytest.mark.parametrize("variant", [n for n, subs in
                                     k9_variants.VARIANTS.items() if subs])
def test_k9_variants_match_the_source(variant):
    """Each variant that ``deepspeech_tpu_torch.k9_variants`` builds
    replaces a constant that ``csrc/gru_bwd_stream.cu`` holds exactly
    once, so the script times the loop it names."""
    with open(os.path.join(_build.CSRC_DIR, "gru_bwd_stream.cu")) as f:
        src = f.read()
    for old, new in k9_variants.VARIANTS[variant]:
        assert src.count(old) == 1
        assert new != old


# ---------------------------------------------------------------------------
# K8's tensor-core loop (csrc/gru_fwd_stream.cu, bf16 path): the path rule,
# the scratch, the loop's order of summation, and k8_variants.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,h,mma", [
    (torch.bfloat16, 1760, True),   # ds2_full: 55 groups a direction
    (torch.bfloat16, 104, True),    # a multiple of 8, not of 32
    (torch.bfloat16, 128, True),    # whole groups and chunks
    (torch.bfloat16, 100, False),   # not a multiple of 8
    (torch.float32, 1760, False),   # f32: the CUDA-core kernel
])
def test_k8_path_rule_and_scratch(dtype, h, mma):
    """``gru_fwd_stream`` picks its C path before the launch, as
    ``gru_fwd_stream_launch`` does: bf16 with H % 8 == 0 runs the
    transpose and the tensor-core loop, whose scratch holds two rounded
    h rows and W^T, both bf16; any other call the CUDA-core kernel,
    which takes no scratch."""
    d, t, bsz = 2, 3, 5
    xp = torch.zeros(t, bsz, 3 * h, dtype=dtype)
    w = torch.zeros(d, h, 3 * h, dtype=dtype)
    assert gru._fwd_mma(w) is mma
    scratch = gru._fwd_scratch(xp, w)
    assert scratch.dtype == torch.float32
    rows, wt = 2 * (2 * d * bsz * h), 2 * (d * 3 * h * h)
    assert scratch.numel() * 4 == (rows + wt if mma else 0)
    if mma:  # W^T starts 16-byte aligned after the rows
        assert rows % 16 == 0


def _k8_loop_gates(w, b):
    """The gates of csrc/gru_fwd_stream.cu's tensor-core loop in its
    order of summation: h rounded to W's dtype, the depth H cut into
    MKC-deep chunks, warp kw summing chunks kw, kw + NW_K, ... in turn,
    the warps' partial sums added in warp order, then the bias (b_n
    too, before r multiplies the n column in ``_fwd_plain_loop``). The
    constants are the source's own (the chunk depth and the warps those
    of csrc/gru_fwd_mma.cuh, whose loop the source instances)."""
    with open(os.path.join(_build.CSRC_DIR, "gru_fwd_stream.cu")) as f:
        text = f.read()
    with open(os.path.join(_build.CSRC_DIR, "gru_fwd_mma.cuh")) as f:
        head = f.read()
    mkc = k17_variants.built_value(head, "MKC")
    nw_k = (k17_variants.built_value(head, "M_WARPS")
            // k17_variants.built_value(text, "NW_N"))
    h = w.shape[1]
    w32 = w.float()
    chunks = [slice(c * mkc, min(h, (c + 1) * mkc))
              for c in range(-(-h // mkc))]

    def gates(di, hc):
        hr = hc.to(w.dtype).float()
        total = torch.zeros(hc.shape[0], 3 * h)
        for kw in range(nw_k):
            part = torch.zeros(hc.shape[0], 3 * h)
            for k in chunks[kw::nw_k]:
                part = part + hr[:, k] @ w32[di][k]
            total = total + part
        return total + b[di]
    return gates


@pytest.mark.parametrize("h", [48, 176])
def test_k8_loop_order_matches_plain_and_the_blocked_pallas_kernel(
        force_blocked, h):
    """The tensor-core loop's order of summation, mirrored in f32 at D=2,
    T=9, B=5 with ragged lengths: with an h0, within 1e-6 of
    ``gru_fwd_plain`` (ys and hfin); without, a direction at a time,
    within 1e-5 of the JAX blocked kernel (``_gru_kernel_blocked``, K8)
    in interpret mode. H=48 is one whole and one partial chunk, H=176
    six chunks over the four depth splits."""
    rng = np.random.default_rng(80 + h)
    t, bsz, d = 9, 5, 2
    xproj = rng.normal(size=(bsz, t, 3 * h)).astype(np.float32)
    ws = (rng.normal(size=(d, h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    bs = (rng.normal(size=(d, 3 * h)) * 0.1).astype(np.float32)
    h0 = (rng.normal(size=(d, bsz, h)) * 0.5).astype(np.float32)
    lens = np.array([t, t - 3, 2, t - 1, 5])
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    m = torch.from_numpy(mask).t().contiguous()
    w, b = torch.from_numpy(ws), torch.from_numpy(bs)
    reverse = (False, True)
    gates = _k8_loop_gates(w, b)
    for hh in (torch.from_numpy(h0), None):
        ys, hfin = gru._fwd_plain_loop(xp, m, hh, reverse, d, h, gates)
        ys_p, hfin_p = gru.gru_fwd_plain(xp, m, w, b, hh, reverse)
        torch.testing.assert_close(ys, ys_p, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(hfin, hfin_p, atol=1e-6, rtol=1e-6)
    for di, rev in enumerate(reverse):
        pal = gru_scan_pallas(jnp.asarray(xproj), jnp.asarray(mask),
                              jnp.asarray(ws[di]), jnp.asarray(bs[di]), rev,
                              True, None)
        np.testing.assert_allclose(ys[di].transpose(0, 1).numpy(),
                                   np.asarray(pal), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", [n for n, subs in
                                     k8_variants.VARIANTS.items() if subs])
def test_k8_variants_match_the_source(variant):
    """Each variant that ``deepspeech_tpu_torch.k8_variants`` builds
    replaces a constant that ``csrc/gru_fwd_stream.cu`` holds exactly
    once, so the script times the loop it names."""
    with open(os.path.join(_build.CSRC_DIR, "gru_fwd_stream.cu")) as f:
        src = f.read()
    for old, new in k8_variants.VARIANTS[variant]:
        assert src.count(old) == 1
        assert new != old
