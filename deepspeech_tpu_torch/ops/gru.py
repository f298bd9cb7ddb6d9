"""The GRU recurrence and its backward: hand-written Hopper kernels and
their plain PyTorch versions.

``gru_fwd`` replaces two TPU kernels of ``deepspeech_tpu/ops/rnn_pallas.py``:
``_gru_kernel`` (:85, one direction, with the carried ``h0`` in and the
final carry out of ``gru_scan_pallas_stream``) at D=1, and
``_bigru_kernel`` (:155, both directions of a bidirectional layer in one
launch) at D=2. The kernel is ``csrc/gru_fwd.cu``.

``gru_bwd`` replaces their backward kernels: ``_gru_bwd_kernel`` (:113,
K7) at D=1 and ``_bigru_bwd_kernel`` (:211, K5) at D=2, the BPTT with
the gates recomputed from the stored outputs. The kernel is
``csrc/gru_bwd.cu``. ``GRUFunction`` wraps the pair for autograd and
forms dW and db outside the kernel by one f32 product, as
``_gru_bwd``/``_bigru_bwd`` do with one einsum.

What bounds them on the H100: each step's ``[B,H] x [H,3H]`` product
needs the step before, so the T steps are serial and the time is T
times one step's latency, far above the FLOP roofline (2*T*D*B*H*3H
per product over 989 TFLOP/s in bf16) and the byte roofline (the
inputs and outputs once over 3.35 TB/s). The kernels therefore keep W
out of device memory for the whole sequence: one cooperative launch per
layer, D x ceil(H/16) blocks each holding a ``[H, 48]`` column slice of
W in shared memory, a grid-wide barrier between steps. See the sources
for the layouts.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .precision import full_f32_matmul

_DTYPES = (torch.bfloat16, torch.float32)


def _check(xp, mask, w, b, h0, reverse) -> None:
    if xp.dim() != 3 or w.dim() != 3:
        raise ValueError(f"xp must be [T,B,3H] and w [D,H,3H]; got "
                         f"{tuple(xp.shape)} and {tuple(w.shape)}")
    t, bsz, h3 = xp.shape
    d, h = w.shape[0], w.shape[1]
    if h3 != 3 * h or w.shape[2] != 3 * h:
        raise ValueError(f"xp [T,B,{h3}] and w {tuple(w.shape)} disagree "
                         f"on 3H")
    if len(reverse) != d:
        raise ValueError(f"reverse has {len(reverse)} flags for D={d}")
    if xp.dtype not in _DTYPES or w.dtype != xp.dtype:
        raise ValueError(f"xp and w must share one dtype, bf16 or f32; got "
                         f"{xp.dtype}, {w.dtype}")
    want = {"mask": (mask, (t, bsz)), "b": (b, (d, 3 * h))}
    if h0 is not None:
        want["h0"] = (h0, (d, bsz, h))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {list(shape)}; got "
                             f"{x.dtype} {list(x.shape)}")
    for name, x in (("xp", xp), ("mask", mask), ("w", w), ("b", b),
                    ("h0", h0)):
        if x is None:
            continue
        if x.device != xp.device:
            raise ValueError(f"{name} is on {x.device}, xp on {xp.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gru_fwd_plain(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, h0: Optional[torch.Tensor] = None,
                  reverse: Sequence[bool] = (False,)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``gru_fwd``: an eager time loop with
    the same arithmetic (h_prev rounded to ``w.dtype`` for the product,
    the product and the carry in f32)."""
    t, bsz, _ = xp.shape
    d, h = w.shape[0], w.shape[1]
    ys = torch.empty((d, t, bsz, h), dtype=torch.float32, device=xp.device)
    hfin = torch.empty((d, bsz, h), dtype=torch.float32, device=xp.device)
    for di in range(d):
        w32 = w[di].float()
        hc = (torch.zeros((bsz, h), dtype=torch.float32, device=xp.device)
              if h0 is None else h0[di].float())
        for s in range(t):
            row = t - 1 - s if reverse[di] else s
            gates = hc.to(w.dtype).float() @ w32 + b[di]
            x = xp[row].float()
            r = torch.sigmoid(x[:, :h] + gates[:, :h])
            z = torch.sigmoid(x[:, h:2 * h] + gates[:, h:2 * h])
            n = torch.tanh(x[:, 2 * h:] + r * gates[:, 2 * h:])
            hnew = (1.0 - z) * n + z * hc
            m = mask[row][:, None]
            hc = m * hnew + (1.0 - m) * hc
            ys[di, row] = hc
        hfin[di] = hc
    return ys, hfin


def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_fwd_launch.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                   p]
    lib.gru_fwd_launch.restype = i
    lib.gru_fwd_error_string.argtypes = [i]
    lib.gru_fwd_error_string.restype = ctypes.c_char_p
    return lib


def gru_fwd(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor, h0: Optional[torch.Tensor] = None,
            reverse: Sequence[bool] = (False,)
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU forward over D directions that share one input projection.

    ``xp [T,B,3H]`` (includes the input bias) and ``w [D,H,3H]`` in one
    dtype, bf16|f32, the dot dtype; ``mask [T,B]`` f32 (1 = valid),
    ``b [D,3H]`` f32 recurrent bias, ``h0 [D,B,H]`` f32 or None (zeros),
    ``reverse[d]`` True for a direction that runs t = T-1..0.
    Returns ``ys [D,T,B,H]`` f32 (a masked frame holds the previous h)
    and ``hfin [D,B,H]`` f32, the carry after the last step.

    Gates r, z, n: ``n = tanh(xp_n + r * (h W_n + b_n))``,
    ``h' = (1-z) n + z h``. The product rounds h_prev to ``w.dtype`` and
    sums in f32; the carry and outputs stay f32.

    A CPU tensor runs ``gru_fwd_plain``; a CUDA tensor launches
    ``csrc/gru_fwd.cu`` (one launch, counted in ``gru_fwd.launches``)
    or raises.
    """
    reverse = tuple(bool(r) for r in reverse)
    _check(xp, mask, w, b, h0, reverse)
    if xp.device.type == "cpu":
        return gru_fwd_plain(xp, mask, w, b, h0, reverse)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_fwd runs on cpu or cuda, not {xp.device}")
    t, bsz, _ = xp.shape
    d, h = w.shape[0], w.shape[1]
    ys = torch.empty((d, t, bsz, h), dtype=torch.float32, device=xp.device)
    hfin = torch.empty((d, bsz, h), dtype=torch.float32, device=xp.device)
    if t == 0 or bsz == 0:
        hfin.copy_(h0 if h0 is not None else torch.zeros_like(hfin))
        return ys, hfin
    lib = _lib()
    rc = lib.gru_fwd_launch(
        int(w.dtype == torch.bfloat16), xp.data_ptr(), mask.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if h0 is None else h0.data_ptr(), ys.data_ptr(),
        hfin.data_ptr(), d, t, bsz, h,
        sum(1 << i for i, r in enumerate(reverse) if r), xp.device.index,
        torch.cuda.current_stream(xp.device).cuda_stream)
    if rc != 0:
        msg = lib.gru_fwd_error_string(rc).decode()
        raise RuntimeError(
            f"gru_fwd kernel launch failed (D={d}, T={t}, B={bsz}, H={h}, "
            f"w {w.dtype}): {msg} [cudaError {rc}]")
    gru_fwd.launches += 1
    return ys, hfin


gru_fwd.launches = 0


def gru_bwd_plain(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, ys: torch.Tensor, dy: torch.Tensor,
                  reverse: Sequence[bool] = (False,)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``gru_bwd``: an eager reverse time
    loop with ``_gru_bwd_elt``'s per-step math (rnn_pallas.py:189)."""
    t, bsz, _ = xp.shape
    d, h = w.shape[0], w.shape[1]
    dxp = torch.empty((d, t, bsz, 3 * h), dtype=torch.float32,
                      device=xp.device)
    dgates = torch.empty_like(dxp)
    for di in range(d):
        w32 = w[di].float()
        dh = torch.zeros((bsz, h), dtype=torch.float32, device=xp.device)
        for i in range(t):
            row = i if reverse[di] else t - 1 - i
            if i == t - 1:  # the forward's first step
                h_prev = torch.zeros_like(dh)
            else:
                h_prev = ys[di, row + 1 if reverse[di] else row - 1]
            gates = h_prev.to(w.dtype).float() @ w32 + b[di]
            x = xp[row].float()
            g_n = gates[:, 2 * h:]
            r = torch.sigmoid(x[:, :h] + gates[:, :h])
            z = torch.sigmoid(x[:, h:2 * h] + gates[:, h:2 * h])
            n = torch.tanh(x[:, 2 * h:] + r * g_n)
            m = mask[row][:, None]
            dhc = dh + dy[di, row]
            dh_mid = m * dhc
            dn = dh_mid * (1.0 - z)
            dz = dh_mid * (h_prev - n)
            da_n = dn * (1.0 - n * n)
            dr = da_n * g_n
            dg_n = da_n * r
            da_z = dz * z * (1.0 - z)
            da_r = dr * r * (1.0 - r)
            dxp[di, row] = torch.cat([da_r, da_z, da_n], 1)
            dg = torch.cat([da_r, da_z, dg_n], 1)
            dgates[di, row] = dg
            dh = (dh_mid * z + (1.0 - m) * dhc
                  + dg.to(w.dtype).float() @ w32.t())
    return dxp, dgates


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("gru_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_bwd_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                   i, i, p]
    lib.gru_bwd_launch.restype = i
    lib.gru_bwd_scratch_floats.argtypes = [i, i, i]
    lib.gru_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.gru_bwd_error_string.argtypes = [i]
    lib.gru_bwd_error_string.restype = ctypes.c_char_p
    return lib


def gru_bwd(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor, ys: torch.Tensor, dy: torch.Tensor,
            reverse: Sequence[bool] = (False,)
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU backpropagation through time over D directions, from h0 = 0.

    ``xp``, ``mask``, ``w``, ``b`` and ``reverse`` as ``gru_fwd`` took
    them; ``ys [D,T,B,H]`` f32, the outputs ``gru_fwd`` returned;
    ``dy [D,T,B,H]`` f32, the gradient of the loss with respect to them.
    Each direction runs against its forward order, carrying dh; a step
    recomputes the gates from h_prev rounded to ``w.dtype`` and adds
    ``round(dgates) @ W^T`` to dh in f32. Returns ``(dxp, dgates)``,
    each ``[D,T,B,3H]`` f32: ``dxp`` the gradient of the input
    projection ``(da_r, da_z, da_n)``, ``dgates`` that of the recurrent
    gates ``h W + b``, ``(da_r, da_z, dg_n)``.

    A CPU tensor runs ``gru_bwd_plain``; a CUDA tensor launches
    ``csrc/gru_bwd.cu`` (one launch, counted in ``gru_bwd.launches``)
    or raises.
    """
    reverse = tuple(bool(r) for r in reverse)
    _check(xp, mask, w, b, None, reverse)
    d, t, bsz, h = w.shape[0], xp.shape[0], xp.shape[1], w.shape[1]
    for name, x in (("ys", ys), ("dy", dy)):
        if (tuple(x.shape) != (d, t, bsz, h) or x.dtype != torch.float32
                or x.device != xp.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 "
                             f"{[d, t, bsz, h]} on {xp.device}; got "
                             f"{x.dtype} {list(x.shape)} on {x.device}")
    if xp.device.type == "cpu":
        return gru_bwd_plain(xp, mask, w, b, ys, dy, reverse)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_bwd runs on cpu or cuda, not {xp.device}")
    dxp = torch.empty((d, t, bsz, 3 * h), dtype=torch.float32,
                      device=xp.device)
    dgates = torch.empty_like(dxp)
    if t == 0 or bsz == 0:
        return dxp, dgates
    lib = _bwd_lib()
    partial = torch.empty((lib.gru_bwd_scratch_floats(d, bsz, h),),
                          dtype=torch.float32, device=xp.device)
    rc = lib.gru_bwd_launch(
        int(w.dtype == torch.bfloat16), xp.data_ptr(), mask.data_ptr(),
        w.data_ptr(), b.data_ptr(), ys.data_ptr(), dy.data_ptr(),
        dxp.data_ptr(), dgates.data_ptr(), partial.data_ptr(), d, t, bsz, h,
        sum(1 << i for i, r in enumerate(reverse) if r), xp.device.index,
        torch.cuda.current_stream(xp.device).cuda_stream)
    if rc != 0:
        msg = lib.gru_bwd_error_string(rc).decode()
        raise RuntimeError(
            f"gru_bwd kernel launch failed (D={d}, T={t}, B={bsz}, H={h}, "
            f"w {w.dtype}): {msg} [cudaError {rc}]")
    gru_bwd.launches += 1
    return dxp, dgates


gru_bwd.launches = 0


def _h_prev(ys: torch.Tensor, reverse: Tuple[bool, ...]) -> torch.Tensor:
    """``[D,T,B,H]`` h_prev of every row in data order: ys shifted one
    step against each direction's scan, 0 at the scan's first row."""
    zero = torch.zeros_like(ys[0, :1])
    return torch.stack([
        torch.cat([ys[di, 1:], zero]) if rev else torch.cat([zero, ys[di, :-1]])
        for di, rev in enumerate(reverse)])


class GRUFunction(torch.autograd.Function):
    """``gru_fwd`` with ``gru_bwd`` as its backward.

    ``apply(xp [T,B,3H], mask [T,B], w [D,H,3H] f32, b [D,3H] f32, h0,
    reverse)`` -> ``ys [D,T,B,H]`` f32. ``w`` is rounded to ``xp.dtype``
    (the dot dtype) inside, so its gradient stays f32, as the JAX
    kernels cast the f32 weights inside. The backward returns ``dxp``
    summed over directions (``xp.dtype``), ``dW = sum_t h_prev^T dgates``
    as one f32 product with TF32 off, and ``db = sum dgates``. ``h0``
    may be given only when no input requires a gradient: the BPTT, like
    the JAX VJP, starts from h0 = 0 and returns no dh0.
    """

    @staticmethod
    def forward(ctx, xp, mask, w, b, h0, reverse):
        if h0 is not None and any(ctx.needs_input_grad):
            raise NotImplementedError(
                "GRUFunction: no gradient through a carried h0; the BPTT "
                "starts from h0 = 0, as the JAX VJP does")
        reverse = tuple(bool(r) for r in reverse)
        wd = w.to(xp.dtype).contiguous()
        ys, _ = gru_fwd(xp, mask, wd, b, h0, reverse)
        ctx.save_for_backward(xp, mask, wd, b, ys)
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dys):
        xp, mask, wd, b, ys = ctx.saved_tensors
        dxp, dgates = gru_bwd(xp, mask, wd, b, ys,
                              dys.float().contiguous(), ctx.reverse)
        d, t, bsz, h = ys.shape
        hp = _h_prev(ys, ctx.reverse).reshape(d, t * bsz, h)
        with full_f32_matmul():
            dw = torch.bmm(hp.transpose(1, 2),
                           dgates.reshape(d, t * bsz, 3 * h))
        db = dgates.sum((1, 2))
        return dxp.sum(0).to(xp.dtype), None, dw, db, None, None
