"""The GRU forward recurrence: a hand-written Hopper kernel and its plain
PyTorch version.

``gru_fwd`` replaces two TPU kernels of ``deepspeech_tpu/ops/rnn_pallas.py``:
``_gru_kernel`` (:85, one direction, with the carried ``h0`` in and the
final carry out of ``gru_scan_pallas_stream``) at D=1, and
``_bigru_kernel`` (:155, both directions of a bidirectional layer in one
launch) at D=2. The kernel is ``csrc/gru_fwd.cu``.

What bounds it on the H100: each step's ``[B,H] x [H,3H]`` product
needs the step before, so the T steps are serial and the time is T
times one step's latency, far above the FLOP roofline (2*T*D*B*H*3H
over 989 TFLOP/s in bf16) and the byte roofline (xp, W and ys once
over 3.35 TB/s). The kernel therefore keeps W out of device memory for
the whole sequence: one cooperative launch per layer, D x ceil(H/16)
blocks each holding a ``[H, 48]`` column slice of W in shared memory,
a grid-wide barrier between steps, and h_prev read back from L2. See
the source for the layout.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build

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
