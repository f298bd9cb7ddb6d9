"""CTC loss: the plain recursion, two hand-written Hopper kernels, and
the closed-form gradient.

The port's counterpart of two JAX modules:

- ``deepspeech_tpu/ops/ctc.py``, the plain CTC: ``transition_masks``,
  ``forward_alphas``, ``backward_betas``, ``scatter_ext_to_vocab``,
  ``ctc_loss_ref`` (the gradient by autograd through the plain loop:
  the test oracle) and ``ctc_grad`` (the closed form
  ``softmax - gamma``);
- ``deepspeech_tpu/ops/ctc_pallas.py``, the kernels. ``ctc_alpha``
  replaces ``_fwd_kernel`` (:118, K1) with ``tape=True`` and
  ``_fwd_kernel_loss_only`` (:124, K3) with ``tape=False``;
  ``ctc_beta`` replaces ``_bwd_kernel`` (:132, K2). Both are
  ``csrc/ctc.cu``.

``ctc_loss`` is what training calls: an autograd Function that runs the
alpha kernel with its tape and the beta kernel when a gradient is
needed, and forms ``dlogits`` there (as ``_ctc_pallas_fwd`` does), and
runs the alpha kernel alone when none is (the eval loss).

Conventions follow the JAX package: blank = 0; logits in, log-softmax
inside; per-utterance negative log-likelihood ``[B]``. The extended
label sequence is ``ext = [blank, l1, blank, ..., lL, blank]``, S = 2L+1;
alpha includes the emission at t, beta excludes it.

What bounds the kernels on the H100: at B=32, T'=850, S=513, K1 reads
the log-probs (3.2 MB) and writes the f32 alpha tape (55.8 MB), about
0.018 ms at 3.35 TB/s; K2 reads both and writes gamma, about 0.035 ms.
The T' steps are serial, so the time is T' times one step's latency.
Each kernel runs a cluster of C CTAs per utterance (``ctc_plan``), the
band cut into one segment a warp; a lane holds its state in a register
and takes its neighbours' by shuffles, and a warp recomputes a ghost
zone of its upstream neighbour's states so that segments trade edges
only every h steps (``csrc/ctc.cu`` says more), with the plain
version's bits. The log-softmax, the gather of ``ext`` and the fold of
gamma into vocab bins stay torch ops, as they stay XLA ops in the JAX
package. The fold
is a product with a one-hot ``[B, S, V]`` in full f32: no atomics, so
the gradient is the same bits on every run.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .precision import full_f32_matmul

NEG = -1e30  # log(0) without -inf NaN hazards
MAX_S = 1024  # the kernels' limit: S = 2L+1 <= 1024


# ---------------------------------------------------------------------------
# The plain CTC (deepspeech_tpu/ops/ctc.py).
# ---------------------------------------------------------------------------

def _shift_right(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[..., s] -> x[..., s-k]; ``fill`` where s < k."""
    s = x.shape[-1]
    pad = x.new_full(x.shape[:-1] + (min(k, s),), fill)
    return torch.cat([pad, x[..., :s - k]], -1) if k < s else pad


def _shift_left(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[..., s] -> x[..., s+k]; ``fill`` where s+k >= S."""
    s = x.shape[-1]
    pad = x.new_full(x.shape[:-1] + (min(k, s),), fill)
    return torch.cat([x[..., k:], pad], -1) if k < s else pad


def _extend_labels(labels: torch.Tensor) -> torch.Tensor:
    """[B, L] -> ext [B, 2L+1] with blanks interleaved (blank = 0)."""
    b, l = labels.shape
    ext = labels.new_zeros((b, 2 * l + 1))
    ext[:, 1::2] = labels
    return ext


def transition_masks(labels: torch.Tensor, label_lens: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ext, skip, valid)``, each ``[B, S]``: ``skip[s]`` is the
    s-2 -> s transition's legality (ext[s] is a label and differs from
    ext[s-2]); ``valid[s]`` is s < 2 * label_len + 1."""
    ext = _extend_labels(labels)
    s_idx = torch.arange(ext.shape[1], device=ext.device)
    skip = (ext != 0) & (ext != _shift_right(ext, 2, 0)) & (s_idx >= 2)
    valid = s_idx[None, :] < (2 * label_lens[:, None] + 1)
    return ext, skip, valid


def _gather_ext(log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """[B, T, V] log-probs -> [B, T, S] emissions of the extended labels."""
    b, t, _ = log_probs.shape
    return torch.gather(log_probs, 2,
                        ext.long()[:, None, :].expand(b, t, ext.shape[1]))


def _final_loglik(alpha: torch.Tensor, label_lens: torch.Tensor
                  ) -> torch.Tensor:
    s_last = (2 * label_lens).long()[:, None]
    a_last = alpha.gather(1, s_last)[:, 0]
    a_prev = torch.where(label_lens > 0,
                         alpha.gather(1, (s_last - 1).clamp(min=0))[:, 0],
                         torch.full_like(a_last, NEG))
    return torch.logaddexp(a_last, a_prev)


def forward_alphas(log_probs: torch.Tensor, labels: torch.Tensor,
                   input_lens: torch.Tensor, label_lens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All alphas ``[T, B, S]`` and the log-likelihood ``[B]``; frames
    at or past ``input_len`` carry alpha through unchanged."""
    t_max = log_probs.shape[1]
    ext, skip, valid = transition_masks(labels, label_lens)
    lp_ext = _gather_ext(log_probs, ext)
    neg = torch.full_like(lp_ext[:, 0], NEG)
    s_idx = torch.arange(ext.shape[1], device=ext.device)
    first = (s_idx == 0) | ((s_idx == 1) & (label_lens > 0)[:, None])
    alpha = torch.where(first & valid, lp_ext[:, 0], neg)
    alphas = [alpha]
    for t in range(1, t_max):
        step1 = _shift_right(alpha, 1, NEG)
        step2 = torch.where(skip, _shift_right(alpha, 2, NEG), neg)
        new = lp_ext[:, t] + torch.logaddexp(alpha,
                                             torch.logaddexp(step1, step2))
        new = torch.where(valid, new, neg)
        alpha = torch.where((t < input_lens)[:, None], new, alpha)
        alphas.append(alpha)
    return torch.stack(alphas, 0), _final_loglik(alpha, label_lens)


def backward_betas(log_probs: torch.Tensor, labels: torch.Tensor,
                   input_lens: torch.Tensor, label_lens: torch.Tensor
                   ) -> torch.Tensor:
    """beta ``[T, B, S]``, the emission at t excluded; restarts at the
    terminal states for t >= input_len - 1."""
    t_max = log_probs.shape[1]
    ext, skip, valid = transition_masks(labels, label_lens)
    lp_ext = _gather_ext(log_probs, ext)
    s_idx = torch.arange(ext.shape[1], device=ext.device)[None, :]
    s_last = 2 * label_lens[:, None]
    neg = torch.full_like(lp_ext[:, 0], NEG)
    terminal = torch.where(
        (s_idx == s_last) | ((s_idx == s_last - 1) & (s_last > 0)),
        torch.zeros_like(neg), neg)
    # skip describes s-2 -> s; from s the skip goes to s+2.
    skip_fwd = _shift_left(skip, 2, False)
    betas = [terminal] * t_max
    beta = terminal
    for t in range(t_max - 2, -1, -1):
        c = beta + lp_ext[:, t + 1]
        step2 = torch.where(skip_fwd, _shift_left(c, 2, NEG), neg)
        rec = torch.logaddexp(c, torch.logaddexp(_shift_left(c, 1, NEG),
                                                 step2))
        rec = torch.where(valid, rec, neg)
        beta = torch.where((t >= input_lens - 1)[:, None], terminal, rec)
        betas[t] = beta
    return torch.stack(betas, 0)


def scatter_ext_to_vocab(vals: torch.Tensor, ext: torch.Tensor,
                         vocab: int) -> torch.Tensor:
    """Sum extended-label values into vocab bins: vals ``[B, T, S]``,
    ext ``[B, S]`` -> ``[B, T, V]`` f32. A product with a one-hot
    ``[B, S, V]`` in full f32, so the sums run in a fixed order on the
    card (``scatter_add_`` would use atomics there)."""
    onehot = F.one_hot(ext.long(), vocab).float()
    with full_f32_matmul():
        return torch.bmm(vals.float(), onehot)


def ctc_loss_ref(logits: torch.Tensor, labels: torch.Tensor,
                 input_lens: torch.Tensor, label_lens: torch.Tensor
                 ) -> torch.Tensor:
    """Per-utterance loss ``[B]``; its gradient is autograd's through
    the plain loop (the test oracle)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    _, loglik = forward_alphas(log_probs, labels, input_lens, label_lens)
    return -loglik


@torch.no_grad()
def ctc_grad(logits: torch.Tensor, labels: torch.Tensor,
             input_lens: torch.Tensor, label_lens: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss [B], dloss/dlogits [B, T, V])`` from the explicit alpha
    and beta recursions: ``softmax - gamma``, zero past ``input_len``."""
    t_max, v = logits.shape[1], logits.shape[2]
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    alphas, loglik = forward_alphas(log_probs, labels, input_lens,
                                    label_lens)
    betas = backward_betas(log_probs, labels, input_lens, label_lens)
    ext = _extend_labels(labels)
    log_occ = alphas + betas - loglik[None, :, None]
    occ = torch.exp(torch.clamp(log_occ, max=0.0)).transpose(0, 1)
    gamma = scatter_ext_to_vocab(occ, ext, v)
    tmask = (torch.arange(t_max, device=logits.device)[None, :]
             < input_lens[:, None])
    grad = (torch.exp(log_probs) - gamma) * tmask[:, :, None]
    return -loglik, grad.to(logits.dtype)


# ---------------------------------------------------------------------------
# The kernels (deepspeech_tpu/ops/ctc_pallas.py) and their plain versions.
# ---------------------------------------------------------------------------

def _lse3(a, b, c):
    """log(e^a + e^b + e^c), NEG when all three are NEG: the kernel's
    arithmetic (``_logaddexp`` of ctc_pallas.py, three-way)."""
    m = torch.maximum(torch.maximum(a, b), c)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                        + torch.exp(c - m))
    return torch.where(m <= NEG / 2, torch.full_like(m, NEG), out)


def _check(log_probs, ext, skip, input_lens, s_last, alphas=None,
           loglik=None) -> None:
    if log_probs.dim() != 3 or log_probs.dtype != torch.float32:
        raise ValueError(f"log_probs must be f32 [B,T,V]; got "
                         f"{log_probs.dtype} {list(log_probs.shape)}")
    b, t, _ = log_probs.shape
    if ext.dim() != 2 or ext.shape[0] != b:
        raise ValueError(f"ext must be [B={b},S]; got {list(ext.shape)}")
    s = ext.shape[1]
    if s > MAX_S:
        raise ValueError(f"S={s} > {MAX_S}: the kernels' band limit")
    want = {"ext": (ext, torch.int32, (b, s)),
            "skip": (skip, torch.bool, (b, s)),
            "input_lens": (input_lens, torch.int32, (b,)),
            "s_last": (s_last, torch.int32, (b,))}
    if alphas is not None:
        want["alphas"] = (alphas, torch.float32, (b, t, s))
        want["loglik"] = (loglik, torch.float32, (b,))
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}; got "
                             f"{x.dtype} {list(x.shape)}")
    for name, x in [("log_probs", log_probs)] + [(k, v[0]) for k, v in
                                                  want.items()]:
        if x.device != log_probs.device:
            raise ValueError(f"{name} is on {x.device}, log_probs on "
                             f"{log_probs.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if log_probs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ctc kernels run on cpu or cuda, not "
                         f"{log_probs.device}")


def ctc_alpha_plain(log_probs, ext, skip, input_lens, s_last, tape: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version of ``ctc_alpha``: the same recursion as
    the kernel, as an eager loop over T with ``[B, S]`` tensors."""
    t_max = log_probs.shape[1]
    lp_ext = _gather_ext(log_probs, ext)
    s_idx = torch.arange(ext.shape[1], device=ext.device)[None, :]
    valid = s_idx <= s_last[:, None]
    neg = torch.full_like(lp_ext[:, 0], NEG)
    first = (s_idx == 0) | ((s_idx == 1) & (s_last[:, None] > 0))
    alpha = torch.where(first & valid, lp_ext[:, 0], neg)
    alphas = [alpha]
    for t in range(1, t_max):
        step1 = _shift_right(alpha, 1, NEG)
        step2 = torch.where(skip, _shift_right(alpha, 2, NEG), neg)
        new = torch.where(valid, lp_ext[:, t] + _lse3(alpha, step1, step2),
                          neg)
        alpha = torch.where((t < input_lens)[:, None], new, alpha)
        if tape:
            alphas.append(alpha)
    sl = s_last.long()[:, None]
    a_prev = torch.where(sl > 0, alpha.gather(1, (sl - 1).clamp(min=0)),
                         neg[:, :1])
    loglik = _lse3(alpha.gather(1, sl), a_prev, neg[:, :1])[:, 0]
    return loglik, (torch.stack(alphas, 1) if tape else None)


def ctc_beta_plain(log_probs, ext, skip, input_lens, s_last, alphas,
                   loglik) -> torch.Tensor:
    """The plain PyTorch version of ``ctc_beta``."""
    t_max = log_probs.shape[1]
    lp_ext = _gather_ext(log_probs, ext)
    s_idx = torch.arange(ext.shape[1], device=ext.device)[None, :]
    sl = s_last[:, None]
    valid = s_idx <= sl
    neg = torch.full_like(lp_ext[:, 0], NEG)
    terminal = torch.where((s_idx == sl) | ((s_idx == sl - 1) & (sl > 0)),
                           torch.zeros_like(neg), neg)
    skip_fwd = _shift_left(skip, 2, False)
    gamma = torch.empty_like(lp_ext)
    beta = terminal
    for t in range(t_max - 1, -1, -1):
        if t < t_max - 1:
            c = beta + lp_ext[:, t + 1]
            step2 = torch.where(skip_fwd, _shift_left(c, 2, NEG), neg)
            rec = torch.where(valid, _lse3(c, _shift_left(c, 1, NEG), step2),
                              neg)
            beta = torch.where((t >= input_lens - 1)[:, None], terminal, rec)
        occ = torch.exp(torch.clamp(alphas[:, t] + beta - loglik[:, None],
                                    max=0.0))
        keep = valid & (t < input_lens)[:, None]
        gamma[:, t] = torch.where(keep, occ, torch.zeros_like(occ))
    return gamma


def _lib() -> ctypes.CDLL:
    lib = _build.load("ctc")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ctc_alpha_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.ctc_alpha_launch.restype = i
    lib.ctc_beta_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.ctc_beta_launch.restype = i
    lib.ctc_error_string.argtypes = [i]
    lib.ctc_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.ctc_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} "
                           f"[cudaError {rc}]")


PLAN_KEYS = ("C", "W", "own", "h", "KS", "PREFETCH", "STRIDED")


def ctc_plan(b: int, s: int, device: torch.device) -> dict:
    """The plan both kernels launch with at ``B=b``, ``S=s`` on a CUDA
    ``device``: ``C`` CTAs a cluster, ``W`` warps a CTA, ``own`` states
    a segment, ``h`` steps between exchanges, and the source's ``KS``
    states a lane, ``PREFETCH`` steps of loads ahead and ``STRIDED``
    layout (``ctc_variants.plan`` mirrors it)."""
    lib = _lib()
    lib.ctc_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.ctc_plan.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _raise_on(lib, lib.ctc_plan(b, s, index, out), f"ctc_plan (B={b}, S={s})")
    return dict(zip(PLAN_KEYS, out))


def ctc_alpha(log_probs: torch.Tensor, ext: torch.Tensor,
              skip: torch.Tensor, input_lens: torch.Tensor,
              s_last: torch.Tensor, tape: bool
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The CTC alpha recursion.

    ``log_probs [B,T,V]`` f32 (log-softmax of the logits), ``ext [B,S]``
    int32 extended labels, ``skip [B,S]`` bool (the s-2 -> s move is
    legal; false at the blank states, even s, as ``transition_masks``
    makes it), ``input_lens [B]`` int32 frames, ``s_last [B]`` int32
    (= 2 * label_len; states past it are invalid). Returns
    ``(loglik [B] f32, alphas [B,T,S] f32 or None)``: the tape when
    ``tape`` (K1), none otherwise (K3). Frames at or past ``input_len``
    hold alpha.

    A CPU tensor runs ``ctc_alpha_plain``; a CUDA tensor launches
    ``csrc/ctc.cu`` or raises. ``ctc_alpha.launches`` counts every
    launch, ``ctc_alpha.loss_only_launches`` those without a tape.
    """
    _check(log_probs, ext, skip, input_lens, s_last)
    if log_probs.device.type == "cpu":
        return ctc_alpha_plain(log_probs, ext, skip, input_lens, s_last,
                               tape)
    b, t, v = log_probs.shape
    s = ext.shape[1]
    if b == 0 or t == 0:
        raise ValueError("ctc_alpha needs B >= 1 and T >= 1")
    loglik = torch.empty((b,), dtype=torch.float32, device=log_probs.device)
    alphas = (torch.empty((b, t, s), dtype=torch.float32,
                          device=log_probs.device) if tape else None)
    lib = _lib()
    rc = lib.ctc_alpha_launch(
        log_probs.data_ptr(), ext.data_ptr(), skip.data_ptr(),
        input_lens.data_ptr(), s_last.data_ptr(),
        alphas.data_ptr() if tape else None, loglik.data_ptr(), b, t, v, s,
        log_probs.device.index,
        torch.cuda.current_stream(log_probs.device).cuda_stream)
    _raise_on(lib, rc, f"ctc_alpha (B={b}, T={t}, V={v}, S={s})")
    ctc_alpha.launches += 1
    ctc_alpha.loss_only_launches += not tape
    return loglik, alphas


ctc_alpha.launches = 0
ctc_alpha.loss_only_launches = 0


def ctc_beta(log_probs: torch.Tensor, ext: torch.Tensor, skip: torch.Tensor,
             input_lens: torch.Tensor, s_last: torch.Tensor,
             alphas: torch.Tensor, loglik: torch.Tensor) -> torch.Tensor:
    """The CTC beta recursion and the state occupancy.

    Inputs as ``ctc_alpha``'s, plus its tape ``alphas [B,T,S]`` and
    ``loglik [B]``. Beta restarts at the terminal states for
    t >= input_len - 1; a skip s -> s+2 is legal when ``skip[s+2]``
    (judged at the destination). Returns ``gamma [B,T,S]`` f32,
    ``exp(min(alpha + beta - loglik, 0))``, zero at invalid states and
    frames past ``input_len``.

    A CPU tensor runs ``ctc_beta_plain``; a CUDA tensor launches
    ``csrc/ctc.cu`` (counted in ``ctc_beta.launches``) or raises.
    """
    _check(log_probs, ext, skip, input_lens, s_last, alphas, loglik)
    if log_probs.device.type == "cpu":
        return ctc_beta_plain(log_probs, ext, skip, input_lens, s_last,
                              alphas, loglik)
    b, t, v = log_probs.shape
    s = ext.shape[1]
    if b == 0 or t == 0:
        raise ValueError("ctc_beta needs B >= 1 and T >= 1")
    gamma = torch.empty((b, t, s), dtype=torch.float32,
                        device=log_probs.device)
    lib = _lib()
    rc = lib.ctc_beta_launch(
        log_probs.data_ptr(), ext.data_ptr(), skip.data_ptr(),
        input_lens.data_ptr(), s_last.data_ptr(), alphas.data_ptr(),
        loglik.data_ptr(), gamma.data_ptr(), b, t, v, s,
        log_probs.device.index,
        torch.cuda.current_stream(log_probs.device).cuda_stream)
    _raise_on(lib, rc, f"ctc_beta (B={b}, T={t}, V={v}, S={s})")
    ctc_beta.launches += 1
    return gamma


ctc_beta.launches = 0


# ---------------------------------------------------------------------------
# The loss the train step calls.
# ---------------------------------------------------------------------------

def prepare(logits: torch.Tensor, labels: torch.Tensor,
            input_lens: torch.Tensor, label_lens: torch.Tensor):
    """Log-softmax and the kernels' operands:
    ``(log_probs, ext, skip, input_lens, s_last)``. Raises on labels
    outside ``[0, V)``, label lengths outside ``[0, L]`` or frame
    counts outside ``[0, T]`` (one host sync): the kernels would read
    out of bounds."""
    b, t, v = logits.shape
    lab_lens = label_lens.long()
    bad = torch.stack([((labels < 0) | (labels >= v)).any(),
                       ((lab_lens < 0) | (lab_lens > labels.shape[1])).any(),
                       ((input_lens < 0) | (input_lens > t)).any()])
    if bool(bad.any()):
        raise ValueError(f"ctc_loss: labels must lie in [0, {v}), "
                         f"label_lens in [0, {labels.shape[1]}] and "
                         f"input_lens in [0, {t}]")
    log_probs = torch.log_softmax(logits.float(), dim=-1).contiguous()
    ext, skip, _ = transition_masks(labels.long(), lab_lens)
    return (log_probs, ext.int().contiguous(), skip.contiguous(),
            input_lens.int().contiguous(), (2 * lab_lens).int().contiguous())


class _CTCLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, input_lens, label_lens):
        log_probs, ext, skip, lens, s_last = prepare(logits, labels,
                                                     input_lens, label_lens)
        if not ctx.needs_input_grad[0]:
            loglik, _ = ctc_alpha(log_probs, ext, skip, lens, s_last,
                                  tape=False)
            return -loglik
        loglik, alphas = ctc_alpha(log_probs, ext, skip, lens, s_last,
                                   tape=True)
        gamma_ext = ctc_beta(log_probs, ext, skip, lens, s_last, alphas,
                             loglik)
        del alphas
        gamma = scatter_ext_to_vocab(gamma_ext, ext, logits.shape[2])
        tmask = (torch.arange(logits.shape[1], device=logits.device)[None]
                 < lens[:, None])
        dlogits = torch.exp(log_probs) * tmask[:, :, None] - gamma
        ctx.save_for_backward(dlogits.to(logits.dtype))
        return -loglik

    @staticmethod
    def backward(ctx, g):
        (dlogits,) = ctx.saved_tensors
        return dlogits * g.to(dlogits.dtype)[:, None, None], None, None, None


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             input_lens: torch.Tensor, label_lens: torch.Tensor
             ) -> torch.Tensor:
    """Per-utterance CTC loss ``[B]`` through the kernels (the contract
    of ``ctc_loss_pallas``): logits ``[B, T, V]``, labels ``[B, L]``
    (blank-padded), ``input_lens [B]`` frames, ``label_lens [B]``."""
    return _CTCLoss.apply(logits, labels, input_lens, label_lens)


def ctc_loss_mean(logits, labels, input_lens, label_lens) -> torch.Tensor:
    """Batch-mean CTC loss, what the train step optimises."""
    return ctc_loss(logits, labels, input_lens, label_lens).mean()
