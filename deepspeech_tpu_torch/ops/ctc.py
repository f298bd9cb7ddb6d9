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
``sp_ctc_loss`` is the sequence-parallel loss's (JAX ``seqpar.py``
``_ctc_alpha_relay``): the same over logits cut along time into shards,
each on its device; the kernels run a shard's chunk of the recursion and
carry the ``[B, S]`` band across shards (``ctc_alpha``'s ``alpha0``,
``ctc_beta``'s ``c_in``/``c_out``), with the unchunked call's bits.

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

from . import _build, gru
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
           loglik=None, **bands) -> None:
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
    for name, x in bands.items():
        if x is not None:
            want[name] = (x, torch.float32, (b, s))
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


def _check_offset(t_off: int, no_band: bool = False) -> None:
    """A chunk's offset: >= 0, and for alpha past frame 0 only with the
    band the chunk before handed over (``no_band``: none was given; the
    recursion starts at frame 0)."""
    if t_off < 0 or (t_off > 0 and no_band):
        raise ValueError(f"t_off={t_off}: must be >= 0, and an alpha chunk "
                         "past frame 0 needs the carried alpha0")


def ctc_alpha_plain(log_probs, ext, skip, input_lens, s_last, tape: bool,
                    alpha0: Optional[torch.Tensor] = None, t_off: int = 0
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version of ``ctc_alpha``: the same recursion as
    the kernel, as an eager loop over T with ``[B, S]`` tensors."""
    _check_offset(t_off, alpha0 is None)
    t_max = log_probs.shape[1]
    lp_ext = _gather_ext(log_probs, ext)
    s_idx = torch.arange(ext.shape[1], device=ext.device)[None, :]
    valid = s_idx <= s_last[:, None]
    neg = torch.full_like(lp_ext[:, 0], NEG)
    if alpha0 is None:
        first = (s_idx == 0) | ((s_idx == 1) & (s_last[:, None] > 0))
        alpha = torch.where(first & valid, lp_ext[:, 0], neg)
        alphas, start = [alpha], 1
    else:
        alpha = torch.where(valid, alpha0, neg)
        alphas, start = [], 0
    for t in range(start, t_max):
        step1 = _shift_right(alpha, 1, NEG)
        step2 = torch.where(skip, _shift_right(alpha, 2, NEG), neg)
        new = torch.where(valid, lp_ext[:, t] + _lse3(alpha, step1, step2),
                          neg)
        alpha = torch.where((t_off + t < input_lens)[:, None], new, alpha)
        if tape:
            alphas.append(alpha)
    sl = s_last.long()[:, None]
    a_prev = torch.where(sl > 0, alpha.gather(1, (sl - 1).clamp(min=0)),
                         neg[:, :1])
    loglik = _lse3(alpha.gather(1, sl), a_prev, neg[:, :1])[:, 0]
    return loglik, (torch.stack(alphas, 1) if tape else None)


def ctc_beta_plain(log_probs, ext, skip, input_lens, s_last, alphas,
                   loglik, c_in: Optional[torch.Tensor] = None,
                   t_off: int = 0, return_carry: bool = False):
    """The plain PyTorch version of ``ctc_beta``."""
    _check_offset(t_off)
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
    lens = input_lens - t_off  # the rows' lengths in local frames
    # c = beta + lp at the frame after the chunk's last: none, or c_in.
    c = None if c_in is None else torch.where(valid, c_in, neg)
    beta = terminal
    for t in range(t_max - 1, -1, -1):
        if c is not None:
            step2 = torch.where(skip_fwd, _shift_left(c, 2, NEG), neg)
            rec = torch.where(valid, _lse3(c, _shift_left(c, 1, NEG), step2),
                              neg)
            beta = torch.where((t >= lens - 1)[:, None], terminal, rec)
        occ = torch.exp(torch.clamp(alphas[:, t] + beta - loglik[:, None],
                                    max=0.0))
        keep = valid & (t < lens)[:, None]
        gamma[:, t] = torch.where(keep, occ, torch.zeros_like(occ))
        c = torch.where(valid, beta + lp_ext[:, t], neg)
    if not return_carry:
        return gamma
    # c at frame 0 for the chunk before; NEG where the row ended earlier.
    return gamma, torch.where((lens > 0)[:, None], c, neg)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ctc")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ctc_alpha_launch.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.ctc_alpha_launch.restype = i
    lib.ctc_beta_launch.argtypes = [p] * 10 + [i] * 6 + [p]
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
              s_last: torch.Tensor, tape: bool,
              alpha0: Optional[torch.Tensor] = None, t_off: int = 0
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

    A chunk of a longer recursion (``sp_ctc_loss``) passes its frames'
    log-probs, the global ``input_lens``, its first frame's global index
    ``t_off`` and ``alpha0 [B,S]`` f32, the band after the chunk before:
    local frame 0 is then a step from it. The band after this chunk is
    the tape's last row (``alphas[:, -1]``), and ``loglik`` is the
    recursion's only from its last chunk. ``alpha0=None`` with
    ``t_off=0`` is the unchunked recursion; the chunks give its bits.

    A CPU tensor runs ``ctc_alpha_plain``; a CUDA tensor launches
    ``csrc/ctc.cu`` or raises. ``ctc_alpha.launches`` counts every
    launch, ``ctc_alpha.loss_only_launches`` those without a tape.
    """
    _check(log_probs, ext, skip, input_lens, s_last, alpha0=alpha0)
    _check_offset(t_off, alpha0 is None)
    if log_probs.device.type == "cpu":
        return ctc_alpha_plain(log_probs, ext, skip, input_lens, s_last,
                               tape, alpha0, t_off)
    b, t, v = log_probs.shape
    s = ext.shape[1]
    if b == 0 or t == 0:
        raise ValueError("ctc_alpha needs B >= 1 and T >= 1")
    loglik = torch.empty((b,), dtype=torch.float32, device=log_probs.device)
    alphas = (torch.empty((b, t, s), dtype=torch.float32,
                          device=log_probs.device) if tape else None)
    gru.require_current(log_probs, "ctc_alpha")
    lib = _lib()
    rc = lib.ctc_alpha_launch(
        log_probs.data_ptr(), ext.data_ptr(), skip.data_ptr(),
        input_lens.data_ptr(), s_last.data_ptr(),
        None if alpha0 is None else alpha0.data_ptr(),
        alphas.data_ptr() if tape else None, loglik.data_ptr(), b, t, v, s,
        t_off, log_probs.device.index,
        torch.cuda.current_stream(log_probs.device).cuda_stream)
    _raise_on(lib, rc, f"ctc_alpha (B={b}, T={t}, V={v}, S={s})")
    ctc_alpha.launches += 1
    ctc_alpha.loss_only_launches += not tape
    return loglik, alphas


ctc_alpha.launches = 0
ctc_alpha.loss_only_launches = 0


def ctc_beta(log_probs: torch.Tensor, ext: torch.Tensor, skip: torch.Tensor,
             input_lens: torch.Tensor, s_last: torch.Tensor,
             alphas: torch.Tensor, loglik: torch.Tensor,
             c_in: Optional[torch.Tensor] = None, t_off: int = 0,
             return_carry: bool = False):
    """The CTC beta recursion and the state occupancy.

    Inputs as ``ctc_alpha``'s, plus its tape ``alphas [B,T,S]`` and
    ``loglik [B]``. Beta restarts at the terminal states for
    t >= input_len - 1; a skip s -> s+2 is legal when ``skip[s+2]``
    (judged at the destination). Returns ``gamma [B,T,S]`` f32,
    ``exp(min(alpha + beta - loglik, 0))``, zero at invalid states and
    frames past ``input_len``.

    A chunk of a longer recursion passes, as ``ctc_alpha`` does, its
    frames, the global ``input_lens`` and ``t_off``, the recursion's
    ``loglik`` and ``c_in [B,S]`` f32, ``beta + log_prob`` at the next
    chunk's first frame (None for the last chunk): a row whose end lies
    past the chunk takes its last frame as a step from ``c_in``, one that
    ends inside restarts at the terminal states, one that ended before
    has zero gamma. With ``return_carry`` it returns ``(gamma, c_out)``,
    ``c_out [B,S]`` the same quantity at this chunk's first frame for the
    chunk before (NEG for a row that ended before the chunk). Without
    them it is the unchunked recursion; the chunks give its bits.

    A CPU tensor runs ``ctc_beta_plain``; a CUDA tensor launches
    ``csrc/ctc.cu`` (counted in ``ctc_beta.launches``) or raises.
    """
    _check(log_probs, ext, skip, input_lens, s_last, alphas, loglik,
           c_in=c_in)
    _check_offset(t_off)
    if log_probs.device.type == "cpu":
        return ctc_beta_plain(log_probs, ext, skip, input_lens, s_last,
                              alphas, loglik, c_in, t_off, return_carry)
    b, t, v = log_probs.shape
    s = ext.shape[1]
    if b == 0 or t == 0:
        raise ValueError("ctc_beta needs B >= 1 and T >= 1")
    gamma = torch.empty((b, t, s), dtype=torch.float32,
                        device=log_probs.device)
    c_out = (torch.empty((b, s), dtype=torch.float32,
                         device=log_probs.device) if return_carry else None)
    gru.require_current(log_probs, "ctc_beta")
    lib = _lib()
    rc = lib.ctc_beta_launch(
        log_probs.data_ptr(), ext.data_ptr(), skip.data_ptr(),
        input_lens.data_ptr(), s_last.data_ptr(), alphas.data_ptr(),
        loglik.data_ptr(), None if c_in is None else c_in.data_ptr(),
        None if c_out is None else c_out.data_ptr(), gamma.data_ptr(), b, t,
        v, s, t_off, log_probs.device.index,
        torch.cuda.current_stream(log_probs.device).cuda_stream)
    _raise_on(lib, rc, f"ctc_beta (B={b}, T={t}, V={v}, S={s})")
    ctc_beta.launches += 1
    return (gamma, c_out) if return_carry else gamma


ctc_beta.launches = 0


# ---------------------------------------------------------------------------
# The loss the train step calls.
# ---------------------------------------------------------------------------

def _operands(labels: torch.Tensor, input_lens: torch.Tensor,
              label_lens: torch.Tensor, t: int, v: int):
    """The kernels' operands but the log-probs, ``(ext, skip, input_lens,
    s_last)``, for ``t`` frames of a ``v``-symbol vocabulary. Raises on
    labels outside ``[0, V)``, label lengths outside ``[0, L]`` or frame
    counts outside ``[0, T]`` (one host sync): the kernels would read
    out of bounds."""
    lab_lens = label_lens.long()
    bad = torch.stack([((labels < 0) | (labels >= v)).any(),
                       ((lab_lens < 0) | (lab_lens > labels.shape[1])).any(),
                       ((input_lens < 0) | (input_lens > t)).any()])
    if bool(bad.any()):
        raise ValueError(f"ctc_loss: labels must lie in [0, {v}), "
                         f"label_lens in [0, {labels.shape[1]}] and "
                         f"input_lens in [0, {t}]")
    ext, skip, _ = transition_masks(labels.long(), lab_lens)
    return (ext.int().contiguous(), skip.contiguous(),
            input_lens.int().contiguous(), (2 * lab_lens).int().contiguous())


def prepare(logits: torch.Tensor, labels: torch.Tensor,
            input_lens: torch.Tensor, label_lens: torch.Tensor):
    """Log-softmax and the kernels' operands:
    ``(log_probs, ext, skip, input_lens, s_last)``; raises as
    ``_operands`` does."""
    b, t, v = logits.shape
    ops = _operands(labels, input_lens, label_lens, t, v)
    log_probs = torch.log_softmax(logits.float(), dim=-1).contiguous()
    return (log_probs, *ops)


def _dlogits(log_probs, gamma_ext, ext, lens, t_off: int, dtype):
    """``softmax - gamma`` over a chunk's frames (global frames
    ``t_off``..), zero softmax past each row's length."""
    t = log_probs.shape[1]
    gamma = scatter_ext_to_vocab(gamma_ext, ext, log_probs.shape[2])
    tmask = ((t_off + torch.arange(t, device=log_probs.device))[None]
             < lens[:, None])
    return (torch.exp(log_probs) * tmask[:, :, None] - gamma).to(dtype)


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
        ctx.save_for_backward(_dlogits(log_probs, gamma_ext, ext, lens, 0,
                                       logits.dtype))
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


class _SPCTCLoss(torch.autograd.Function):
    """``sp_ctc_loss``: ``apply(labels, input_lens, label_lens, *logits)``
    with one ``[B, Tl, V]`` logits chunk a shard, in time order."""

    @staticmethod
    def forward(ctx, labels, input_lens, label_lens, *logits):
        tl, v = logits[0].shape[1], logits[0].shape[2]
        ops = _operands(labels, input_lens, label_lens, tl * len(logits), v)
        devs = [x.device for x in logits]
        shard_ops = [tuple(o.to(d) for o in ops) for d in devs]
        lps, tapes, band = [], [], None
        for k, (x, d) in enumerate(zip(logits, devs)):
            with gru.current_device(d):
                lps.append(torch.log_softmax(x.float(), dim=-1).contiguous())
                loglik, tape = ctc_alpha(
                    lps[k], *shard_ops[k], tape=True,
                    alpha0=None if band is None else band.to(d),
                    t_off=k * tl)
                band = tape[:, -1].contiguous()
                tapes.append(tape)
        dlogits, c = [None] * len(logits), None
        for k in range(len(logits) - 1, -1, -1):
            d = devs[k]
            with gru.current_device(d):
                out = ctc_beta(lps[k], *shard_ops[k], tapes[k],
                               loglik.to(d),
                               c_in=None if c is None else c.to(d),
                               t_off=k * tl, return_carry=k > 0)
                gamma_ext, c = out if k > 0 else (out, None)
                tapes[k] = None
                dlogits[k] = _dlogits(lps[k], gamma_ext, shard_ops[k][0],
                                      shard_ops[k][2], k * tl,
                                      logits[k].dtype)
        ctx.save_for_backward(*dlogits)
        return -loglik.to(labels.device)

    @staticmethod
    def backward(ctx, g):
        return (None, None, None, *(
            dl * g.to(dl.device, dl.dtype)[:, None, None]
            for dl in ctx.saved_tensors))


def sp_ctc_loss(logits, labels: torch.Tensor, input_lens: torch.Tensor,
                label_lens: torch.Tensor) -> torch.Tensor:
    """Per-utterance CTC loss ``[B]`` over logits cut along time: the
    contract of ``ctc_loss`` with ``logits`` a list of ``[B, Tl, V]``
    chunks in time order, each on its shard's device (the
    sequence-parallel loss, JAX ``seqpar.py`` ``_ctc_alpha_relay``);
    ``input_lens`` are the global frame counts. The labels are checked
    once. Shard by shard, 0 -> S-1, the alpha kernel runs its chunk from
    the band the shard before handed over (its tape's last row); the
    last shard's band gives the log-likelihood; then S-1 -> 0 the beta
    kernel runs its chunk from the ``c`` the shard after handed over and
    hands its own on; each shard forms its ``dlogits`` on its device, as
    ``ctc_loss`` does. Only ``[B, S]`` bands and ``[B]`` scalars cross
    shards. The loss and every ``dlogits`` are ``ctc_loss``'s on the
    concatenated logits, bit for bit where the log-softmax is (it is
    taken a frame at a time). The loss lies on ``labels``' device."""
    return _SPCTCLoss.apply(labels, input_lens, label_lens, *logits)
